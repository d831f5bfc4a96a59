"""Vocabulary + Huffman coding.

Parity targets: reference models/word2vec/wordstore/VocabConstructor.java:31
(buildJointVocabulary:167 — parallel counting, min-frequency filtering),
inmemory/AbstractCache (word↔index, counts), and Huffman.java:34 (code/point
assignment for hierarchical softmax).

A copy of ``deeplearning4j_tpu/nlp/vocab.py`` (numpy and Python on the
host).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class VocabWord:
    word: str
    count: int
    index: int
    # hierarchical-softmax fields (reference VocabWord codes/points)
    codes: Optional[List[int]] = None
    points: Optional[List[int]] = None


class VocabCache:
    """In-memory vocab (reference AbstractCache): index ↔ word ↔ count."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}

    def add(self, word: str, count: int) -> VocabWord:
        vw = VocabWord(word, count, len(self.words))
        self.words.append(vw)
        self._by_word[word] = vw
        return vw

    def __contains__(self, word: str) -> bool:
        return word in self._by_word

    def get(self, word: str):
        """VocabWord for ``word`` or None — the single-probe lookup hot
        paths use (one hash instead of `in` + `index_of`)."""
        return self._by_word.get(word)

    def __len__(self) -> int:
        return len(self.words)

    def word_for(self, index: int) -> str:
        return self.words[index].word

    def index_of(self, word: str) -> int:
        return self._by_word[word].index

    def count_of(self, word: str) -> int:
        return self._by_word[word].count

    def total_count(self) -> int:
        return sum(w.count for w in self.words)

    def unigram_table(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution ∝ count^0.75 (word2vec standard;
        reference builds the equivalent table natively)."""
        counts = np.asarray([w.count for w in self.words], np.float64) ** power
        return (counts / counts.sum()).astype(np.float64)


def build_vocab(token_stream: Iterable[List[str]], min_word_frequency: int = 5,
                max_vocab_size: Optional[int] = None) -> VocabCache:
    """Count words over tokenized sentences → frequency-sorted VocabCache
    (reference VocabConstructor.buildJointVocabulary)."""
    counter: Counter = Counter()
    for tokens in token_stream:
        counter.update(tokens)
    vocab = VocabCache()
    items = [(w, c) for w, c in counter.items() if c >= min_word_frequency]
    items.sort(key=lambda t: (-t[1], t[0]))
    if max_vocab_size:
        items = items[:max_vocab_size]
    for w, c in items:
        vocab.add(w, c)
    return vocab


class Huffman:
    """Huffman tree over word frequencies; assigns binary codes + inner-node
    points per word (reference Huffman.java:34 — used by hierarchical
    softmax).  Max code length 40 as in the reference."""

    MAX_CODE_LENGTH = 40

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab
        self._build()

    def _build(self) -> None:
        n = len(self.vocab)
        if n == 0:
            return
        # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
        heap: List[Tuple[int, int, int]] = [
            (w.count, i, i) for i, w in enumerate(self.vocab.words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a], parent[b] = next_id, next_id
            binary[a], binary[b] = 0, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2] if heap else None
        for i, w in enumerate(self.vocab.words):
            codes, points = [], []
            node = i
            while node != root and node in parent:
                codes.append(binary[node])
                node = parent[node]
                points.append(node - n)  # inner-node index
            codes.reverse()
            points.reverse()
            w.codes = codes[: self.MAX_CODE_LENGTH]
            w.points = points[: self.MAX_CODE_LENGTH]

    def max_code_length(self) -> int:
        return max((len(w.codes or []) for w in self.vocab.words), default=0)
