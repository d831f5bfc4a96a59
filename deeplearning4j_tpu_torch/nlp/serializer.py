"""Embedding serialization — word2vec C formats.

Parity target: reference models/embeddings/loader/WordVectorSerializer.java
(2,824 LoC): read/write the original word2vec C text and binary formats so
vectors interoperate with gensim/word2vec tooling, plus the framework's own
loader that reconstructs a queryable table.

A copy of ``deeplearning4j_tpu/nlp/serializer.py``: the formats are
written and read on the host, so the bytes are the reference writer's.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def write_word_vectors(model_or_pairs, path: str, binary: bool = False) -> None:
    """Write 'V D\\n' header + one word per line (text) or packed floats
    (binary), the word2vec C convention (WordVectorSerializer.writeWordVectors)."""
    if hasattr(model_or_pairs, "vocab"):
        vocab = model_or_pairs.vocab
        vectors = model_or_pairs.syn0
        items = [(vocab.word_for(i), vectors[i]) for i in range(len(vocab))]
    else:
        items = list(model_or_pairs.items())
    if not items:
        raise ValueError("no vectors to write")
    d = len(items[0][1])
    if binary:
        with open(path, "wb") as f:
            f.write(f"{len(items)} {d}\n".encode())
            for word, vec in items:
                f.write(word.encode("utf-8") + b" ")
                f.write(np.asarray(vec, np.float32).tobytes())
                f.write(b"\n")
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(items)} {d}\n")
            for word, vec in items:
                f.write(word + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")


def read_word_vectors(path: str, binary: bool = False) -> Dict[str, np.ndarray]:
    """Inverse of write_word_vectors (WordVectorSerializer.loadTxtVectors /
    readBinaryModel)."""
    out: Dict[str, np.ndarray] = {}
    if binary:
        with open(path, "rb") as f:
            header = f.readline().split()
            n, d = int(header[0]), int(header[1])
            for _ in range(n):
                word = bytearray()
                while True:
                    ch = f.read(1)
                    if ch == b" ":
                        break
                    if ch == b"":
                        raise ValueError("truncated binary vectors file")
                    word.extend(ch)
                vec = np.frombuffer(f.read(4 * d), dtype=np.float32)
                out[word.decode("utf-8")] = np.array(vec)
                nl = f.read(1)
                if nl not in (b"\n", b""):
                    f.seek(-1, 1)
        return out
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < d + 1:
                continue
            out[parts[0]] = np.asarray([float(x) for x in parts[1:d + 1]], np.float32)
    return out


def load_static_model(path: str, binary: bool = False):
    """Saved vectors → a queryable read-only WordVectors table with the
    full lookup API (similarity / words_nearest / words_nearest_vector) —
    the reference's WordVectorSerializer.loadStaticModel: embeddings
    usable for inference without the trainer."""
    from .sequencevectors import WordVectorsBase
    from .vocab import VocabCache

    pairs = read_word_vectors(path, binary=binary)
    if not pairs:
        raise ValueError(f"{path}: no vectors found")

    model = WordVectorsBase()
    vocab = VocabCache()
    rows = []
    for word, vec in pairs.items():
        vocab.add(word, 1)
        rows.append(np.asarray(vec, np.float32))
    model.vocab = vocab
    model.syn0 = np.stack(rows)
    model._norms = None
    return model
