"""Word2Vec — skip-gram / CBOW with negative sampling or hierarchical
softmax (the port of ``deeplearning4j_tpu/nlp/word2vec.py``).

Parity target: reference models/word2vec/Word2Vec.java (builder surface:
layerSize, windowSize, minWordFrequency, negativeSample, learningRate,
minLearningRate, subsampling, epochs) with SkipGram.java:224 iterateSample /
CBOW.java math.  The reference's Hogwild threads + JNI batched aggregates
become host-side window + negative sampling feeding batched scatter-add
updates on the card — update cost ∝ batch, not vocab.

Layering matches the reference: ``Word2Vec extends SequenceVectors`` — the
training engine and the update steps live in nlp/sequencevectors.py; this
class adds tokenization and word2vec's defaults (min frequency 5,
subsampling 1e-3).
"""

from __future__ import annotations

from typing import Iterable, List

from ..utils.device import DeviceLike
from .sequencevectors import SequenceVectors

# re-exported as the reference's module does
from .sequencevectors import (  # noqa: F401
    _cbow_chunk,
    _cbow_neg_step,
    _occurrence_scale,
    _sg_chunk,
    _sg_hs_step,
    _sg_neg_step,
)


class Word2Vec(SequenceVectors):
    """Builder-style Word2Vec (reference Word2Vec.Builder surface)."""

    def __init__(self,
                 layer_size: int = 100,
                 window: int = 5,
                 min_word_frequency: int = 5,
                 negative: int = 5,
                 hierarchic_softmax: bool = False,
                 cbow: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 subsampling: float = 1e-3,
                 epochs: int = 1,
                 batch_size: int = 2048,
                 seed: int = 12345,
                 tokenizer_factory=None,
                 device: DeviceLike = None):
        from .tokenization import DefaultTokenizerFactory, get_tokenizer_factory

        super().__init__(
            layer_size=layer_size,
            window=window,
            min_word_frequency=min_word_frequency,
            negative=negative,
            hierarchic_softmax=hierarchic_softmax,
            cbow=cbow,
            learning_rate=learning_rate,
            min_learning_rate=min_learning_rate,
            subsampling=subsampling,
            epochs=epochs,
            batch_size=batch_size,
            seed=seed,
            device=device)
        if isinstance(tokenizer_factory, str):
            # registry names: 'default', 'cjk', 'chinese', 'japanese', ...
            tokenizer_factory = get_tokenizer_factory(tokenizer_factory)
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()

    def _tokenize_corpus(self, sentences: Iterable[str]) -> List[List[str]]:
        return [self.tokenizer.tokenize(s) for s in sentences]

    def fit(self, sentences: Iterable[str]) -> "Word2Vec":
        return self.fit_sequences(self._tokenize_corpus(sentences))
