"""NLP / embeddings (the port of ``deeplearning4j_tpu/nlp``; replaces
deeplearning4j-nlp-parent).

The reference trains Word2Vec with Hogwild threads mutating shared syn0/syn1
tables through JNI AggregateSkipGram ops (SequenceVectors.java:292-296,
SkipGram.java:271-283).  Here host-side window sampling feeds batched
negative-sampling updates on the card (negatives drawn there with the
reference's threefry), row gathers, batched products and ordered row
scatter-adds; tokenization, the vocabulary and the word2vec C formats are
the reference's host code.
"""

from .tokenization import (
    AggregatingSentenceIterator,
    BaseFormTokenizerFactory,
    CJKTokenizerFactory,
    CollectionSentenceIterator,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    LineSentenceIterator,
    PosFilterTokenizerFactory,
    get_tokenizer_factory,
    register_tokenizer_factory,
)
from .vocab import VocabCache, VocabWord, build_vocab, Huffman
from .word2vec import Word2Vec
from .sequencevectors import SequenceVectors, ParagraphVectors, WordVectorsBase
from .glove import Glove, CoOccurrences
from .distributed import DistributedWord2Vec
from .serializer import load_static_model, read_word_vectors, write_word_vectors

__all__ = ["AggregatingSentenceIterator", "BaseFormTokenizerFactory", "CJKTokenizerFactory",
           "CoOccurrences", "CollectionSentenceIterator", "CommonPreprocessor",
           "DefaultTokenizerFactory", "DistributedWord2Vec", "Glove", "Huffman",
           "LineSentenceIterator", "ParagraphVectors", "PosFilterTokenizerFactory",
           "SequenceVectors", "VocabCache", "VocabWord", "Word2Vec", "WordVectorsBase",
           "build_vocab", "get_tokenizer_factory", "load_static_model", "read_word_vectors",
           "register_tokenizer_factory", "write_word_vectors"]
