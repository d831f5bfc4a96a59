"""DeepWalk — node embeddings from random walks (Perozzi et al. 2014).

Parity target: reference graph/models/deepwalk/DeepWalk.java (Builder:
vectorSize, windowSize, learningRate; fit(GraphWalkIterator) trains
skip-gram with hierarchical softmax over a degree-based Huffman tree).

The port of ``deeplearning4j_tpu/graph/deepwalk.py``: walks become
integer "sentences" for the port's shared SequenceVectors engine
(nlp/sequencevectors.py, tables on the card) — one corpus interface for
words, documents, and graph vertices, exactly the layering the reference
uses (DeepWalk extends the SequenceVectors stack).  Both hierarchical
softmax (the reference's choice) and negative sampling are available.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..nlp.sequencevectors import SequenceVectors
from ..utils.device import DeviceLike, resolve_device
from .graph import Graph
from .walks import RandomWalkIterator


class DeepWalk:
    """Builder-parity surface: vector_size, window_size, walk_length,
    walks_per_vertex, learning_rate (reference DeepWalk.Builder); trains on
    ``device`` (default the card)."""

    def __init__(self,
                 vector_size: int = 100,
                 window_size: int = 5,
                 walk_length: int = 40,
                 walks_per_vertex: int = 10,
                 learning_rate: float = 0.025,
                 epochs: int = 1,
                 hierarchic_softmax: bool = True,
                 negative: int = 5,
                 batch_size: int = 2048,
                 seed: int = 12345,
                 device: DeviceLike = None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.hs = hierarchic_softmax
        self.negative = negative
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sv: Optional[SequenceVectors] = None
        self._graph: Optional[Graph] = None

    def fit(self, graph: Graph, walks=None) -> "DeepWalk":
        """Generate walks (or take a provided iterator) and train."""
        self._graph = graph
        if walks is None:
            walks = RandomWalkIterator(graph, self.walk_length,
                                       self.walks_per_vertex, self.seed)
        corpus: List[List[int]] = [list(w) for w in walks]
        self._sv = SequenceVectors(
            layer_size=self.vector_size,
            window=self.window_size,
            min_word_frequency=1,
            negative=self.negative,
            hierarchic_softmax=self.hs,
            learning_rate=self.learning_rate,
            epochs=self.epochs,
            batch_size=self.batch_size,
            seed=self.seed,
            device=self.device)
        self._sv.fit_sequences(corpus)
        return self

    # ------------------------------------------------------------------
    # lookup (reference GraphVectors interface)
    # ------------------------------------------------------------------

    def vertex_vector(self, v: int) -> np.ndarray:
        return self._sv.word_vector(v)

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(a, b)

    def verticies_nearest(self, v: int, top_n: int = 10) -> List[int]:
        # (sic) reference spells it verticesNearest; keep a sane alias too
        return self._sv.words_nearest(v, top_n)

    vertices_nearest = verticies_nearest

    @property
    def vectors(self) -> np.ndarray:
        """[n_vertices, vector_size] table indexed by vocab order — use
        ``vertex_vector`` for id-addressed lookup."""
        return self._sv.syn0
