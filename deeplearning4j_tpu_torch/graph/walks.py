"""Random-walk generators (reference deeplearning4j-graph
iterator/RandomWalkIterator.java + WeightedWalkIterator.java).

Walks are plain integer sequences consumed by SequenceVectors — the same
corpus interface word2vec uses, per the reference's
GraphWalkIteratorProvider → SequenceVectors bridge.

A copy of ``deeplearning4j_tpu/graph/walks.py``: the walks are numpy on
the host, so a seed gives the reference's walks.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .graph import Graph


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (reference RandomWalkIterator: NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)."""

    def __init__(self, graph: Graph, walk_length: int,
                 walks_per_vertex: int = 1, seed: int = 12345):
        self.graph = graph
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.seed = seed

    def _choose_next(self, rng, cur: int, nbrs: List[int]) -> int:
        """Next-hop policy hook — uniform here, weighted in the subclass."""
        return int(nbrs[rng.integers(0, len(nbrs))])

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        order = np.arange(self.graph.n)
        for _ in range(self.walks_per_vertex):
            rng.shuffle(order)
            for start in order:
                walk = [int(start)]
                cur = int(start)
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.neighbors(cur)
                    if not nbrs:  # disconnected → self loop
                        walk.append(cur)
                        continue
                    cur = self._choose_next(rng, cur, nbrs)
                    walk.append(cur)
                yield walk


class WeightedWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (reference WeightedWalkIterator)."""

    def _choose_next(self, rng, cur: int, nbrs: List[int]) -> int:
        w = np.asarray(self.graph.edge_weights(cur), np.float64)
        return int(nbrs[rng.choice(len(nbrs), p=w / w.sum())])
