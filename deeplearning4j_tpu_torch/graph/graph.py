"""In-memory graph (reference deeplearning4j-graph
api/graph/Graph.java + impl/Graph.java: vertices with adjacency lists,
directed or undirected, optional edge weights).

A copy of ``deeplearning4j_tpu/graph/graph.py``.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np


class Graph:
    """Adjacency-list graph over integer vertex ids [0, n).

    ``add_edge(a, b, weight)``; undirected graphs mirror automatically
    (reference Graph.addEdge with undirected=true).
    """

    def __init__(self, num_vertices: int, undirected: bool = True):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self.n = num_vertices
        self.undirected = undirected
        self._adj: List[List[int]] = [[] for _ in range(num_vertices)]
        self._w: List[List[float]] = [[] for _ in range(num_vertices)]

    def add_edge(self, a: int, b: int, weight: float = 1.0) -> None:
        if not (0 <= a < self.n and 0 <= b < self.n):
            raise ValueError(f"edge ({a},{b}) out of range [0,{self.n})")
        self._adj[a].append(b)
        self._w[a].append(weight)
        if self.undirected:
            self._adj[b].append(a)
            self._w[b].append(weight)

    def add_edges(self, edges: Iterable[Tuple[int, int]]) -> None:
        for e in edges:
            self.add_edge(e[0], e[1], e[2] if len(e) > 2 else 1.0)

    def num_vertices(self) -> int:
        return self.n

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def neighbors(self, v: int) -> List[int]:
        return self._adj[v]

    def edge_weights(self, v: int) -> List[float]:
        return self._w[v]
