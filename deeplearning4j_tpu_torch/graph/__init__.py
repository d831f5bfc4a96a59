"""Graph embeddings (the port of ``deeplearning4j_tpu/graph``; replaces
deeplearning4j-graph, SURVEY.md §2.4)."""

from .graph import Graph
from .walks import RandomWalkIterator, WeightedWalkIterator
from .deepwalk import DeepWalk

__all__ = ["Graph", "RandomWalkIterator", "WeightedWalkIterator", "DeepWalk"]
