"""Dimensionality reduction for visualization (the port of
``deeplearning4j_tpu/plot``; replaces deeplearning4j-core plot/:
BarnesHutTsne + Tsne)."""

from .tsne import Tsne

__all__ = ["Tsne"]
