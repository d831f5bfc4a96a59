"""Clustering + nearest neighbors (the port of
``deeplearning4j_tpu/clustering``; replaces
deeplearning4j-nearestneighbors-parent, SURVEY.md §2.4).

The reference's pointer-chasing spatial trees (VPTree, KDTree, SPTree) are
replaced by brute-force tiled distance matmuls — the
‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b expansion turns neighbor search into one
matmul + top-k per tile on the card (the reference itself falls back to
brute force on GPU for the same reason).
"""

from .kmeans import KMeansClustering
from .knn import NearestNeighbors, pairwise_distances
from .knn_server import NearestNeighborsClient, NearestNeighborsServer

__all__ = ["KMeansClustering", "NearestNeighbors", "pairwise_distances",
           "NearestNeighborsClient", "NearestNeighborsServer"]
