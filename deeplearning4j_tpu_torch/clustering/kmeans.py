"""K-Means (Lloyd) as distance matmuls + a one-hot product on the card
(the port of ``deeplearning4j_tpu/clustering/kmeans.py``).

Parity target: reference clustering/kmeans/KMeansClustering.java +
algorithm/BaseClusteringAlgorithm.java (iterationCount /
distanceConvergence strategies, varianceDistance option).

Each Lloyd iteration assigns via the ‖x−c‖² matmul expansion (sharing
knn._dist_block) and recomputes centroids with the one-hot product
(onehotᵀ @ x, a dense [N,K]ᵀ[N,D] product); an empty cluster keeps its
centroid.  ``torch.argmin`` returns the first minimum, as ``jnp.argmin``.
The k-means++ seeding is the reference's numpy code on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .knn import _dist_block

Tensor = torch.Tensor


def _assign(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor]:
    """Distance block + argmin: (assignments [N], d2 [N,K])."""
    d2 = _dist_block(x, centroids, "euclidean")          # [N,K], clamped ≥ 0
    return torch.argmin(d2, dim=1), d2


def _assign_inertia(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor]:
    assign, d2 = _assign(x, centroids)
    return assign, torch.sum(torch.min(d2, dim=1).values)


def _lloyd_step(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One Lloyd iteration: assign + recompute.  x [N,D], centroids [K,D].
    Returns (new_centroids, assignments, inertia) — assignments/inertia are
    relative to the INPUT centroids (the caller re-assigns at the end)."""
    assign, d2 = _assign(x, centroids)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    onehot = torch.nn.functional.one_hot(assign, centroids.shape[0]).to(x.dtype)  # [N,K]
    sums = onehot.T @ x                                   # [K,D]
    counts = torch.sum(onehot, dim=0)                     # [K]
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1.0),
                        centroids)                        # empty cluster keeps old
    return new_c, assign, inertia


class KMeansClustering:
    """setup(k, max_iterations | convergence) + apply_to(points)
    (reference KMeansClustering.setup variants); Lloyd runs on ``device``
    (default the card)."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 init: str = "kmeans++", seed: int = 12345,
                 device: DeviceLike = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.init = init
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: int = 0

    @staticmethod
    def setup(k: int, max_iterations: int = 100, **kw) -> "KMeansClustering":
        return KMeansClustering(k, max_iterations, **kw)

    def _init_centroids(self, x: np.ndarray, rng) -> np.ndarray:
        if self.init == "random":
            idx = rng.choice(x.shape[0], self.k, replace=False)
            return x[idx].copy()
        # k-means++ (Arthur & Vassilvitskii 2007)
        centroids = [x[rng.integers(0, x.shape[0])]]
        d2 = np.full(x.shape[0], np.inf)
        diff = np.empty_like(x)      # the reference's (x - last) ** 2, in place
        for _ in range(1, self.k):
            np.square(np.subtract(x, centroids[-1], out=diff), out=diff)
            d2 = np.minimum(d2, diff.sum(axis=1))
            p = d2 / d2.sum() if d2.sum() > 0 else None
            centroids.append(x[rng.choice(x.shape[0], p=p)])
        return np.stack(centroids)

    def apply_to(self, points) -> np.ndarray:
        """Cluster; returns assignments [N]."""
        x = np.asarray(points, np.float32)
        if x.ndim != 2 or x.shape[0] < self.k:
            raise ValueError(f"need [N>=k,D] points, got {x.shape} with k={self.k}")
        rng = np.random.default_rng(self.seed)
        c = torch.from_numpy(self._init_centroids(x, rng)).to(self.device)
        xd = torch.from_numpy(x).to(self.device)
        prev_inertia = np.inf
        for it in range(self.max_iterations):
            c, _, inertia = _lloyd_step(xd, c)
            inertia = float(inertia)
            self.n_iter_ = it + 1
            if np.isfinite(prev_inertia) and \
                    prev_inertia - inertia <= self.tol * max(abs(prev_inertia), 1.0):
                break
            prev_inertia = inertia
        # final assignment/inertia against the FINAL centroids, so
        # fit_predict(x) == predict(x) and inertia_ matches self.centroids
        assign, inertia = _assign_inertia(xd, c)
        self.centroids = c.cpu().numpy()
        self.inertia_ = float(inertia)
        return assign.cpu().numpy().astype(np.int32)

    fit_predict = apply_to

    def predict(self, points) -> np.ndarray:
        if self.centroids is None:
            raise ValueError("apply_to before predict")
        x = torch.from_numpy(np.asarray(points, np.float32)).to(self.device)
        c = torch.from_numpy(self.centroids).to(self.device)
        return _assign_inertia(x, c)[0].cpu().numpy().astype(np.int32)
