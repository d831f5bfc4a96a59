"""Brute-force nearest neighbors on the card (the port of
``deeplearning4j_tpu/clustering/knn.py``).

Parity target: reference nearestneighbor-core VPTree.java (vantage-point
tree search) + NearestNeighbor.java server ops.  The tree is replaced by
tiled distance matmuls + top-k — O(N·Q·D) FLOPs, with query tiling
(``query_block``) and, here, column tiling to bound device memory.

Order among equal distances is the reference's: ``jax.lax.top_k`` returns
the lower index first among ties, and ``torch.topk`` promises no order.
So each distance becomes an int64 key — its float32 bits mapped to a
signed integer that orders like the float, shifted left 32 bits, with the
column index in the low bits — and ``topk`` runs on the keys, which are
all distinct: the k smallest keys are the k nearest points, ties broken
by the lower index, in the reference's order.  The key is decoded back to
the exact distance.  A column tile's k best merge with the running k best
the same way, so the answer does not depend on the tiling.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

COLUMN_BLOCK = 1 << 17   # points per distance tile: [query_block, 131072] f32
_LOW31 = 0x7FFFFFFF
_LOW32 = 0xFFFFFFFF


def _dist_block(queries: Tensor, points: Tensor, metric: str = "euclidean") -> Tensor:
    """[Q,D] × [N,D] → [Q,N] distances via the matmul expansion."""
    if metric == "cosine":
        qn = queries / torch.clamp(torch.linalg.norm(queries, dim=1, keepdim=True), min=1e-12)
        pn = points / torch.clamp(torch.linalg.norm(points, dim=1, keepdim=True), min=1e-12)
        return 1.0 - qn @ pn.T
    if metric == "manhattan":
        return torch.sum(torch.abs(queries[:, None, :] - points[None, :, :]), dim=-1)
    # euclidean²: ‖q‖² + ‖p‖² − 2q·p  (one matmul)
    q2 = torch.sum(queries * queries, dim=1, keepdim=True)   # [Q,1]
    p2 = torch.sum(points * points, dim=1)                   # [N]
    d2 = q2 + p2[None, :] - 2.0 * (queries @ points.T)
    return torch.clamp(d2, min=0.0)


def order_keys(d: Tensor, col0: int = 0) -> Tensor:
    """int64 keys of a [R, C] float32 distance tile whose order is (distance,
    column ``col0 + j``) lexicographic (module docstring)."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)      # + 0.0: -0.0 → 0.0
    bits = torch.where(bits < 0, bits ^ _LOW31, bits)
    cols = torch.arange(col0, col0 + d.shape[1], dtype=torch.int64, device=d.device)
    return (bits << 32) | cols


def decode_keys(keys: Tensor) -> Tuple[Tensor, Tensor]:
    """(distances float32, columns int64) of ``order_keys`` keys."""
    bits = keys >> 32
    bits = torch.where(bits < 0, bits ^ _LOW31, bits)
    return bits.to(torch.int32).view(torch.float32), keys & _LOW32


def smallest_keys(keys: Tensor, k: int, best: Optional[Tensor] = None) -> Tensor:
    """The ``k`` smallest of ``keys`` (and of the running ``best``) per row,
    ascending."""
    if best is not None:
        keys = torch.cat([best, keys], dim=1)
    return torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                      sorted=True).values


def _topk_block(queries: Tensor, points: Tensor, k: int,
                metric: str) -> Tuple[Tensor, Tensor]:
    """(distances [Q,k], indices [Q,k]) of the k nearest points, nearest
    first, lower index first among ties, over tiles of ``COLUMN_BLOCK``
    points."""
    col_block = COLUMN_BLOCK
    if metric == "manhattan":   # its block is [Q, C, D]: keep it near 1 GiB
        col_block = max(1, min(col_block, (1 << 28) // max(1, queries.shape[0] * queries.shape[1])))
    best = None
    for c0 in range(0, points.shape[0], col_block):
        d = _dist_block(queries, points[c0:c0 + col_block], metric)
        best = smallest_keys(order_keys(d, c0), k, best)
    return decode_keys(best)


def pairwise_distances(a, b=None, metric: str = "euclidean",
                       device: DeviceLike = None) -> np.ndarray:
    """All-pairs distance matrix (euclidean returns TRUE distances), computed
    on ``device`` (default the card)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = a if b is None else torch.as_tensor(np.asarray(b, np.float32), device=dev)
    d = _dist_block(a, b, metric)
    if metric == "euclidean":
        d = torch.sqrt(d)
    return d.cpu().numpy()


class NearestNeighbors:
    """KNN index (reference VPTree surface: knn(point, k) → ids+distances);
    the points live on ``device`` (default the card).

    ``query_block`` tiles large query sets so the [Q,N] distance block
    stays within device memory.
    """

    def __init__(self, points, metric: str = "euclidean",
                 query_block: int = 4096, device: DeviceLike = None):
        self.device = resolve_device(device)
        pts = points if isinstance(points, torch.Tensor) else np.asarray(points, np.float32)
        self.points = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        if self.points.ndim != 2:
            raise ValueError(f"points must be [N,D], got {tuple(self.points.shape)}")
        self.metric = metric
        self.query_block = query_block

    def knn_device(self, queries: Tensor, k: int) -> Tuple[Tensor, Tensor]:
        """``knn`` of a [Q,D] tensor on the index's device, answered there:
        (squared euclidean or metric distances [Q,k], int64 indices [Q,k])."""
        k = min(k, self.points.shape[0])
        outs_d, outs_i = [], []
        for s in range(0, queries.shape[0], self.query_block):
            d, i = _topk_block(queries[s:s + self.query_block], self.points, k,
                               self.metric)
            outs_d.append(d)
            outs_i.append(i)
        return torch.cat(outs_d), torch.cat(outs_i)

    def knn(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (distances [Q,k], indices [Q,k]), nearest first.  Euclidean
        distances are true (sqrt'd) distances."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        d, i = self.knn_device(q, k)
        d = d.cpu().numpy()
        i = i.cpu().numpy().astype(np.int32)
        if self.metric == "euclidean":
            d = np.sqrt(d)
        return (d[0], i[0]) if squeeze else (d, i)
