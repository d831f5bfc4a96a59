"""t-SNE (van der Maaten & Hinton 2008) — exact, device-resident (the port
of ``deeplearning4j_tpu/plot/tsne.py``).

Parity target: reference plot/BarnesHutTsne.java (868 LoC: perplexity
binary search, early exaggeration, momentum schedule, gain adaptation)
+ plot/Tsne.java (the exact O(N²) variant).

Barnes-Hut's quadtree exists to approximate the O(N²) repulsive term on
CPUs.  On the card the full [N,N] affinity matrix IS the fast path for
small N, so the exact algorithm is used, matching the reference's *exact*
Tsne.java math with BarnesHutTsne.java's training schedule.

Large N (the BarnesHutTsne capability): the [N,N] buffer is never
materialized.  Input affinities go sparse over k-nearest neighbors (the
reference's VPTree KNN role, k = 3·perplexity, brute force in [R,B] tiles)
with a vectorized perplexity bisection on the device, and every gradient
iteration streams the EXACT all-pairs repulsive term in [N,B] column
blocks with an accumulated normalizer Z (no approximation, unlike
Barnes-Hut's theta).  Each of the reference's ``lax.scan`` loops over
column blocks (the kNN's, the repulsion's, the bisection's iterations,
the symmetrization's row blocks) is a Python loop over tiles here, each
tile's temporaries freed before the next, so peak memory stays
O(N·(B + k)): the repulsion tile is one [N,B] buffer, updated in place
(``addmm_``, ``reciprocal_``, ``square_``), and the kNN's rows go in
chunks of ``KNN_ROW_CHUNK`` (the reference's 65,536 rows of [R, k+B]
sort keys would be 4.3 GB of int64 at B = 8,192).  The kNN breaks ties
by the lower index, as ``jax.lax.top_k`` does (``clustering.knn``'s
ordered keys).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..clustering.knn import decode_keys, order_keys, smallest_keys
from ..ops.scatter import add_rows
from ..utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

KNN_ROW_CHUNK = 8192


def _hbeta(d2_row: np.ndarray, beta: float):
    """Perplexity helper: P given precision beta (Tsne.java hBeta)."""
    p = np.exp(-d2_row * beta)
    s = p.sum()
    if s <= 0:
        return np.inf, np.zeros_like(p)
    h = np.log(s) + beta * (d2_row * p).sum() / s
    return h, p / s


def _binary_search_p(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
                     max_tries: int = 50) -> np.ndarray:
    """Row-wise precision search to hit the target perplexity
    (BarnesHutTsne.java computeGaussianPerplexity)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n), np.float64)
    for i in range(n):
        row = np.delete(d2[i], i)
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        h, p = _hbeta(row, beta)
        for _ in range(max_tries):
            if abs(h - target) < tol:
                break
            if h > target:
                beta_min = beta
                beta = beta * 2.0 if beta_max == np.inf else (beta + beta_max) / 2.0
            else:
                beta_max = beta
                beta = beta / 2.0 if beta_min == -np.inf else (beta + beta_min) / 2.0
            h, p = _hbeta(row, beta)
        P[i, np.arange(n) != i] = p
    return P


def _tsne_step(P: Tensor, Y: Tensor, velocity: Tensor, gains: Tensor,
               momentum, lr: float):
    """One gradient iteration (Tsne.java gradient + BarnesHutTsne schedule):
    Q from Student-t kernel, gradient 4·Σ(p−q)q_num(yᵢ−yⱼ), gain-adapted
    momentum update, re-centering."""
    y2 = torch.sum(Y * Y, dim=1)
    num = 1.0 / (1.0 + y2[:, None] + y2[None, :] - 2.0 * (Y @ Y.T))  # [N,N]
    num = num * (1.0 - torch.eye(Y.shape[0], dtype=Y.dtype, device=Y.device))
    Q = num / torch.clamp(torch.sum(num), min=1e-12)
    PQ = (P - torch.clamp(Q, min=1e-12)) * num                      # [N,N]
    # grad_i = 4 Σ_j PQ_ij (y_i − y_j)  → diag trick keeps it matmul-shaped
    grad = 4.0 * ((torch.diag(torch.sum(PQ, dim=1)) - PQ) @ Y)
    # gains: grow when grad and velocity disagree (Tsne.java gains logic)
    same_sign = (grad > 0) == (velocity > 0)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
    velocity = momentum * velocity - lr * gains * grad
    Y = Y + velocity
    Y = Y - torch.mean(Y, dim=0, keepdim=True)
    kl = torch.sum(torch.where(P > 0, P * torch.log(torch.clamp(P, min=1e-12)
                                                    / torch.clamp(Q, min=1e-12)), 0.0))
    return Y, velocity, gains, kl


# ---------------------------------------------------------------------------
# chunked large-N path: sparse-KNN affinities + streamed exact repulsion
# ---------------------------------------------------------------------------


def _knn_rows(xq: Tensor, row0: int, x: Tensor, k: int, block: int):
    """k-NN of the row chunk ``xq`` against the full set ``x``, streaming
    candidate columns in [R,B] tiles (the VPTree's role).  ``row0``: global
    index of xq's first row (self-match exclusion)."""
    r, n = xq.shape[0], x.shape[0]
    xq2 = torch.sum(xq * xq, dim=1)
    x2 = torch.sum(x * x, dim=1)
    rows = row0 + torch.arange(r, device=x.device)
    best = None
    for c0 in range(0, n, block):
        xb = x[c0:c0 + block]
        d2 = xq2[:, None] + x2[c0:c0 + block][None, :] - 2.0 * (xq @ xb.T)   # [R,B]
        cols = c0 + torch.arange(xb.shape[0], device=x.device)
        d2.masked_fill_(cols[None, :] == rows[:, None], float("inf"))
        best = smallest_keys(order_keys(d2, c0), k, best)
        del d2
    d2k, idx = decode_keys(best)
    return idx, torch.clamp(d2k, min=0.0)


def _knn_blocked(x: Tensor, k: int, block: int, row_chunk: int = KNN_ROW_CHUNK):
    """Brute-force k-NN: rows processed in chunks (bounds the [R, k+B] key
    buffers), columns streamed.  Returns (idx [N,k] int64, d2 [N,k] f32) —
    self excluded."""
    n = x.shape[0]
    outs = [_knn_rows(x[r0:r0 + row_chunk], r0, x, k, block)
            for r0 in range(0, n, row_chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _sparse_p_search(d2k: Tensor, perplexity: float, iters: int = 50):
    """Vectorized per-row precision bisection over the k-NN distances
    (all rows in parallel — the device form of Tsne.java's hBeta loop).
    Returns row-normalized P [N,k]."""
    target = torch.log(torch.tensor(perplexity, dtype=d2k.dtype, device=d2k.device))

    def h_of(beta):
        p = torch.exp(-d2k * beta[:, None])
        s = torch.clamp(torch.sum(p, dim=1), min=1e-30)
        h = torch.log(s) + beta * torch.sum(d2k * p, dim=1) / s
        return h, p / s[:, None]

    n = d2k.shape[0]
    beta = torch.ones(n, dtype=d2k.dtype, device=d2k.device)
    lo = torch.full((n,), -float("inf"), dtype=d2k.dtype, device=d2k.device)
    hi = torch.full((n,), float("inf"), dtype=d2k.dtype, device=d2k.device)
    for _ in range(iters):
        h, _ = h_of(beta)
        too_high = h > target                       # entropy high → raise beta
        lo2 = torch.where(too_high, beta, lo)
        hi2 = torch.where(too_high, hi, beta)
        beta = torch.where(too_high,
                           torch.where(torch.isinf(hi2), beta * 2.0, (beta + hi2) / 2),
                           torch.where(torch.isneginf(lo2), beta / 2.0, (beta + lo2) / 2))
        lo, hi = lo2, hi2
    _, p = h_of(beta)
    return p


def _symmetrize_sparse(idx: Tensor, p: Tensor, row_block: int = 4096):
    """P_sym[i,a] = (p_i[a] + p_{j→i}) / (2N) for j = idx[i,a], where
    p_{j→i} is j's affinity back to i if i is among j's neighbors (0
    otherwise) — symmetric VALUES on the directed-KNN support, in row
    blocks.  Used for KL reporting and the k=N−1 parity path; the gradient
    itself uses the both-endpoint edge scatter in _chunked_tsne_step,
    which realizes the full UNION support (a one-directional in-link still
    attracts both endpoints) without materializing it."""
    n, k = idx.shape
    out = torch.empty_like(p)
    for r0 in range(0, n, row_block):
        my_idx = idx[r0:r0 + row_block]
        rows = r0 + torch.arange(my_idx.shape[0], device=idx.device)
        nbr_idx = idx[my_idx]                       # [R, k, k]
        nbr_p = p[my_idx]                           # [R, k, k]
        match = nbr_idx == rows[:, None, None]      # does j point back at i?
        back = torch.sum(torch.where(match, nbr_p, 0.0), dim=2)
        out[r0:r0 + row_block] = (p[r0:r0 + row_block] + back) / (2.0 * n)
    return out


def _chunked_tsne_step(idx, P_cond, P_sym, Y, velocity, gains, momentum, lr,
                       block):
    """One exact gradient iteration with the repulsive term streamed in
    [N,B] column blocks.  grad_i = 4[Σ_j s_ij num_ij (y_i−y_j)
    − (Σ_j num²_ij (y_i−y_j)) / Z] with Z accumulated across blocks before
    the single division — the dense math, never an [N,N] buffer.

    Attraction uses s_ij = (p_ij + p_ji)/(2N) over the UNION of the
    directed KNN supports, realized by scattering each directed edge
    (i→j, weight w = p_ij/2N) to BOTH endpoints: i accumulates its own
    out-edges plus every in-link, which sums to exactly Σ_j s_ij·… even
    for asymmetric pairs (a hub point j in many neighbor lists is pulled
    by all of them although its own k slots are full).  ``P_cond`` is the
    row-conditional affinity [N,k] (optionally early-exaggerated);
    ``P_sym`` the symmetric values for the KL diagnostic."""
    n, d = Y.shape
    y2 = torch.sum(Y * Y, dim=1)
    one_y2 = (1.0 + y2)[:, None]
    Z = torch.zeros((), dtype=Y.dtype, device=Y.device)
    S2 = torch.zeros(n, dtype=Y.dtype, device=Y.device)
    W = torch.zeros((n, d), dtype=Y.dtype, device=Y.device)
    for c0 in range(0, n, block):
        Yb = Y[c0:c0 + block]
        # num = 1 / (1 + y2_i + y2_j − 2 y_i·y_j), one [N,B] buffer
        num = one_y2 + y2[c0:c0 + block][None, :]
        num.addmm_(Y, Yb.T, alpha=-2.0).reciprocal_()
        num[c0:c0 + Yb.shape[0]].fill_diagonal_(0.0)   # j == i
        Z = Z + torch.sum(num)
        num.square_()
        S2 = S2 + torch.sum(num, dim=1)
        W = W + num @ Yb
        del num
    Z = torch.clamp(Z, min=1e-12)
    rep = (S2[:, None] * Y - W) / Z                 # Σ num²(y_i−y_j)/Z

    # attractive term: both-endpoint scatter over the directed KNN edges
    # (see docstring — exact union-support symmetrization)
    Yn = Y[idx]                                     # [N, k, d]
    dif = Y[:, None, :] - Yn
    num_k = 1.0 / (1.0 + torch.sum(dif * dif, dim=2))
    w = P_cond / (2.0 * n)
    f = (w * num_k)[:, :, None] * dif               # [N, k, d] edge forces
    attr = torch.sum(f, dim=1)                      # … on the source ends
    attr = attr - add_rows(torch.zeros_like(Y), idx.reshape(-1),
                           f.reshape(-1, d))    # reaction on targets
    grad = 4.0 * (attr - rep)

    same_sign = (grad > 0) == (velocity > 0)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
    velocity = momentum * velocity - lr * gains * grad
    Y = Y + velocity
    Y = Y - torch.mean(Y, dim=0, keepdim=True)
    # KL diagnostic over the directed support (one-directional in-links
    # contribute once instead of twice — reporting only, not the gradient)
    q = torch.clamp(num_k / Z, min=1e-12)
    kl = torch.sum(torch.where(P_sym > 0,
                               P_sym * torch.log(torch.clamp(P_sym, min=1e-12) / q),
                               0.0))
    return Y, velocity, gains, kl


class Tsne:
    """Builder-parity surface (reference BarnesHutTsne.Builder):
    setMaxIter, perplexity, theta (ignored — exact), learningRate,
    useAdaGrad→gains, stopLyingIteration (early exaggeration end).

    ``method``: "exact" (dense [N,N], the small-N fast path), "chunked"
    (sparse-KNN attraction + streamed exact repulsion in O(N·(B + k))
    memory), or "auto" (chunked above ``auto_chunk_threshold`` points).
    Both run on ``device`` (default the card); the exact path's
    perplexity search is the reference's numpy code on the host.
    ``knn_k`` (chunked): neighbors for the sparse affinities; default
    3·perplexity (the reference BarnesHutTsne's choice), capped at N−1 —
    at k = N−1 chunked and exact affinities coincide (the parity test)."""

    def __init__(self,
                 n_components: int = 2,
                 perplexity: float = 30.0,
                 max_iter: int = 500,
                 learning_rate: float = 200.0,
                 early_exaggeration: float = 12.0,
                 stop_lying_iteration: int = 100,
                 initial_momentum: float = 0.5,
                 final_momentum: float = 0.8,
                 momentum_switch: int = 250,
                 seed: int = 12345,
                 method: str = "auto",
                 knn_k: Optional[int] = None,
                 block_size: int = 1024,
                 auto_chunk_threshold: int = 8192,
                 device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.lr = learning_rate
        self.early_exaggeration = early_exaggeration
        self.stop_lying_iteration = stop_lying_iteration
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        if method not in ("auto", "exact", "chunked"):
            raise ValueError(f"method must be auto|exact|chunked, got {method!r}")
        self.method = method
        self.knn_k = knn_k
        self.block_size = block_size
        self.auto_chunk_threshold = auto_chunk_threshold
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if n < 4:
            raise ValueError("t-SNE needs at least 4 points")
        if self.perplexity >= (n - 1) / 3:
            raise ValueError(f"perplexity {self.perplexity} too large for N={n} "
                             "(need perplexity < (N-1)/3)")
        if self.method == "chunked" or (self.method == "auto"
                                        and n > self.auto_chunk_threshold):
            return self._fit_chunked(x.astype(np.float32))
        # symmetric affinities from the perplexity search
        d2 = np.sum(x * x, axis=1)[:, None] + np.sum(x * x, axis=1)[None, :] \
            - 2.0 * (x @ x.T)
        np.fill_diagonal(d2, 0.0)
        P = _binary_search_p(np.maximum(d2, 0.0), self.perplexity)
        P = (P + P.T) / (2.0 * n)
        P = np.maximum(P, 1e-12)

        dev = self.device
        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(0.0, 1e-4, (n, self.n_components))
                             .astype(np.float32)).to(dev)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        P_lying = torch.from_numpy((P * self.early_exaggeration).astype(np.float32)).to(dev)
        P_true = torch.from_numpy(P.astype(np.float32)).to(dev)
        kl = None
        for it in range(self.max_iter):
            Pj = P_lying if it < self.stop_lying_iteration else P_true
            mom = self.initial_momentum if it < self.momentum_switch \
                else self.final_momentum
            Y, vel, gains, kl = _tsne_step(Pj, Y, vel, gains,
                                           float(np.float32(mom)), self.lr)
        self.kl_divergence_ = None if kl is None else float(kl)
        return Y.cpu().numpy()

    def _fit_chunked(self, x: np.ndarray) -> np.ndarray:
        """Large-N path: sparse-KNN affinities + streamed exact repulsion
        (see module docstring).  Peak memory O(N·(B + k))."""
        n = x.shape[0]
        k = self.knn_k if self.knn_k is not None else int(3 * self.perplexity)
        k = min(k, n - 1)
        if k < self.perplexity:
            # the per-row entropy bisection can never reach log(perplexity)
            # over k neighbors (max entropy = log k): P would silently
            # degenerate to uniform rows
            raise ValueError(f"knn_k={k} < perplexity={self.perplexity}: "
                             "need k >= perplexity (default 3*perplexity)")
        block = min(self.block_size, n)
        dev = self.device
        xd = torch.from_numpy(x).to(dev)
        # KNN wants LARGE column blocks (the top-k merge per tile is the
        # cost) while the per-iteration repulsion block stays small
        idx, d2k = _knn_blocked(xd, k, max(block, min(8192, n)))
        del xd
        p_cond = _sparse_p_search(d2k, self.perplexity)
        P_sym = torch.clamp(_symmetrize_sparse(idx, p_cond,
                                               row_block=min(4096, n)), min=1e-12)

        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(0.0, 1e-4, (n, self.n_components))
                             .astype(np.float32)).to(dev)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        P_lying = p_cond * self.early_exaggeration
        kl = None
        for it in range(self.max_iter):
            Pj = P_lying if it < self.stop_lying_iteration else p_cond
            mom = self.initial_momentum if it < self.momentum_switch \
                else self.final_momentum
            Y, vel, gains, kl = _chunked_tsne_step(
                idx, Pj, P_sym, Y, vel, gains, float(np.float32(mom)),
                self.lr, block)
        self.kl_divergence_ = None if kl is None else float(kl)
        return Y.cpu().numpy()
