"""Ring attention — sequence parallelism over the ``seq`` mesh axis
(mirrors ``deeplearning4j_tpu/parallel/ring.py``).

The sequence is split across the ranks of the ``seq`` line; each keeps
its query block and folds in one K/V block a hop with the online-softmax
update (``ops.attention.blockwise_update``), passing K/V on around the
ring (``collectives.ppermute``).  Causal masking uses global block
offsets.  Plain PyTorch, as the reference's is plain XLA: no kernel runs
here, and autograd differentiates the hops (the permutes' backward sends
the gradients back around the ring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import NEG_INF, blockwise_update, causal_bias
from .collectives import Axis, all_gather, ppermute, pvary

Tensor = torch.Tensor


def ring_attention(q: Tensor, k: Tensor, v: Tensor, axis: Axis, *,
                   causal: bool = False, scale: Optional[float] = None) -> Tensor:
    """Attention of this rank's q [B, H, T_local, D] over the whole
    sequence, whose K/V blocks [B, H, T_local, D] rotate around ``axis``.

    n hops: at hop j this rank holds the block of rank ``(my - j) mod n``,
    folds it into f32 accumulators (max, denominator, output) and hands it
    to the next rank; the output is the accumulator over ``max(l,
    1e-30)`` in q's dtype.  (The reference issues the last hop's permute
    too, to keep its loop shape static; its result is never read, so the
    port does not send it.)"""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, my = axis.size, axis.index
    b, h, t, d = q.shape
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kk, vv = k, v
    for step in range(n):
        src = (my - step) % n
        bias = causal_bias(t, t, my * t, src * t, device=q.device) if causal else None
        acc, m, l = blockwise_update(acc, m, l, q, kk, vv, scale, bias)
        if step + 1 < n:
            kk = ppermute(kk, axis, perm)
            vv = ppermute(vv, axis, perm)
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def sequence_block(x: Tensor, axis: Axis, dim: int) -> Tensor:
    """This rank's block of ``x``, replicated over ``axis``, split on
    ``dim`` (its gradient summed over the axis)."""
    if x.shape[dim] % axis.size:
        raise ValueError(f"seq len {x.shape[dim]} not divisible by seq axis {axis.size}")
    return pvary(x, axis).chunk(axis.size, dim=dim)[axis.index]


def ring_self_attention(q: Tensor, k: Tensor, v: Tensor, mesh, *,
                        seq_axis: str = "seq", causal: bool = False,
                        scale: Optional[float] = None) -> Tensor:
    """Ring attention of whole [B, H, T, D] q/k/v, which every rank of the
    ``seq_axis`` line holds alike: each rank takes its sequence block,
    runs ``ring_attention`` and the blocks are gathered back, so every
    rank returns the whole output.  T must divide by the axis size."""
    ax = Axis(mesh, seq_axis)
    qs, ks, vs = (sequence_block(a, ax, 2) for a in (q, k, v))
    return all_gather(ring_attention(qs, ks, vs, ax, causal=causal, scale=scale), ax, dim=2)
