"""Ulysses sequence parallelism — all-to-all head-scatter / seq-gather
(mirrors ``deeplearning4j_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses,
Jacobs et al. 2023).

Two all-to-alls wrap one attention: q/k/v [B, H, T/P, D] become
[B, H/P, T, D] (heads scattered, the sequence gathered), each rank runs
``flash_mha`` over the whole sequence for its heads — kernels K1-K3 on
the card, with the causal mask and a gathered key mask — and the output
goes back to [B, H, T/P, D].  The heads are the scattered resource, so
H must divide by the ``seq`` size.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import flash_mha
from .collectives import Axis, all_gather, all_to_all
from .ring import sequence_block

Tensor = torch.Tensor


def ulysses_attention(q: Tensor, k: Tensor, v: Tensor, axis: Axis, *,
                      causal: bool = False, scale: Optional[float] = None,
                      kmask: Optional[Tensor] = None) -> Tensor:
    """All-to-all attention of this rank's q/k/v [B, H, T_local, D]
    (the sequence split over ``axis``, T_global = T_local · P).
    ``kmask`` [B, T_local] is this rank's slice of the key mask.  Returns
    [B, H, T_local, D], split the same way."""
    p = axis.size
    h = q.shape[1]
    if h % p:
        raise ValueError(f"n_heads {h} not divisible by '{axis.name}' axis "
                         f"size {p} — Ulysses scatters heads; use ring "
                         "attention for head counts below the axis size")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kg, vg = (all_to_all(a, axis, 1, 2) for a in (q, k, v))
    mg = None if kmask is None else all_gather(kmask, axis, dim=1)
    o = flash_mha(qg, kg, vg, causal, scale, kmask=mg)
    return all_to_all(o, axis, 2, 1)


def ulysses_self_attention(q: Tensor, k: Tensor, v: Tensor, mesh, *,
                           seq_axis: str = "seq", causal: bool = False,
                           scale: Optional[float] = None,
                           kmask: Optional[Tensor] = None) -> Tensor:
    """Ulysses attention of whole [B, H, T, D] q/k/v held alike by every
    rank of the ``seq_axis`` line (``kmask`` [B, T] too); every rank
    returns the whole output.  T and H must divide by the axis size."""
    ax = Axis(mesh, seq_axis)
    qs, ks, vs = (sequence_block(a, ax, 2) for a in (q, k, v))
    ms = None if kmask is None else kmask.chunk(ax.size, dim=1)[ax.index]
    out = ulysses_attention(qs, ks, vs, ax, causal=causal, scale=scale, kmask=ms)
    return all_gather(out, ax, dim=2)
