"""Distributed Word2Vec — data-parallel embedding training over the ranks
of a ``RankMesh`` (the port of ``deeplearning4j_tpu/nlp/distributed.py``).

Parity target: reference dl4j-spark-nlp (SparkWord2Vec /
Word2VecVariables: corpus sharded across executors, parameter averaging
of the word vectors each iteration) — the "Spark NLP" row of SURVEY §2.4.

The reference shards the pair batch over a mesh's data axis inside
``shard_map``; here one process is one rank (``torch.distributed``, gloo
or NCCL) and every rank builds the same global pair stream and draws the
same negatives (a pure function of the seed and the batch index).  Each
rank takes its consecutive share of a batch's rows (the rows
``P(data)`` gives that device), computes its UNSCALED gradient rows,
and an ``all_gather`` over the axis joins every rank's rows, indices
and weights; each rank then applies the identical global scatter-add
with occurrence averaging, so the tables stay replicated and the update
is the one-rank update at any rank count (equal to ~1e-5; the f32 sums
take another order).

Cost model: the collectives are ROW-SPARSE — each batch gathers the
per-pair gradient rows and indices, O(B·D·(2+K)) bytes per batch
independent of vocabulary size, in two gathers (one of indices, one of
floats, packed).  ``DistributedWord2Vec(mesh=...)`` is a drop-in
Word2Vec whose skip-gram update runs data-parallel; on a one-rank mesh
it reproduces the single-rank step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..parallel.collectives import Axis, all_gather
from ..parallel.mesh import RankMesh, build_mesh
from ..ops.scatter import add_rows
from .sequencevectors import _sg_pair_grads
from .word2vec import Word2Vec

Tensor = torch.Tensor


def _gather_packed(parts: Sequence[Tensor], axis: Axis) -> List[Tensor]:
    """Each of ``parts`` gathered over ``axis`` and joined on dim 0 in rank
    order (the reference's tiled ``all_gather`` of each), in ONE collective:
    the parts travel flattened and concatenated, one block a rank."""
    if axis.size == 1:
        return list(parts)
    sizes = [p.numel() for p in parts]
    flat = torch.cat([p.reshape(-1) for p in parts])
    blocks = all_gather(flat, axis).reshape(axis.size, -1)
    out, at = [], 0
    for p, n in zip(parts, sizes):
        out.append(blocks[:, at:at + n].reshape(axis.size * p.shape[0], *p.shape[1:]))
        at += n
    return out


def make_dp_sg_step(mesh: RankMesh, data_axis: str = "data"):
    """The data-parallel skip-gram step: pairs split over ``data_axis``,
    tables replicated, ROW-SPARSE collectives.

    The step takes the GLOBAL batch on every rank and keeps this rank's
    consecutive share of its rows.  Instead of all-reducing dense [V,D]
    delta tables, the ranks gather only their per-pair gradient ROWS and
    indices, and every rank applies the identical global scatter-add with
    occurrence averaging (the sum-then-divide of the reference's dense
    formulation).  ``last_gathered_bytes`` on the returned step holds the
    bytes the last call received from the gathers."""
    axis = Axis(mesh, data_axis)

    def step(syn0, syn1, centers, contexts, negatives, valid, lr):
        n = centers.shape[0] // axis.size
        s = slice(axis.index * n, (axis.index + 1) * n)
        c, w = centers[s], valid[s]
        dv, du_flat, flat_t, flat_tw = _sg_pair_grads(
            syn0, syn1, c, contexts[s], negatives[s], w, lr)
        # pair-level rows + indices cross the wire, not [V,D] tables
        g_c, g_t = _gather_packed([c, flat_t], axis)
        g_w, g_dv, g_tw, g_du = _gather_packed(
            [w, dv * w[:, None], flat_tw, du_flat * flat_tw[:, None]], axis)
        step.last_gathered_bytes = sum(
            t.numel() * t.element_size() for t in (g_c, g_t, g_w, g_dv, g_tw, g_du))
        n0 = torch.zeros(syn0.shape[0], dtype=torch.float32,
                         device=syn0.device).index_add_(0, g_c, g_w)
        d0 = add_rows(torch.zeros_like(syn0), g_c, g_dv)
        n1 = torch.zeros(syn1.shape[0], dtype=torch.float32,
                         device=syn1.device).index_add_(0, g_t, g_tw)
        d1 = add_rows(torch.zeros_like(syn1), g_t, g_du)
        syn0 += d0 / torch.clamp(n0, min=1.0)[:, None].to(syn0.dtype)
        syn1 += d1 / torch.clamp(n1, min=1.0)[:, None].to(syn1.dtype)
        return syn0, syn1

    step.last_gathered_bytes = 0
    return step


class DistributedWord2Vec(Word2Vec):
    """Word2Vec with the skip-gram update data-parallel over a mesh's data
    axis (reference SparkWord2Vec's role).  CBOW and hierarchical softmax
    are refused, as in the reference, which distributes the skip-gram
    path only.  Every rank calls ``fit`` on the same corpus."""

    def __init__(self, mesh: Optional[RankMesh] = None, data_axis: str = "data",
                 **kwargs):
        if kwargs.get("cbow") or kwargs.get("hierarchic_softmax"):
            raise NotImplementedError(
                "DistributedWord2Vec shards the skip-gram/negative-sampling "
                "path; use Word2Vec for CBOW/HS")
        super().__init__(**kwargs)
        if mesh is None:
            mesh = build_mesh({data_axis: -1})
        if data_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{data_axis}' axis: {dict(mesh.shape)}")
        dp = mesh.shape[data_axis]
        if self.batch_size % dp:
            raise ValueError(f"batch_size {self.batch_size} not divisible by "
                             f"data axis size {dp}")
        self.mesh = mesh
        self.data_axis = data_axis
        self._dp_step = make_dp_sg_step(mesh, data_axis)
        # the data-parallel step has no multi-batch loop — dispatch one
        # batch at a time (chunks stays 1; see _sg_step's failure for >1)
        self._device_batches = 1
        self._graphs = False     # the step gathers over gloo or NCCL ranks

    def _sg_step(self, syn0, syn1, centers, contexts, negatives, valid, lr,
                 chunks=1):
        if chunks > 1:
            # micro-chunk updates (DBOW label semantics) have no
            # data-parallel formulation here — fail rather than silently
            # average consecutive label pairs away
            raise NotImplementedError(
                "DistributedWord2Vec does not support chunked sequential "
                "updates (chunks>1, used by DBOW label training)")
        return self._dp_step(syn0, syn1, centers, contexts, negatives,
                             valid, lr)
