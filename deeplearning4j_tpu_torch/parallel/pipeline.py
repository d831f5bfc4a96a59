"""Pipeline parallelism — microbatch schedules over the ``pipe`` mesh axis
(mirrors ``deeplearning4j_tpu/parallel/pipeline.py``).

A stack of homogeneous blocks has its parameters stacked on a leading
stage axis; rank p of the ``pipe`` axis holds stages ``p·L/S ..
(p+1)·L/S - 1`` (L stages, S pipe ranks).  The batch is cut into M
microbatches on dim 0.  At tick s the rank of stage p runs microbatch
``s - p`` through its blocks and hands the activation to stage p + 1
(``collectives.ppermute``); the last stage's outputs are summed over
``pipe`` (zeros elsewhere), so every pipe rank holds the stack's output,
as the reference's psum does.  The pipeline is one
``torch.autograd.Function``; its backward runs the schedule's backward
ticks by hand, so every rank of a ``pipe`` line enters the same
collectives in the same order, and the input's gradient (stage 0's) is
summed over ``pipe`` for the layers before the stack, which every pipe
rank runs alike.

``schedule="gpipe"`` — all forwards, then all backwards.  The forward
keeps each microbatch's autograd graph of its stage (M sets a rank);
the backward walks the ticks in reverse, each stage differentiating its
microbatch and sending the input's gradient to stage p - 1.  Bubble
(S-1)/(M+S-1).

``schedule="1f1b"`` — interleaved one-forward-one-backward.  The forward
value pass is the same program as gpipe's, run without a graph, so the
first step's loss is bitwise gpipe's.  The backward is one combined pass
of M + 2(S-1) ticks: in tick s stage p recomputes microbatch f = s - p
(warm-up and steady state) and stashes its stage input, and
differentiates microbatch b = s - 2(S-1) + p, recomputing its stage
forward from the stash (steady state and cool-down).  A stage holds at
most ``min(M, 2S-1)`` stashed stage inputs (+1 in transit) and the
graph of one microbatch at a time, so peak activation memory is bounded
by the depth, not by M; the price is 3 forward passes a microbatch
against gpipe's 1.  ``pipeline_schedule_stats`` is the analytic model.

Both compose with the other axes: the caller passes this rank's rows
(its ``data``/``seq`` block) and ``block_fn`` may run collectives over
``model`` or ``seq`` (the ranks of those lines share a pipe coordinate,
so they run the same ticks).  Unlike the reference, which takes the
global batch and ``PartitionSpec``s, the port is one program a rank:
``x`` is this rank's activations and the result is this rank's output.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from .collectives import Axis, all_reduce, ppermute

logger = logging.getLogger("deeplearning4j_tpu_torch")

Tensor = torch.Tensor

SCHEDULES = ("gpipe", "1f1b")


def stack_stage_params(param_list):
    """Stack per-block param dicts [p0, p1, ...] into one dict with a
    leading stage axis (all blocks must be homogeneous)."""
    return {k: torch.stack([p[k] for p in param_list]) for k in param_list[0]}


def stage_sharding(stacked_params, n_pipe: int, index: int):
    """Rank ``index``'s stages of ``stacked_params`` split ``n_pipe`` ways
    on the leading stage axis (the reference's ``P('pipe', ...)``)."""
    def part(a):
        if a.shape[0] % n_pipe:
            raise ValueError(f"{a.shape[0]} stages not divisible by pipe={n_pipe}")
        per = a.shape[0] // n_pipe
        return a[index * per:(index + 1) * per]
    return {k: part(v) for k, v in stacked_params.items()}


def pipeline_schedule_stats(schedule: str, n_microbatches: int,
                            n_stages: int, *, layers_per_stage: int = 1,
                            residual_factor: float = 1.0,
                            stage_input_bytes: int = 0) -> Dict[str, Any]:
    """Analytic bubble / peak-activation accounting for one schedule (a
    copy of the reference's).

      - ``bubble_fraction``: idle slots over the slots of the schedule
        grid run: gpipe (S-1)/(M+S-1); 1f1b, a value pass (M+S-1 slots)
        plus a combined pass of M+2(S-1) ticks with a forward and a
        backward slot each, (5S-5)/(3M+5S-5);
      - ``peak_live_stage_inputs``: gpipe M+S-1, 1f1b min(M, 2S-1)+1;
      - ``peak_activation_units``: the same plus per-layer block residuals
        (``layers_per_stage * residual_factor`` per checkpointed
        microbatch), times ``stage_input_bytes`` for
        ``peak_activation_bytes``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    m, s = n_microbatches, n_stages
    if m < 1 or s < 1:
        raise ValueError(f"need n_microbatches>=1, n_stages>=1; got {m}, {s}")
    lr = layers_per_stage * residual_factor
    if schedule == "gpipe":
        out = {
            "schedule": "gpipe",
            "n_steps": 2 * (m + s - 1),
            "bubble_fraction": (s - 1) / (m + s - 1),
            "peak_live_stage_inputs": m + s - 1,
            "peak_activation_units": (m + s - 1) * max(lr, 1.0),
            "forward_passes_per_microbatch": 1,
        }
    else:
        live = min(m, 2 * s - 1) + 1
        out = {
            "schedule": "1f1b",
            "n_steps": (m + s - 1) + (m + 2 * (s - 1)),
            "bubble_fraction": (5 * s - 5) / (3 * m + 5 * s - 5),
            "peak_live_stage_inputs": live,
            "peak_activation_units": live + max(lr, 1.0),
            "forward_passes_per_microbatch": 3,
        }
        g_equiv = int(out["peak_activation_units"] // max(lr, 1.0)) - s + 1
        out["gpipe_microbatches_at_same_memory"] = max(g_equiv, 1)
    if stage_input_bytes:
        out["peak_activation_bytes"] = int(
            out["peak_activation_units"] * stage_input_bytes)
    return out


class _Stage:
    """One rank's part of a pipeline: its stages' blocks and the ticks."""

    def __init__(self, block_fn, keys: List[str], axis: Axis, m: int, schedule: str):
        self.block_fn, self.keys, self.axis = block_fn, keys, axis
        self.m, self.schedule = m, schedule
        self.S, self.my = axis.size, axis.index
        self.fwd_perm = [(i, i + 1) for i in range(self.S - 1)]
        self.bwd_perm = [(i + 1, i) for i in range(self.S - 1)]
        #: the most stage inputs the 1f1b backward held stashed at once
        self.peak_stash = 0

    def apply(self, params: List[Tensor], h: Tensor) -> Tensor:
        for i in range(params[0].shape[0]):
            h = self.block_fn({k: p[i] for k, p in zip(self.keys, params)}, h)
        return h

    def send(self, t: Tensor, perm) -> Tensor:
        return ppermute(t, self.axis, perm) if self.S > 1 else torch.zeros_like(t)

    def bcast(self, t: Tensor, root: int) -> Tensor:
        """``t`` of the ``root`` stage on every pipe rank (the sum of it and
        the other ranks' zeros)."""
        if self.S == 1:
            return t
        return all_reduce(t if self.my == root else torch.zeros_like(t), self.axis)

    def forward_pass(self, params, micro: List[Tensor], keep: bool):
        """The value pass → (stack output on this rank's last stage, or
        zeros elsewhere, [M, mb, ...]; the per-microbatch graphs when
        ``keep``)."""
        S, my, m = self.S, self.my, self.m
        buf = torch.zeros_like(micro[0])
        outs = [torch.zeros_like(micro[0]) for _ in range(m)]
        graphs: Dict[int, tuple] = {}
        for s in range(m + S - 1):
            f = s - my
            h_out = torch.zeros_like(buf)
            if 0 <= f < m:
                h_in = micro[f] if my == 0 else buf
                if keep:
                    leaf = h_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        h_out = self.apply(params, leaf)
                    graphs[f] = (leaf, h_out)
                    h_out = h_out.detach()
                else:
                    h_out = self.apply(params, h_in)
                if my == S - 1:
                    outs[f] = h_out
            buf = self.send(h_out, self.fwd_perm)
        return torch.stack(outs), graphs

    def vjp(self, params, h_in: Optional[Tensor], graph, g: Tensor):
        """(d input, d params) of one microbatch's stage, from its kept
        graph or recomputed from its stashed input."""
        with torch.enable_grad():
            if graph is None:
                leaf = h_in.detach().requires_grad_(True)
                graph = (leaf, self.apply(params, leaf))
            leaf, out = graph
            grads = torch.autograd.grad(out, [leaf] + params, g, allow_unused=True)
        return grads[0], [torch.zeros_like(p) if d is None else d
                          for p, d in zip(params, grads[1:])]

    def backward_gpipe(self, params, graphs, gmicro: List[Tensor]):
        S, my, m = self.S, self.my, self.m
        dp = [torch.zeros_like(p) for p in params]
        dx = [torch.zeros_like(gmicro[0]) for _ in range(m)]
        gbuf = torch.zeros_like(gmicro[0])
        for s in reversed(range(m + S - 1)):
            f = s - my
            dh = torch.zeros_like(gbuf)
            if 0 <= f < m:
                g = gmicro[f] if my == S - 1 else gbuf
                dh, d = self.vjp(params, None, graphs.pop(f), g)
                dp = [a + b for a, b in zip(dp, d)]
                if my == 0:
                    dx[f] = dh
            gbuf = self.send(dh, self.bwd_perm)
        return dx, dp

    def backward_1f1b(self, params, micro: List[Tensor], gmicro: List[Tensor]):
        S, my, m = self.S, self.my, self.m
        K = min(m, 2 * S - 1)
        stash: List[Optional[Tensor]] = [None] * K
        dp = [torch.zeros_like(p) for p in params]
        dx = [torch.zeros_like(gmicro[0]) for _ in range(m)]
        fbuf = torch.zeros_like(micro[0])
        gbuf = torch.zeros_like(gmicro[0])
        for s in range(m + 2 * (S - 1)):
            # forward slot: recompute the wavefront, stash the stage input
            f = s - my
            h_out = torch.zeros_like(fbuf)
            if 0 <= f < m:
                h_in = micro[f] if my == 0 else fbuf
                stash[f % K] = h_in
                self.peak_stash = max(self.peak_stash, sum(t is not None for t in stash))
                with torch.no_grad():
                    h_out = self.apply(params, h_in)
            # backward slot: differentiate microbatch b from its stash
            b = s - 2 * (S - 1) + my
            dh = torch.zeros_like(gbuf)
            if 0 <= b < m:
                g = gmicro[b] if my == S - 1 else gbuf
                dh, d = self.vjp(params, stash[b % K], None, g)
                stash[b % K] = None
                dp = [a + c for a, c in zip(dp, d)]
                if my == 0:
                    dx[b] = dh
            fbuf = self.send(h_out, self.fwd_perm)
            gbuf = self.send(dh, self.bwd_perm)
        return dx, dp


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x, *params):
        params = [p.detach().requires_grad_(True) for p in params]
        micro = list(x.detach().chunk(stage.m))
        out, graphs = stage.forward_pass(params, micro, keep=stage.schedule == "gpipe")
        ctx.stage, ctx.graphs, ctx.params, ctx.micro = stage, graphs, params, micro
        return stage.bcast(out, stage.S - 1).reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        stage = ctx.stage
        gmicro = list(gy.contiguous().chunk(stage.m))
        if stage.schedule == "gpipe":
            dx, dp = stage.backward_gpipe(ctx.params, ctx.graphs, gmicro)
        else:
            dx, dp = stage.backward_1f1b(ctx.params, ctx.micro, gmicro)
        ctx.graphs = ctx.params = ctx.micro = None
        dx = stage.bcast(torch.cat(dx), 0)
        return (None, dx) + tuple(dp)


def microbatches(batch: int, n_microbatches: int) -> int:
    """The microbatch count for a local batch: ``n_microbatches``, or the
    largest count below it that divides the batch (with a warning, as in
    the reference: a prime batch collapses to 1, a full bubble)."""
    m = n_microbatches
    while batch % m:
        m -= 1
    if m != n_microbatches:
        # graftcheck: disable=GC102 (shape-static degradation warning: firing ONCE at trace time is exactly the intended behavior)
        logger.warning(
            "n_microbatches=%d does not divide local batch %d — degraded to "
            "%d%s; pad the batch or pick a divisor to keep the pipeline full",
            n_microbatches, batch, m,
            " (NO pipelining: full GPipe bubble)" if m == 1 else "")
    return m


def pipeline_apply(block_fn: Callable[[Any, Tensor], Tensor], stacked_params,
                   x: Tensor, mesh, *, axis: str = "pipe", n_microbatches: int = 4,
                   schedule: str = "gpipe", stage_local: bool = False) -> Tensor:
    """Run this rank's ``x`` [B, ...] through the pipelined block stack;
    returns the same-shape output, on every rank of the ``pipe`` line.

    ``block_fn(params_i, h) -> h`` is one block (activation shapes are
    preserved).  ``stacked_params`` is a dict of the whole stack's
    parameters with a leading stage axis (divisible by the ``pipe``
    size), of which this rank takes its stages; with ``stage_local`` it
    is already this rank's stages.  Microbatching splits dim 0 into
    ``n_microbatches`` (degraded to a divisor of B with a warning).
    ``schedule``: ``"gpipe"`` or ``"1f1b"`` (the module docstring has the
    trade-off; the forward values are the same program in both)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    keys = sorted(stacked_params)
    n_pipe = mesh.shape.get(axis, 1)
    if not stage_local and stacked_params[keys[0]].shape[0] % n_pipe:
        raise ValueError(f"{stacked_params[keys[0]].shape[0]} stages not divisible "
                         f"by pipe={n_pipe}")
    ax = Axis(mesh, axis)
    if not stage_local:
        stacked_params = stage_sharding(stacked_params, ax.size, ax.index)
    params = [stacked_params[k] for k in keys]
    stage = _Stage(block_fn, keys, ax, microbatches(x.shape[0], n_microbatches), schedule)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(stage, x, *params)
    out, _ = stage.forward_pass(params, list(x.chunk(stage.m)), keep=False)
    return stage.bcast(out, stage.S - 1).reshape(x.shape)
