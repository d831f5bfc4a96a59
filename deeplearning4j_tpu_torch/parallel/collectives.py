"""Collectives over one axis of a ``RankMesh``, in autograd form.

The reference writes its parallel programs inside ``shard_map`` with
``lax`` primitives over named axes (``psum``, ``ppermute``,
``all_to_all``, ``axis_index``) and lets JAX transpose them.  Here one
process is one rank, and each primitive is a ``torch.autograd.Function``
over the process group of this rank's line along the axis, whose
backward is the transpose of its forward:

  ``psum``      all-reduce (sum) forward, identity backward: Megatron's
                *g*, after a row-parallel product whose result every rank
                of the line then uses alike;
  ``pvary``     identity forward, all-reduce backward: Megatron's *f*,
                before a column-parallel product (each rank's product
                sends back only its share of the input's gradient);
  ``ppermute``  rank i's block goes to rank perm[i] (zeros where no block
                arrives); backward sends the gradients the other way;
  ``all_to_all`` split one dim into n blocks, block j to rank j, blocks
                received concatenated on another dim (``tiled=True``);
                backward swaps the two dims;
  ``all_gather`` every rank's block joined on a dim; backward keeps this
                rank's block of the gradient;
  ``all_reduce`` and ``pmax`` (no gradient); ``Axis.index`` is
                ``lax.axis_index``.

Transport: every op is an all-reduce or an all-gather.  ``ppermute`` and
``all_to_all`` all-gather the blocks of the line and keep the ones this
rank receives, n times the bytes of a send/receive for an axis of n
ranks (the meshes here are 2 wide).  Over gloo a CUDA tensor is staged
through a host copy explicitly (``_staged``): gloo has no send/receive or
all-to-all for CUDA tensors, so the port stages every op alike rather
than lean on which ones gloo happens to take.  Sums run in the tensor's
own dtype (a bf16 product is reduced in bf16, as the reference's psum
of a bf16 value is).  NCCL takes the tensors where they are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


class Axis:
    """One named axis of a ``RankMesh`` as this rank sees it: its size,
    this rank's index along it and the process group of its line."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = int(mesh.shape.get(name, 1))
        self.index = int(mesh.coords.get(name, 0))
        self.group = mesh.group(name) if self.size > 1 else None
        if self.size > 1 and self.group is None:
            raise RuntimeError(
                f"mesh axis {name!r} has size {self.size} but no process group: "
                "call distributed.initialize() in every rank before building the mesh")

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


def _staged(t: Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: Tensor, axis: Axis, op=None) -> Tensor:
    """``t`` reduced (default: summed) over the line, a new tensor; no
    gradient (``psum`` is the differentiable sum)."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    out = t.contiguous().clone()
    if _staged(out, axis.group):
        host = out.cpu()
        dist.all_reduce(host, op=op, group=axis.group)
        return host.to(t.device)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _all_gather(t: Tensor, axis: Axis) -> List[Tensor]:
    """Every rank's ``t`` along ``axis``, in axis order."""
    import torch.distributed as dist

    t = t.contiguous()
    src = t.cpu() if _staged(t, axis.group) else t
    out = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(out, src, group=axis.group)
    return [o.to(t.device) for o in out]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


def psum(x: Tensor, axis: Optional[Axis]) -> Tensor:
    """Sum of ``x`` over the line; the backward passes the gradient
    through (every rank of the line uses the sum alike)."""
    if axis is None or axis.size == 1:
        return x
    return _Psum.apply(x, axis)


def pvary(x: Tensor, axis: Optional[Axis]) -> Tensor:
    """``x`` itself; the backward sums the gradient over the line (each
    rank's use of ``x`` holds a share of it)."""
    if axis is None or axis.size == 1:
        return x
    return _Pvary.apply(x, axis)


def _permute(x: Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> Tensor:
    src = {d: s for s, d in perm}.get(axis.index)
    blocks = _all_gather(x, axis)
    return blocks[src] if src is not None else torch.zeros_like(x)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.axis, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> Tensor:
    """``lax.ppermute``: (source, destination) index pairs along ``axis``;
    a rank no pair sends to gets zeros."""
    if axis.size == 1:
        return x if (0, 0) in tuple(perm) else torch.zeros_like(x)
    return _Ppermute.apply(x, axis, tuple(perm))


def _a2a(x: Tensor, axis: Axis, split: int, concat: int) -> Tensor:
    blocks = _all_gather(x, axis)
    mine = [b.chunk(axis.size, dim=split)[axis.index] for b in blocks]
    return torch.cat(mine, dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _a2a(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.axis, ctx.concat, ctx.split), None, None, None


def all_to_all(x: Tensor, axis: Axis, split_axis: int, concat_axis: int) -> Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into
    ``axis.size`` blocks, block j to rank j, the received blocks joined
    on ``concat_axis`` in rank order."""
    if x.shape[split_axis] % axis.size:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} not divisible by "
                         f"{axis.name!r} axis size {axis.size}")
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_axis % x.ndim, concat_axis % x.ndim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(_all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.index], None, None


def all_gather(x: Tensor, axis: Axis, dim: int = 0) -> Tensor:
    """Every rank's ``x`` joined on ``dim`` (``tiled=True``); the backward
    keeps this rank's block of the gradient (every rank of the line uses
    the gathered tensor alike)."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.ndim)


def pmax(x: Tensor, axis: Optional[Axis]) -> Tensor:
    """Elementwise max over the line, no gradient."""
    import torch.distributed as dist

    if axis is None or axis.size == 1:
        return x.detach()
    return all_reduce(x.detach(), axis, dist.ReduceOp.MAX)
