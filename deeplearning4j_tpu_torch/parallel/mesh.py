"""Rank meshes — the collectives layer over ``torch.distributed`` (mirrors
``deeplearning4j_tpu/parallel/mesh.py``).

The reference lays devices out on a ``jax.sharding.Mesh`` with named axes
and lets GSPMD insert the collectives.  Here one process drives one rank
(the torch idiom), and a ``RankMesh`` names the axes over the ranks of the
process group: ranks are numbered row-major over the axes in the order
given, so with ``build_two_tier_mesh`` (``dcn`` first) a rank is
``dcn_index * n_data + data_index`` and owns the batch rows the
reference's ``P((dcn, data))`` gives that device.

For each axis the mesh holds one process group per line of ranks along
it (the ranks that differ only in that axis's coordinate).  Every rank
creates every group, in the same order, when the mesh is built with the
process group initialized: ``torch.distributed.new_group`` must be
entered by all ranks alike.  Axes of size 1 get no group.

Axis convention: ``data`` (DP), ``model`` (TP), ``seq``, ``pipe``, ``dcn``
(cross-slice DP); absent axes have size 1.

Tensor parallelism of a generic network follows the reference's
``_shard_leaf`` rule: a leaf is split over ``model`` along its
trailing-most axis whose size divides by the ``model`` size and is at
least twice it, else replicated.  ``infer_param_shardings`` gives that
axis (or None) per leaf and ``local_shard`` this rank's slice of a leaf.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
DCN_AXIS = "dcn"


def _world() -> Tuple[int, int, bool]:
    """(world size, rank, initialized) of the default process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), True
    return 1, 0, False


class RankMesh:
    """Named axes over the ranks of the process group.

    ``shape`` maps axis → size (a dict in axis order, as ``Mesh.shape``);
    ``coords`` is this rank's index along each axis; ``group(axis)`` the
    process group of this rank's line along ``axis`` (None for an axis of
    size 1 or without an initialized process group)."""

    def __init__(self, axes: Dict[str, int], rank: int = 0, build_groups: bool = False):
        self.shape: Dict[str, int] = dict(axes)
        self.size = int(math.prod(self.shape.values()))
        self.rank = rank
        names = list(self.shape)
        idx, self.coords = rank, {}
        for name in reversed(names):
            self.coords[name] = idx % self.shape[name]
            idx //= self.shape[name]
        self.coords = {n: self.coords[n] for n in names}
        self._groups: Dict[str, object] = {}
        if build_groups:
            self._build_groups()

    def _line(self, axis: str, coords: Dict[str, int]) -> List[int]:
        """Ranks along ``axis`` through ``coords``, in axis order."""
        out = []
        for i in range(self.shape[axis]):
            c = dict(coords, **{axis: i})
            r = 0
            for name in self.shape:
                r = r * self.shape[name] + c[name]
            out.append(r)
        return out

    def _build_groups(self) -> None:
        import torch.distributed as dist

        names = list(self.shape)
        for axis in names:
            if self.shape[axis] == 1:
                continue
            others = [n for n in names if n != axis]
            for combo in itertools.product(*(range(self.shape[n]) for n in others)):
                ranks = self._line(axis, dict(zip(others, combo), **{axis: 0}))
                g = dist.new_group(ranks)          # every rank enters every call
                if self.rank in ranks:
                    self._groups[axis] = g

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank})"


def build_mesh(axes: Optional[Dict[str, int]] = None,
               world_size: Optional[int] = None) -> RankMesh:
    """A mesh from {axis_name: size} over the ranks of the process group
    (``world_size`` of them; default: the group's size, or 1 without an
    initialized group).  Default axes: every rank on ``data``.  Sizes
    must multiply to the rank count; -1 marks one inferred axis."""
    world, rank, initialized = _world()
    n = world if world_size is None else int(world_size)
    axes = dict(axes) if axes else {DATA_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(math.prod(s for s in sizes if s != -1))
        sizes[sizes.index(-1)] = n // known
    if int(math.prod(sizes)) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {n} devices")
    live = initialized and n == world
    return RankMesh(dict(zip(names, sizes)), rank if live else 0, build_groups=live)


def build_two_tier_mesh(n_slices: int, axes: Optional[Dict[str, int]] = None,
                        world_size: Optional[int] = None) -> RankMesh:
    """Mesh with an OUTER ``dcn`` axis of ``n_slices`` plus inner axes
    (default: every remaining rank on ``data``).  ``dcn`` is first, so a
    slice's ranks are consecutive.  Pair with
    ``ShardedTrainer(grad_compression=...)`` to compress the cross-slice
    gradient exchange."""
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    inner = dict(axes) if axes else {DATA_AXIS: -1}
    if DCN_AXIS in inner:
        raise ValueError("pass the dcn size as n_slices, not in axes")
    return build_mesh({DCN_AXIS: n_slices, **inner}, world_size)


def surviving_mesh(alive_slices, n_slices: int, axes: Optional[Dict[str, int]] = None,
                   world_size: Optional[int] = None) -> RankMesh:
    """A two-tier mesh over the ranks of the SURVIVING slices only: when a
    slice leaves, the job goes on over a smaller ``dcn`` axis instead of
    waiting for the whole pod.  ``alive_slices`` index the ORIGINAL
    ``n_slices`` slices of ``world_size`` ranks (default: the process
    group holds the survivors already, ``distributed.reinitialize``,
    so ``world_size`` is its size scaled back to ``n_slices``).  Restore
    the newest checkpoint after rebuilding (``ElasticTrainer(rebuild_fn=)``
    does both)."""
    alive = sorted(set(int(s) for s in alive_slices))
    world, _, _ = _world()
    if world_size is None:
        world_size = world * n_slices // max(1, len(alive))
    if n_slices < 1 or world_size % n_slices:
        raise ValueError(f"{world_size} devices not divisible into "
                         f"{n_slices} slices")
    if not alive:
        raise ValueError("no surviving slices — nothing to rebuild on")
    if alive[0] < 0 or alive[-1] >= n_slices:
        raise ValueError(f"alive slices {alive} out of range "
                         f"[0, {n_slices})")
    per = world_size // n_slices
    return build_two_tier_mesh(len(alive), axes, world_size=len(alive) * per)


def shard_axis(shape, msize: int, min_size: int = 2) -> Optional[int]:
    """The reference's ``_shard_leaf`` rule for one leaf of ``shape`` on
    a ``model`` axis of ``msize``: the trailing-most axis whose size
    divides by ``msize`` and is at least ``min_size`` times it (the
    weights are [in, out] / HWIO, so the output features come first),
    else None (replicated)."""
    if msize <= 1 or len(shape) == 0:
        return None
    for ax in reversed(range(len(shape))):
        if shape[ax] % msize == 0 and shape[ax] >= msize * min_size:
            return ax
    return None


def infer_param_shardings(params, mesh: RankMesh, model_axis: str = MODEL_AXIS):
    """The params tree with each leaf replaced by the axis it is split on
    over ``model_axis`` (``shard_axis``), or None where it is replicated."""
    msize = mesh.shape.get(model_axis, 1)
    if isinstance(params, dict):
        return {k: infer_param_shardings(v, mesh, model_axis) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(infer_param_shardings(v, mesh, model_axis) for v in params)
    return shard_axis(tuple(params.shape), msize)


def local_shard(t, axis: Optional[int], n: int, index: int):
    """Rank ``index``'s contiguous copy of ``t`` split ``n`` ways on
    ``axis`` (``t`` itself when ``axis`` is None)."""
    if axis is None or n == 1:
        return t
    return t.chunk(n, dim=axis)[index].contiguous()
