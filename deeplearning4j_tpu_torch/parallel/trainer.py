"""ShardedTrainer — data-parallel training over ``torch.distributed``, with
the reference's compressed two-tier gradient exchange (mirrors
``deeplearning4j_tpu/parallel/trainer.py``).

One process per rank, each holding a replica of the network.  A step:

  1. each rank takes its rows of the global batch (ranks are numbered
     ``dcn``-major, so a rank's rows are the rows the reference's
     ``P((dcn, data))`` gives that device) and computes its loss and
     gradients;
  2. ``grad_compression=None``: the flat gradient is all-reduced over
     every rank and divided by the rank count (the dense path);
     ``"threshold"``/``"bitmap"``: tier 1 all-reduces it over the ``data``
     group and divides by its size; tier 2 adds this slice's
     error-feedback residual, cuts the sum into buckets and encodes them
     into one wire buffer (``ops/compression.py``: with a fixed threshold
     one launch of kernel K6 on the card encodes every bucket),
     all-gathers the ENCODED buffers over the ``dcn`` group in one call,
     decode-sums them in rank order and divides by the slice count; the
     part of the sum this slice did not send is its next residual;
  3. the network's own ``_apply_updates`` (normalization, updater, K4),
     and the layers' new state (BatchNormalization's running statistics,
     a center-loss head's centres) replaces the old.

Batch statistics follow the reference's two programs.  The dense path
takes them over the GLOBAL batch, as the reference's one program over a
sharded batch does: for the length of the step the trainer sets
``normalization.global_batch``, so BatchNormalization's moments and the
centres' class sums are all-reduced across the ranks in the forward (an
autograd function whose backward all-reduces the gradient, so each
rank's gradient carries the other ranks' share of the moments).  The
compressed path normalizes each rank's rows by their own moments and
then averages every float leaf of the new state over all ranks, as the
reference's ``pmean`` over both data axes does.  Each rank draws its own
dropout and weight noise: a rank's generator is seeded from the
configuration's seed and its data-parallel index (rank 0 keeps the
seed), where the reference folds the device index into its key.  TBPTT
runs on the dense path chunk by chunk, each chunk's gradient exchanged
and applied; it raises with ``grad_compression``, as the reference's
does.

Every rank decodes the same gathered bytes in the same order, so the
replicas stay bitwise equal.  The backend: NCCL when each rank has a
card, gloo when ranks share one or run on the CPU (the trainer passes
gloo the CUDA tensors; gloo copies them through host memory itself).

The residual lives on the trainer, one flat f32 buffer per rank (its
slice's).  ``save`` gathers the slices' residuals over the ``dcn`` group
into the checkpoint's ``grad_residual.npz`` (leading axis = slice
count, the reference's layout); a trainer built on a network loaded
from such a checkpoint adopts its slice when the slice count matches.

``nan_guard=budget`` arms the network's divergence guard on every rank:
a step whose loss or gradient is not finite on ANY rank (one MIN
all-reduce of each rank's flag) applies no update on every rank, and on
the compressed path leaves the residual as it was too, so the replicas
stay equal and the poisoned gradient is not carried into the next step.
The budget is the network's (``set_nan_guard``, ``DivergenceError``).

A ``model`` axis splits every parameter of a ``MultiLayerNetwork`` or a
``ComputationGraph`` (each vertex's leaves) by the reference's
``_shard_leaf`` rule (``mesh.infer_param_shardings``):
a rank keeps only its slice of each split leaf, and of its updater
state, between steps.  A step all-gathers the slices over ``model``,
runs the forward and backward on the whole parameters (the ranks of a
``model`` line take the same rows, as the devices of the reference's
GSPMD program see the same batch), averages the gradient over the
data-parallel ranks, and each rank applies the updater to its slices
(K4, when switched on, runs over each layer's slices): per-layer
gradient normalization and clipping take each layer's squared norm
summed over ``model``, and a layer's constraints see its gathered
parameters.  ``output`` and ``save`` gather.  ``pipeline_schedule`` is
forwarded to a network with a ``schedule`` attribute (a
``ShardedTransformerLM``) and ignored otherwise, as in the reference;
``seq`` and ``pipe`` axes belong to ``ShardedTransformerLM``.

For the elastic runtime (``parallel/elastic.py``): ``_snapshot_state``
gathers the whole parameters, updater state and every slice's residual
(a collective: every rank takes the snapshot, the writer writes it), and
``_place_model`` re-slices restored whole parameters and updater state
for the ``model`` axis and re-adopts the restored residual.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..nn.layers import normalization
from ..nn.updaters import (GradientNormalization, _sq_norm, normalize_gradients,
                           tree_leaves, tree_map)
from ..obs import trace as obs_trace
from ..ops import compression as C
from ..optimize.score import LazyScore
from .collectives import Axis, all_gather, all_reduce
from .distributed import detect_num_slices, process_count
from .mesh import (DATA_AXIS, DCN_AXIS, MODEL_AXIS, RankMesh, build_mesh,
                   build_two_tier_mesh, infer_param_shardings, local_shard)
from .pipeline import SCHEDULES

Tensor = torch.Tensor


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) of a tensor over the data-parallel ranks (every
    rank, or the ``groups`` in turn), in autograd: the backward
    all-reduces the incoming gradient, since every rank's loss depends on
    every rank's share of the sum."""

    @staticmethod
    def forward(ctx, t: Tensor, groups=None) -> Tensor:
        import torch.distributed as dist

        ctx.groups = groups
        out = t.clone(memory_format=torch.contiguous_format)
        for g in groups or [None]:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        import torch.distributed as dist

        g = g.clone(memory_format=torch.contiguous_format)
        for grp in ctx.groups or [None]:
            dist.all_reduce(g, group=grp)
        return g, None


def _rank_seed(seed: int, dp_index: int) -> int:
    """The generator seed of data-parallel rank ``dp_index`` (rank 0 keeps
    the configuration's)."""
    return (int(seed) + dp_index * 0x9E3779B97F4A7C15) % (1 << 63)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Where one rank's rows of a global batch go: rows ``[index * per,
    (index + 1) * per)`` of every field (``per = rows // size``), on
    ``device``.  ``DevicePrefetchIterator(sharding=trainer.batch_sharding)``
    copies only these rows and marks the batch, and the trainer passes a
    batch so marked through its row split."""

    index: int
    size: int
    device: str

    def local_rows(self, batch):
        """This rank's rows of a DataSet, or of a tree (tuple / list /
        dict) of arrays or tensors."""
        def cut(a):
            if a is None:
                return None
            if isinstance(a, dict):
                return {k: cut(v) for k, v in a.items()}
            if isinstance(a, (list, tuple)):
                return type(a)(cut(v) for v in a)
            n = a.shape[0]
            if n % self.size:
                raise ValueError(
                    f"global batch {n} not divisible by data axis {self.size} "
                    "(pad or drop the remainder)")
            per = n // self.size
            return a[self.index * per:(self.index + 1) * per]
        if isinstance(batch, DataSet):
            return DataSet(cut(batch.features), cut(batch.labels),
                           cut(batch.features_mask), cut(batch.labels_mask))
        return cut(batch)


class ShardedTrainer:
    """Wraps a ``MultiLayerNetwork`` for data-parallel training.

    >>> distributed.initialize(init_method="file:///tmp/rdv", num_processes=4, process_id=r)
    >>> trainer = ShardedTrainer.two_tier(net, 2, grad_compression="threshold")
    >>> trainer.fit(batches, epochs=2)

    Every rank passes the same global batch; each takes its rows (the
    ranks of a ``model`` line take the same rows)."""

    @classmethod
    def two_tier(cls, net, n_slices: Optional[int] = None,
                 axes: Optional[dict] = None, **kwargs) -> "ShardedTrainer":
        """A trainer over ``build_two_tier_mesh``; ``n_slices`` defaults to
        ``distributed.detect_num_slices()``.  Keyword arguments pass through."""
        if n_slices is None:
            n_slices = detect_num_slices()
        return cls(net, build_two_tier_mesh(n_slices, axes), **kwargs)

    def __init__(self, net, mesh: Optional[RankMesh] = None,
                 data_axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS,
                 pipeline_schedule: str = "gpipe",
                 grad_compression: Optional[str] = None,
                 dcn_axis: str = DCN_AXIS,
                 compression_threshold: Optional[float] = None,
                 compression_bucket_mb: float = 4.0,
                 nan_guard: Optional[int] = None):
        if pipeline_schedule not in SCHEDULES:
            raise ValueError(f"pipeline_schedule must be one of {SCHEDULES}, "
                             f"got {pipeline_schedule!r}")
        if grad_compression is not None and grad_compression not in C.METHODS:
            raise ValueError(
                f"grad_compression must be one of {C.METHODS} or "
                f"None, got {grad_compression!r}")
        self.net = net
        self.mesh = mesh if mesh is not None else build_mesh()
        self.data_axis, self.dcn_axis, self.model_axis = data_axis, dcn_axis, model_axis
        self.grad_compression = grad_compression
        self.compression_threshold = compression_threshold
        self.compression_bucket_bytes = max(4, int(compression_bucket_mb * (1 << 20)))
        shape = self.mesh.shape
        if grad_compression is not None:
            if dcn_axis not in shape:
                raise ValueError(
                    f"grad_compression={grad_compression!r} needs a "
                    f"{dcn_axis!r} mesh axis (build_two_tier_mesh) — got "
                    f"axes {dict(shape)}")
            for ax, size in shape.items():
                if ax not in (dcn_axis, data_axis) and size > 1:
                    raise ValueError(
                        f"grad_compression composes with dcn×data parallelism "
                        f"only (axis {ax!r} has size {size}); drop the axis "
                        "or run grad_compression=None")
        for ax, size in shape.items():
            if ax not in (dcn_axis, data_axis, model_axis) and size > 1:
                raise NotImplementedError(
                    f"mesh axis {ax!r} (size {size}): a network trains over the "
                    "data, dcn and model axes; sequence and pipeline parallelism "
                    "run in ShardedTransformerLM")
        # microbatch order for a network that pipelines over a pipe axis
        # (ShardedTransformerLM); a layer stack without one ignores it
        self.pipeline_schedule = pipeline_schedule
        if hasattr(net, "schedule"):
            net.schedule = pipeline_schedule
        self.n_model = shape.get(model_axis, 1)
        if self.mesh.size != process_count():
            raise RuntimeError(
                f"the mesh spans {self.mesh.size} ranks but the process group has "
                f"{process_count()}: call distributed.initialize() in every rank "
                "before building the mesh")
        self.n_data = shape.get(data_axis, 1)
        self.n_dcn = shape.get(dcn_axis, 1)
        self.dp_size = self.n_data * self.n_dcn
        self.dp_index = (self.mesh.coords.get(dcn_axis, 0) * self.n_data
                         + self.mesh.coords.get(data_axis, 0))
        self.nan_guard = nan_guard
        if nan_guard is not None:
            if nan_guard < 1:
                raise ValueError(f"nan_guard budget must be >= 1, got {nan_guard}")
            net.set_nan_guard(nan_guard)
        self.bucketer = C.GradBucketer(net.params, self.compression_bucket_bytes)
        #: per-layer trees of the dim each leaf is split on over ``model``
        #: (None: replicated); every leaf None without a model axis
        self.shardings = infer_param_shardings(net.params, self.mesh, model_axis)
        self._model = self._dp_groups = None
        if self.n_model > 1:
            self._model = Axis(self.mesh, model_axis)
            self._dp_groups = [self.mesh.group(a) for a in (data_axis, dcn_axis)
                               if shape.get(a, 1) > 1]
        #: bytes this rank received from the other slices in the last step's
        #: tier-2 gather (the compressed path's wire)
        self.wire_bytes_last_step = 0
        #: (selection count, k) of each bucket in the last step's
        #: fixed-threshold encode; a bucket whose count exceeds k went to
        #: the top-k pack (empty for the other modes)
        self.last_bucket_counts: List[tuple] = []
        self._residual: Optional[Tensor] = None
        #: this rank's rows of a global batch (a prefetcher's ``sharding=``)
        self.batch_sharding = BatchSharding(self.dp_index, self.dp_size, str(net.device))
        self._place_model()
        if self.dp_index:
            net._gen.manual_seed(_rank_seed(net.conf.seed, self.dp_index))

    # -- placement -----------------------------------------------------------

    def _place_model(self) -> None:
        """Put the network's WHOLE parameters and updater state (at
        construction, or restored from a checkpoint) on this rank's mesh:
        its slices of each split leaf over ``model``; and this slice's
        residual, adopted from ``net.grad_residual`` when it matches."""
        net = self.net
        if self.n_model > 1:
            full = net.params
            net.params = self._slices(full)
            net.opt_state = self._map_layers(
                lambda k, os_, p, sp: self._layer_state_slices(os_, p, sp),
                net.opt_state, full, self.shardings)
            self.bucketer.template = net.params      # structure only
        if self.grad_compression is not None:
            self._place_residual()

    def _snapshot_state(self):
        """(params, state, opt_state, residual), whole: the parameters and
        updater state gathered over ``model``, every slice's residual over
        ``dcn``.  A collective: every rank calls it (the elastic
        checkpoint's snapshot)."""
        residual = self.gather_residual()
        if self._model is None:
            return self.net.params, self.net.state, self.net.opt_state, residual
        return self.gather_params(), self.net.state, self._gather_opt_state(), residual

    # -- the model axis ------------------------------------------------------

    def _map_layers(self, fn, *trees):
        """``fn(key, *layer_subtrees)`` over per-layer trees (a list of
        layers, or a ComputationGraph's dict of vertices), same container."""
        first = trees[0]
        if isinstance(first, dict):
            return {k: fn(k, *(t[k] for t in trees)) for k in first}
        return [fn(i, *(t[i] for t in trees)) for i in range(len(first))]

    def _layers(self) -> dict:
        """key → layer of every layer (vertex) of the network."""
        if isinstance(self.net.params, dict):
            from ..nn.graph import _layer_of

            return {s.name: _layer_of(s) for s in self.net.conf.vertices}
        return dict(enumerate(self.net.conf.layers))

    def _slices(self, tree):
        """This rank's slices of a params-shaped tree (per-layer dicts)."""
        n, i = self.n_model, self.mesh.coords.get(self.model_axis, 0)
        return self._map_layers(
            lambda k, layer, spec: tree_map(lambda t, a: local_shard(t, a, n, i), layer, spec)
            if layer else layer, tree, self.shardings)

    def _layer_state_slices(self, os_, params, spec):
        """A layer's updater state sliced like its parameters (each subtree
        shaped like them: Adam's m and v, a momentum); the rest as is."""
        if not os_:
            return os_
        struct = [tuple(t.shape) for t in tree_leaves(params)]
        n, i = self.n_model, self.mesh.coords.get(self.model_axis, 0)
        return {k: tree_map(lambda t, a: local_shard(t, a, n, i), v, spec)
                if isinstance(v, dict) and [tuple(t.shape) for t in tree_leaves(v)] == struct
                else v for k, v in os_.items()}

    def _gather_layer(self, layer, spec):
        return tree_map(lambda t, a: t if a is None else all_gather(t, self._model, a),
                        layer, spec)

    def gather_params(self):
        """The network's whole parameters from every rank's slices (a
        collective over ``model``; the parameters themselves without one)."""
        if self._model is None:
            return self.net.params
        return self._map_layers(lambda k, l, sp: self._gather_layer(l, sp) if l else l,
                                self.net.params, self.shardings)

    def _gather_opt_state(self):
        def like(v, p):
            return (isinstance(v, dict) and [t.shape for t in tree_leaves(v)]
                    == [t.shape for t in tree_leaves(p)])

        return self._map_layers(
            lambda key, os_, p, sp: {k: self._gather_layer(v, sp) if like(v, p) else v
                                     for k, v in os_.items()} if os_ else os_,
            self.net.opt_state, self.net.params, self.shardings)

    @contextlib.contextmanager
    def _whole(self, opt_state: bool = False):
        """The network holds its whole parameters (and, with
        ``opt_state``, updater state) for the body, its slices again
        after; a collective over ``model`` (a no-op without one)."""
        net = self.net
        if self._model is None:
            yield
            return
        sliced_p, sliced_o = net.params, net.opt_state
        whole_p = self.gather_params()
        if opt_state:
            net.opt_state = self._gather_opt_state()
        net.params = whole_p
        try:
            yield
        finally:
            net.params, net.opt_state = sliced_p, sliced_o

    def _sq_norms(self, spec):
        """Per-leaf squared norms of a layer's gradient slices, each split
        leaf's summed over ``model`` (one all-reduce a layer)."""
        split = [a is not None for a in tree_leaves(spec)]

        def norms(leaves):
            sq = [_sq_norm(g) for g in leaves]
            if any(split):
                summed = all_reduce(torch.stack([q for q, s in zip(sq, split) if s]),
                                     self._model)
                it = iter(summed)
                sq = [next(it) if s else q for q, s in zip(sq, split)]
            return sq

        return norms

    def _apply_sharded(self, grads, params, opt_state, it):
        """``_apply_updates`` over this rank's slices: each layer's whole
        averaged gradient is cut to the slices, normalized with norms
        summed over ``model``, and the updater steps the slices; a layer's
        constraints see its gathered parameters."""
        from ..nn.conf.regularizers import apply_constraints

        net, conf = self.net, self.net.conf
        layers = self._layers()

        def one(key, g, p, os_, spec):
            layer = layers.get(key)
            if layer is None or not p:
                return p, os_
            if conf.gradient_normalization != GradientNormalization.NONE:
                g = normalize_gradients(g, conf.gradient_normalization,
                                        conf.gradient_normalization_threshold,
                                        sq_norms=self._sq_norms(spec))
            p2, os2 = net._updater_for(layer).apply(p, g, os_, it)
            if layer.constraints:
                whole = apply_constraints(layer.constraints, self._gather_layer(p2, spec))
                p2 = tree_map(lambda t, a: local_shard(t, a, self.n_model, self._model.index),
                              whole, spec)
            return p2, os2

        pairs = self._map_layers(one, self._slices(grads), params, opt_state, self.shardings)
        if isinstance(pairs, dict):
            return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
        return [v[0] for v in pairs], [v[1] for v in pairs]

    # -- collectives -------------------------------------------------------

    def _dp_mean(self, t: Tensor) -> Tensor:
        """Mean of ``t`` over the data-parallel ranks (every rank without a
        ``model`` axis; the ``data`` then the ``dcn`` line with one)."""
        if self._model is None:
            return self._all_reduce_mean(t, None)
        return self._all_reduce_mean(self._all_reduce_mean(t, self.data_axis), self.dcn_axis)

    def _all_reduce_mean(self, t: Tensor, axis: Optional[str]) -> Tensor:
        """Mean of ``t`` over ``axis``'s group (None: every rank)."""
        import torch.distributed as dist

        size = self.mesh.size if axis is None else self.mesh.shape.get(axis, 1)
        if size == 1:
            return t
        t = t.contiguous()
        dist.all_reduce(t, group=None if axis is None else self.mesh.group(axis))
        return t / size

    def _gather(self, t: Tensor, axis: str) -> Tensor:
        """[P, *t.shape]: ``t`` of every rank along ``axis``, in rank order."""
        if self.mesh.shape.get(axis, 1) == 1:
            return t[None]
        return C.all_gather_stack(t, self.mesh.group(axis))

    # -- residual ----------------------------------------------------------

    def _place_residual(self) -> None:
        """This slice's error-feedback residual as one flat f32 buffer:
        adopted from ``net.grad_residual`` (a checkpoint's, leading axis =
        slice count) when its slice count matches, else zeros (error
        feedback only defers compression error, so dropping it costs one
        step's deferral).  ``net.grad_residual`` is then cleared: the live
        residual is the trainer's (``gather_residual``, ``save``)."""
        net = self.net
        existing = getattr(net, "grad_residual", None)
        leaves = C.flat_leaves(existing) if existing is not None else []
        if leaves and all(l.shape[0] == self.n_dcn for l in leaves):
            mine = self.mesh.coords.get(self.dcn_axis, 0)
            flat = torch.cat([l[mine].reshape(-1).float() for l in leaves])
            self._residual = flat.to(net.device)
        else:
            self._residual = torch.zeros(self.bucketer.total, dtype=torch.float32,
                                         device=net.device)
        net.grad_residual = None

    def gather_residual(self):
        """Every slice's residual as one params-shaped tree of f32 tensors
        with a leading axis of the slice count (the checkpoint layout).
        A collective: every rank calls it."""
        if self._residual is None:
            return None
        stacked = self._gather(self._residual, self.dcn_axis)        # [n_dcn, total]
        per = [C.flat_leaves(self.bucketer.unflat(row, cast=False)) for row in stacked]
        return C.rebuild(self.net.params, [torch.stack(ls) for ls in zip(*per)])

    def save(self, path: str, save_updater: bool = True) -> None:
        """Write the network, with the gathered residual when compressed,
        as a checkpoint zip from rank 0.  A collective: every rank calls it
        and returns once rank 0 has written."""
        import torch.distributed as dist

        from ..utils.serializer import save_model

        residual = self.gather_residual()
        with self._whole(opt_state=True):
            if self.mesh.rank == 0:
                self.net.grad_residual = residual
                try:
                    save_model(self.net, path, save_updater=save_updater)
                finally:
                    self.net.grad_residual = None
        if self.mesh.size > 1:
            dist.barrier()

    # -- batches -----------------------------------------------------------

    def _local(self, ds: DataSet) -> DataSet:
        """This rank's rows of the global batch (of each entry of dict
        labels); a batch a prefetcher already cut for this rank passes
        through."""
        if getattr(ds, "sharded_as", None) == self.batch_sharding:
            return ds
        return self.batch_sharding.local_rows(ds)

    def shard_dataset(self, ds: DataSet) -> DataSet:
        """A global batch placed on this rank's device once, so a batch
        reused across steps (a benchmark, an evaluation loop) pays the
        host-to-device copy once.  Every rank keeps the global rows, as
        ``fit_batch`` takes them; the row count must divide by the
        data-parallel ranks."""
        def put(a):
            if a is None:
                return None
            if isinstance(a, dict):
                return {k: put(v) for k, v in a.items()}
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            if t.shape[0] % self.dp_size:
                raise ValueError(
                    f"global batch {t.shape[0]} not divisible by data axis "
                    f"{self.dp_size} (pad or drop the remainder)")
            return t.to(self.net.device)
        return DataSet(put(ds.features), put(ds.labels), put(ds.features_mask),
                       put(ds.labels_mask))

    # -- training ----------------------------------------------------------

    def _exchange(self, flat: Tensor) -> Tensor:
        """The mean gradient over the data-parallel ranks from this rank's
        flat gradient; on the compressed path also the next residual."""
        if self.grad_compression is None:
            return self._dp_mean(flat)
        flat = self._all_reduce_mean(flat, self.data_axis)           # tier 1
        acc = flat + self._residual                                   # tier 2

        def gather(wire):
            out = self._gather(wire, self.dcn_axis)
            self.wire_bytes_last_step = (out.shape[0] - 1) * wire.numel() * wire.element_size()
            return out

        means, local, self.last_bucket_counts = C.compressed_pmean(
            self.bucketer.split(acc), method=self.grad_compression,
            threshold=self.compression_threshold, gather=gather, with_counts=True)
        self._residual = acc - torch.cat(local)
        return torch.cat(means)

    def _mean_state(self, state: list) -> list:
        """Every float leaf of the layers' new state averaged over all the
        ranks, in one all-reduce (the compressed path)."""
        import torch.distributed as dist

        keys = list(state) if isinstance(state, dict) else range(len(state))
        leaves = [(i, k) for i in keys for k in sorted(state[i])
                  if state[i][k].is_floating_point()]
        if self.mesh.size == 1 or not leaves:
            return state
        dt = (torch.float64 if any(state[i][k].dtype == torch.float64 for i, k in leaves)
              else torch.float32)
        flat = torch.cat([state[i][k].reshape(-1).to(dt) for i, k in leaves])
        dist.all_reduce(flat)
        flat = flat / self.mesh.size
        out = ({i: dict(s) for i, s in state.items()} if isinstance(state, dict)
               else [dict(s) for s in state])
        off = 0
        for i, k in leaves:
            t = state[i][k]
            out[i][k] = flat[off:off + t.numel()].reshape(t.shape).to(t.dtype)
            off += t.numel()
        return out

    def _step(self, local: DataSet, carries=None):
        """One global step on this rank's rows → (the global-batch loss,
        the carries after it, the guard's flag or None)."""
        net = self.net
        guard = self.nan_guard is not None
        dense = self.grad_compression is None and self.dp_size > 1
        new_s = type(net.state)()
        global_sum = lambda t: _SumOverRanks.apply(t, self._dp_groups)  # noqa: E731
        with (normalization.global_batch(global_sum, self.dp_size) if dense
              else contextlib.nullcontext()), self._whole():
            loss, grads, carries = net._loss_and_grads(local, carries, state_out=new_s)
        ok = None
        with torch.no_grad():
            flat = self.bucketer.flat(grads)
            if guard:
                ok = self._all_finite(loss, flat)
                residual = self._residual
            mean = self._exchange(flat)
            if self.grad_compression is not None:
                new_s = self._mean_state(new_s)
            net._commit_step(self.bucketer.unflat(mean), new_s, ok,
                             apply_updates=None if self._model is None else self._apply_sharded)
            if guard and residual is not None:
                self._residual = torch.where(ok, self._residual, residual)
            if self.grad_compression is None:
                loss = self._dp_mean(loss.reshape(1))
            else:
                loss = self._all_reduce_mean(self._all_reduce_mean(
                    loss.reshape(1), self.data_axis), self.dcn_axis)
        return loss.reshape(()), carries, ok

    def fit_batch(self, ds: DataSet) -> LazyScore:
        """One global step: this rank's rows, the gradient exchange, the
        update (one per chunk under TBPTT).  Returns the global-batch loss
        (the mean over ranks) as a ``LazyScore``."""
        net = self.net
        if net.conf.backprop_type == "tbptt":
            if self.grad_compression is not None:
                raise NotImplementedError(
                    "grad_compression does not compose with TBPTT yet — the "
                    "chunk steps apply updates inside the step; run "
                    "grad_compression=None")
            if self.nan_guard is not None:
                raise NotImplementedError(
                    "the nan guard does not compose with TBPTT yet; run "
                    "nan_guard=None")
            return net._fit_batch_tbptt(self._local(ds), step=self._step)
        if self.grad_compression is None:
            loss, _, ok = self._step(self._local(ds))
        else:
            # one span for the step: the two-tier exchange (all-reduce, then
            # the threshold-encoded gather) runs inside the dispatch
            with obs_trace.span("train/step", cat="train",
                                iteration=net.iteration + 1,
                                path="compressed_exchange"):
                with obs_trace.span("train/dispatch", cat="train"):
                    loss, _, ok = self._step(self._local(ds))
        if ok is not None:
            net._note_guarded_step(bool(ok))
        score = LazyScore(loss)
        net._fire(net.iteration, score)
        return score

    def _all_finite(self, loss: Tensor, flat: Tensor) -> Tensor:
        """0-dim bool: this step's loss and gradient are finite on every
        rank (a MIN all-reduce of each rank's flag)."""
        import torch.distributed as dist

        ok = (torch.isfinite(loss) & torch.isfinite(flat).all()).to(torch.int32).reshape(1)
        if self.mesh.size > 1:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return ok[0] > 0

    def fit_batches(self, batches) -> List[LazyScore]:
        """One ``fit_batch`` per batch (the residual threads through every
        exchange, as in the reference's compressed route)."""
        return [self.fit_batch(ds) for ds in batches]

    def fit(self, data, epochs: int = 1) -> List[LazyScore]:
        """Train on a DataSet, an ``(x, y)`` pair or a list of DataSets for
        ``epochs`` passes, as ``MultiLayerNetwork.fit`` does (the network's
        listeners fire per step and per epoch)."""
        if isinstance(data, DataSet):
            data = [data]
        elif isinstance(data, tuple) and len(data) == 2:
            data = [DataSet(data[0], data[1])]
        if epochs > 1 and iter(data) is data:
            raise ValueError("fit(epochs > 1) needs data it can iterate again, "
                             "e.g. a list of DataSets, not a one-shot iterator")
        losses: List[LazyScore] = []
        synced = 0
        for _ in range(epochs):
            for ds in data:
                losses.append(self.fit_batch(ds))
            synced = self.net._end_epoch(losses, synced)
        return losses

    def output(self, x, **kw) -> Tensor:
        """Inference on this rank's replica (the parameters are equal on
        every rank; with a ``model`` axis gathered first, a collective)."""
        with self._whole():
            return self.net.output(x, **kw)
