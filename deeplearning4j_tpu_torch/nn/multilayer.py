"""MultiLayerNetwork — the sequential-stack model container (mirrors
``deeplearning4j_tpu/nn/multilayer.py``: configuration and input
preprocessors, ``init``, ``output``, ``feed_forward``, ``score``,
``score_examples``, ``evaluate``, training through ``fit_batch`` / ``fit``
/ ``fit_batches`` with standard backprop or TBPTT, the opt-in nan guard,
layerwise pretraining, listeners, and streaming through
``rnn_time_step``).

Parameters are a list of per-layer dicts of tensors keyed as in the JAX
trees; ``opt_state`` is the list of per-layer updater states (``{}`` for
a layer without parameters).  One training step is the reference's:
loss (output layer + L1/L2) → gradients by autograd → per-layer gradient
normalization → per-layer updater ``apply`` → the layer's constraints.
The update builds new tensors rather than writing in place, as the
reference's pure step does.  Dropout, weight noise and stochastic
preprocessors draw from the network's ``torch.Generator`` (on its
device, seeded with ``conf.seed``).  Recurrent layers thread a carry
(``carries``, one entry per layer) through TBPTT chunks and streaming
calls.  On the card ``fit_batches`` is one CUDA graph of its k steps
(``nn/train_graph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

import logging

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator, ListDataSetIterator
from ..obs import trace as obs_trace
from ..ops.dtypes import canonical_dtype
from ..optimize.score import LazyScore, materialize_scores
from ..utils.device import DeviceLike, resolve_device
from .conf.inputs import InputType
from .conf.preprocessors import (CnnToFeedForward, CnnToRnn, FeedForwardToCnn,
                                 Preprocessor)
from .conf.regularizers import apply_constraints, maybe_weight_noise
from .layers.base import AUX_LOSS_KEY, Layer, config_from_dict, config_to_dict, tree_apply
from .updaters import (Adam, GradientNormalization, Updater,
                       normalize_gradients, tree_leaves, tree_unflatten)

Tensor = torch.Tensor


class DivergenceError(RuntimeError):
    """The opt-in nan guard spent its budget: more consecutive steps than
    the budget produced a non-finite loss or gradient, so skipping updates
    no longer masks a transient but a diverged run.  The message carries
    the "non-finite gradient" marker the reference's elastic trainer
    recognizes."""

    def __init__(self, bad_steps: int, budget: int):
        super().__init__(
            f"non-finite gradients for {bad_steps} consecutive steps "
            f"(budget {budget}) — updates were skipped but the run is "
            "diverging; restore a checkpoint (ElasticTrainer recovers this "
            "automatically) or lower the learning rate")
        self.bad_steps = bad_steps
        self.budget = budget


def _host(a):
    """A tensor or array as a numpy array (bfloat16 widened to float32)."""
    if isinstance(a, Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _ndim(labels) -> int:
    """The rank of a label array; 0 for a dict of label arrays (the
    ``Yolo2OutputLayer`` targets)."""
    return getattr(labels, "ndim", 0)


def _stack_field(out: dict, key: str, vals: list, as_tensor) -> None:
    """``vals`` (one entry per batch: an array, a dict of arrays, or None)
    stacked on a new leading axis into ``out``: under ``key``, or under
    ``key/<name>`` for each entry of a dict (one static buffer per label
    leaf in a ``fit_batches`` graph)."""
    if any(v is None for v in vals):
        if not all(v is None for v in vals):
            raise ValueError("fit_batches needs uniform masks: all batches or none")
        out[key] = None
    elif isinstance(vals[0], dict):
        for k in sorted(vals[0]):
            out[f"{key}/{k}"] = torch.stack([as_tensor(v[k]) for v in vals])
    else:
        out[key] = torch.stack([as_tensor(v) for v in vals])


def _field_at(stacked: dict, key: str, i: int):
    """Batch ``i`` of the field ``_stack_field`` stored under ``key``."""
    if key in stacked:
        return None if stacked[key] is None else stacked[key][i]
    pre = key + "/"
    return {n[len(pre):]: t[i] for n, t in stacked.items() if n.startswith(pre)}


def _objective_and_grads(layer, params, feat: Tensor, generator):
    """A pretrainable layer's reconstruction objective on ``feat`` and its
    gradient (a tree shaped like ``params``), both detached."""
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = layer.reconstruction_score(tree_unflatten(params, live), feat,
                                          generator=generator, train=True)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def _detached(carry):
    """A layer's carry (a tensor, a tuple of tensors, or None) cut from the
    autograd graph."""
    if isinstance(carry, tuple):
        return tuple(t.detach() for t in carry)
    return None if carry is None else carry.detach()


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Configs-as-data for a sequential net; ``to_dict``/``from_dict``
    is the JSON contract a checkpoint's ``configuration.json`` carries."""

    layers: List[Layer] = dataclasses.field(default_factory=list)
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, Preprocessor] = dataclasses.field(default_factory=dict)
    updater: Any = dataclasses.field(default_factory=Adam)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    seed: int = 12345
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    backprop_type: str = "standard"
    tbptt_length: int = 20

    def to_dict(self) -> dict:
        d = config_to_dict(self)
        d["type"] = "MultiLayerConfiguration"
        d["preprocessors"] = {str(k): config_to_dict(v) for k, v in self.preprocessors.items()}
        d["input_type"] = None if self.input_type is None else self.input_type.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        d = dict(d)
        d.pop("type", None)
        pre = {int(k): config_from_dict(v) for k, v in (d.pop("preprocessors") or {}).items()}
        it = d.pop("input_type")
        layers = [config_from_dict(l) for l in d.pop("layers")]
        for l in layers:
            if not isinstance(l, Layer):
                raise ValueError(
                    f"layer type {l.get('type') if isinstance(l, dict) else l!r} "
                    "is not ported yet")
        return MultiLayerConfiguration(
            layers=layers,
            input_type=None if it is None else InputType.from_dict(it),
            preprocessors=pre,
            updater=config_from_dict(d.pop("updater")),
            **d,
        )


class ListBuilder:
    """Fluent builder (``NeuralNetConfiguration.builder()``)."""

    def __init__(self, **defaults):
        self._conf = MultiLayerConfiguration()
        self._defaults = defaults

    def seed(self, s: int) -> "ListBuilder":
        self._conf.seed = s
        return self

    def updater(self, u: Union[Updater, dict]) -> "ListBuilder":
        """An updater object, or its configuration dict as a checkpoint
        writes it (``{"type": "Adam", "lr": 3e-4, ...}``)."""
        self._conf.updater = config_from_dict(u) if isinstance(u, dict) else u
        return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0) -> "ListBuilder":
        self._conf.gradient_normalization = mode
        self._conf.gradient_normalization_threshold = threshold
        return self

    def layer(self, layer: Layer) -> "ListBuilder":
        for k, v in self._defaults.items():
            if hasattr(layer, k) and getattr(layer, k) == type(layer).__dataclass_fields__[k].default:
                setattr(layer, k, v)
        self._conf.layers.append(layer)
        return self

    def preprocessor(self, index: int, pre: Preprocessor) -> "ListBuilder":
        self._conf.preprocessors[index] = pre
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._conf.input_type = t
        return self

    def tbptt(self, length: int) -> "ListBuilder":
        """Truncated BPTT: ``fit_batch`` takes one optimizer step per
        ``length`` time steps, carrying recurrent state between chunks."""
        self._conf.backprop_type = "tbptt"
        self._conf.tbptt_length = length
        return self

    def dtype(self, param_dtype: str = "float32", compute_dtype: str = "float32") -> "ListBuilder":
        self._conf.param_dtype = param_dtype
        self._conf.compute_dtype = compute_dtype
        return self

    def build(self) -> MultiLayerConfiguration:
        return self._conf


class NeuralNetConfiguration:
    @staticmethod
    def builder(**defaults) -> ListBuilder:
        return ListBuilder(**defaults)


class MultiLayerNetwork:
    """Sequential model on one device: ``init`` / ``output`` / ``score``
    / ``fit_batch`` / ``fit`` / ``fit_batches`` / ``evaluate`` / ``save``.

    ``device`` defaults to ``cuda`` and raises without a card unless
    ``device="cpu"`` is passed.  ``grad_residual`` holds a checkpoint's
    error-feedback residual (one tree shaped like ``params`` with a
    leading slice axis) until a ``parallel.ShardedTrainer`` adopts it, and
    ``save`` writes it back."""

    def __init__(self, conf: MultiLayerConfiguration, device: DeviceLike = None):
        self.conf = conf
        self.device = resolve_device(device)
        for name in (conf.param_dtype, conf.compute_dtype):
            canonical_dtype(name)   # an unknown dtype name raises here
        self.params: List[Dict[str, Tensor]] = []
        self.state: List[Dict[str, Tensor]] = []
        self.opt_state: List[Dict] = []
        self.iteration = 0
        self._it_dev: Optional[Tensor] = None   # iteration as an f32 on the device
        self._it_dev_val = -1                   # the value _it_dev holds
        self.epoch = 0
        self.listeners: List[Any] = []
        self.grad_residual: Optional[List[Dict[str, Tensor]]] = None
        self._stream_carries: Optional[List[Any]] = None   # rnn_time_step state
        self._nan_guard_budget: Optional[int] = None
        self._bad_steps = 0
        #: captured fit_batches graphs, by (k, batch shapes and dtypes)
        self._fit_graphs: Dict[tuple, Any] = {}
        #: dropout, weight noise and stochastic preprocessors draw from this
        self._gen = torch.Generator(device=self.device).manual_seed(int(conf.seed))
        self.input_types: List[InputType] = []
        self._infer_types()

    def _compute_dtype(self) -> torch.dtype:
        return canonical_dtype(self.conf.compute_dtype)

    def _infer_types(self) -> None:
        """Propagate InputType through preprocessors and layers, inserting
        the shape adapter a layer's expected kind needs (the reference's
        pass)."""
        self.input_types = []
        t = self.conf.input_type
        if t is None:
            return
        for i, layer in enumerate(self.conf.layers):
            if i in self.conf.preprocessors:
                t = self.conf.preprocessors[i].output_type(t)
            elif layer.wants is not None and t.kind != layer.wants:
                pre = None
                if t.kind == "cnn" and layer.wants == "ff":
                    pre = CnnToFeedForward()
                elif t.kind == "cnn_flat" and layer.wants == "cnn":
                    pre = FeedForwardToCnn(t.height, t.width, t.channels)
                elif t.kind == "cnn_flat" and layer.wants == "ff":
                    t = InputType.feed_forward(t.flat_size())
                elif t.kind == "cnn" and layer.wants == "rnn":
                    pre = CnnToRnn()
                if pre is not None:
                    self.conf.preprocessors[i] = pre
                    t = pre.output_type(t)
            self.input_types.append(t)
            layer.infer_nin(t)
            t = layer.output_type(t)
        self.output_type = t

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw parameters from ``generator`` (default: a CPU generator
        seeded with ``conf.seed``) and move them to the device."""
        if not self.input_types:
            raise ValueError("conf.input_type must be set before init() "
                             "(or call set_input_type on the builder)")
        if generator is None:
            generator = torch.Generator().manual_seed(int(self.conf.seed))
        params, state = self._draw(generator)
        self.params = [tree_apply(lambda v: v.to(self.device), p) for p in params]
        self.state = [tree_apply(lambda v: v.to(self.device), s) for s in state]
        self.opt_state = self.init_opt_state(self.params)
        self.iteration = 0

    def _updater_for(self, layer: Layer) -> Updater:
        return layer.updater if layer.updater is not None else self.conf.updater

    def init_opt_state(self, params) -> List[Dict]:
        """Fresh per-layer updater state for ``params`` (zeros)."""
        return [self._updater_for(layer).init_state(p) if p else {}
                for layer, p in zip(self.conf.layers, params)]

    def _draw(self, generator: torch.Generator):
        """Per-layer (params, state) lists drawn from ``generator``."""
        dtype = canonical_dtype(self.conf.param_dtype)
        params = [layer.init_params(generator, t, dtype)
                  for layer, t in zip(self.conf.layers, self.input_types)]
        state = [layer.init_state(t, dtype)
                 for layer, t in zip(self.conf.layers, self.input_types)]
        return params, state

    def param_templates(self):
        """(params, state) with the structure and shapes ``init`` gives,
        as meta tensors: no weights are drawn (checkpoint loading)."""
        with torch.device("meta"):
            return self._draw(torch.Generator())

    def num_params(self) -> int:
        return sum(int(np.prod(x.shape)) for p in self.params for x in tree_leaves(p))

    def summary(self) -> str:
        """Layer table: index, layer, output type, parameter count."""
        if not self.params:
            raise ValueError("call init() before summary()")
        rows = [("idx", "layer", "out", "params")]
        for i, (layer, p) in enumerate(zip(self.conf.layers, self.params)):
            n = sum(int(np.prod(x.shape)) for x in tree_leaves(p))
            out = layer.output_type(self.input_types[i])
            rows.append((str(i), type(layer).__name__, str(out), f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(4)]
        lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(f"total params: {self.num_params():,}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # forward / loss
    # ------------------------------------------------------------------

    def _preprocess(self, i: int, x: Tensor, generator) -> Tensor:
        pre = self.conf.preprocessors.get(i)
        if pre is None:
            return x
        if pre.wants_rng and generator is not None:
            return pre.apply(x, generator)
        return pre.apply(x)

    def _apply_layers(self, params, state, x: Tensor, mask: Optional[Tensor], *,
                      train: bool = False, generator: Optional[torch.Generator] = None,
                      upto: Optional[int] = None, carries=None,
                      acts: Optional[list] = None, state_out: Optional[list] = None):
        """Forward through layers [0, upto) (all by default) → (y, mask,
        new_carries).  In training, ``generator`` feeds each layer's weight
        noise (applied here, before its forward), its input dropout and
        stochastic preprocessors, in the reference's order.  ``carries``
        (one entry per layer, or None for zero state) threads recurrent
        hidden state for TBPTT and streaming; ``acts`` collects each
        layer's output; ``state_out`` receives the per-layer state after
        the pass (BatchNormalization's running statistics in training;
        layers past ``upto`` keep theirs)."""
        # layers that need the compute dtype apart from their input's
        # (integer-id LSTM inputs) read it from this attribute
        for layer in self.conf.layers:
            layer._compute_dtype = self.conf.compute_dtype
        if x.is_floating_point():
            x = x.to(self._compute_dtype())
        n = len(self.conf.layers) if upto is None else upto
        new_carries = list(carries) if carries is not None else [None] * len(self.conf.layers)
        if state_out is not None:
            state_out[:] = list(state)
        for i in range(n):
            layer = self.conf.layers[i]
            x = self._preprocess(i, x, generator)
            kwargs = {"carry": carries[i]} if layer.recurrent and carries is not None else {}
            p_i = maybe_weight_noise(layer, params[i], train, generator)
            out = layer.forward(p_i, state[i], x, train=train, generator=generator,
                                mask=mask, **kwargs)
            x, mask = out.y, out.mask
            new_carries[i] = out.carry
            if state_out is not None:
                state_out[i] = out.state
            if acts is not None:
                acts.append(x)
        return x, mask, new_carries

    def _head_input(self, params, state, x, mask, *, train, generator, carries=None,
                    state_out=None):
        """The output layer's input: layers [0, n-1), its preprocessor and,
        in training, its input dropout → (h, mask, new_carries)."""
        n = len(self.conf.layers)
        h, mask_out, new_carries = self._apply_layers(
            params, state, x, mask, train=train, generator=generator, upto=n - 1,
            carries=carries, state_out=state_out)
        h = self._preprocess(n - 1, h, generator)
        if train and generator is not None:
            # output layers honor input dropout too (no-op without one)
            h = self.conf.layers[n - 1]._maybe_dropout(h, train, generator)
        return h, mask_out, new_carries

    def _reg_score(self, params, acc: torch.dtype) -> Tensor:
        reg = torch.zeros((), dtype=acc, device=self.device)
        for layer, p in zip(self.conf.layers, params):
            if p:
                reg = reg + layer.regularization_score(p).to(acc)
        return reg

    def _loss(self, params, state, x, labels, *, train: bool,
              generator: Optional[torch.Generator] = None,
              mask=None, label_mask=None, carries=None, state_out=None):
        """Full score: the output layer's loss plus every layer's L1/L2
        (accumulated in float64 when computing in float64, else float32)
        → (loss, new_carries); ``state_out`` as ``_apply_layers``'s.  In
        training a center-loss head's ``update_centers`` (on its detached
        input and labels) writes its new state, and the ``AUX_LOSS_KEY``
        term of any layer's new state joins the loss, as in the
        reference."""
        n = len(self.conf.layers)
        new_state = state_out if state_out is not None else []
        h, mask_out, new_carries = self._head_input(
            params, state, x, mask, train=train, generator=generator, carries=carries,
            state_out=new_state)
        last = self.conf.layers[n - 1]
        lm = label_mask if label_mask is not None else (
            mask_out if labels is not None and _ndim(labels) == 3 else None)
        if not hasattr(last, "score"):
            raise ValueError(f"last layer {type(last).__name__} has no score(); "
                             "use an output layer")
        loss = last.score(params[n - 1], state[n - 1], h, labels, mask=lm)
        if train and hasattr(last, "update_centers"):
            new_state[n - 1] = last.update_centers(state[n - 1], h.detach(),
                                                   tree_apply(Tensor.detach, labels))
        acc = torch.float64 if self._compute_dtype() == torch.float64 else torch.float32
        total = loss.to(acc) + self._reg_score(params, acc)
        if train:
            for s in new_state:
                if AUX_LOSS_KEY in s:
                    total = total + s[AUX_LOSS_KEY].to(acc)
        return total, new_carries

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _apply_updates(self, grads, params, opt_state, it: Tensor):
        """Per layer: gradient normalization, the updater's ``apply``
        (updater math + param step; Adam/Nadam take the fused kernel K4
        when ``DL4J_TPU_FUSED_UPDATE=1``), then the layer's constraints."""
        conf = self.conf
        new_params, new_opt = [], []
        for layer, g, p, os_ in zip(conf.layers, grads, params, opt_state):
            if not p:
                new_params.append(p)
                new_opt.append(os_)
                continue
            if conf.gradient_normalization != GradientNormalization.NONE:
                g = normalize_gradients(g, conf.gradient_normalization,
                                        conf.gradient_normalization_threshold)
            p2, os2 = self._updater_for(layer).apply(p, g, os_, it)
            if layer.constraints:
                p2 = apply_constraints(layer.constraints, p2)
            new_params.append(p2)
            new_opt.append(os2)
        return new_params, new_opt

    def _iter_tensor(self) -> Tensor:
        """``iteration`` as a 0-dim f32 on the device, kept there and
        advanced there, so a step reads it without a host copy."""
        if self._it_dev is None or self._it_dev_val != self.iteration:
            self._it_dev = torch.full((), float(self.iteration), dtype=torch.float32,
                                      device=self.device)
            self._it_dev_val = self.iteration
        return self._it_dev

    def _batch(self, ds: DataSet):
        return tuple(None if a is None else self._as_tensor(a)
                     for a in (ds.features, ds.labels, ds.features_mask, ds.labels_mask))

    def _as_tensor(self, a):
        """An array or tensor on the network's device (a dict of them, as
        ``Yolo2OutputLayer``'s labels, entry by entry)."""
        if isinstance(a, dict):
            return {k: self._as_tensor(v) for k, v in a.items()}
        # graftcheck: disable=GC101 (a tensor already on the device passes through uncopied; a capture hands it only the stacked batch's device slices)
        return torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a,
                               device=self.device)

    def _loss_and_grads(self, ds: DataSet, carries=None, state_out: Optional[list] = None):
        """The training loss on ``ds`` (dropout and weight noise drawn from
        the network's generator), its gradient with respect to every
        parameter (per-layer dicts shaped like ``params``) and the
        recurrent carries after it, detached: the next TBPTT chunk takes
        them as constants, as the reference differentiates each chunk on
        its own.  ``state_out`` receives the layers' state after the
        step's forward, detached (BatchNormalization's new running
        statistics)."""
        x, y, m, lm = self._batch(ds)
        live = [[t.detach().requires_grad_(True) for t in tree_leaves(p)]
                for p in self.params]
        params = [tree_unflatten(p, ls) for p, ls in zip(self.params, live)]
        with torch.enable_grad():
            loss, new_carries = self._loss(params, self.state, x, y, train=True,
                                           generator=self._gen, mask=m,
                                           label_mask=lm, carries=carries,
                                           state_out=state_out)
            flat = [t for ls in live for t in ls]
            # a FrozenLayer's parameters take no part: their gradient is
            # zero, and they pass through the updater as the reference's do
            gflat = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True) if flat else []
        grads, off = [], 0
        for p, ls in zip(self.params, live):
            grads.append(tree_unflatten(p, list(gflat[off:off + len(ls)])))
            off += len(ls)
        if state_out is not None:
            state_out[:] = [{k: v.detach() for k, v in s.items()} for s in state_out]
        return loss.detach(), grads, [_detached(c) for c in new_carries]

    @staticmethod
    def _grads_finite(loss: Tensor, grads) -> Tensor:
        """0-dim bool on the device: the loss and every gradient are finite."""
        ok = torch.isfinite(loss)
        for g in (t for layer in grads for t in tree_leaves(layer)):
            ok = ok & torch.isfinite(g).all()
        return ok

    @staticmethod
    def _select_tree(ok: Tensor, new, old):
        """``where(ok, new, old)`` leafwise: a skipped step keeps the OLD
        bits exactly (the NaNs of the rejected branch do not leak)."""
        out = [torch.where(ok, a, b) for a, b in zip(tree_leaves(new), tree_leaves(old))]
        return tree_unflatten(old, out)

    def _step(self, ds: DataSet, carries=None, guarded: bool = False):
        """One optimizer step on ``ds`` at the current iteration, which it
        advances → (loss, carries after it[, ok]).  ``guarded`` selects
        the old parameters and updater state where the loss or a gradient
        is not finite, and also returns that flag (on the device).  The
        layers' state (running statistics) is replaced by the step's."""
        new_s: list = []
        loss, grads, carries = self._loss_and_grads(ds, carries, state_out=new_s)
        ok = self._grads_finite(loss, grads) if guarded else None
        self._commit_step(grads, new_s, ok)
        return (loss, carries, ok) if guarded else (loss, carries)

    def _commit_step(self, grads, new_s: list, ok: Optional[Tensor] = None,
                     apply_updates: Optional[Callable] = None) -> None:
        """Apply ``grads`` at the current iteration, install the new
        parameters, updater state and layer state ``new_s``, and advance
        the iteration.  Where the device flag ``ok`` is false the old
        parameters and states are kept bitwise.  ``apply_updates`` stands
        in for ``_apply_updates`` (a tensor-parallel trainer's, over its
        slices)."""
        it = self._iter_tensor()
        with torch.no_grad():
            new_p, new_o = (apply_updates or self._apply_updates)(
                grads, self.params, self.opt_state, it)
            if ok is not None:
                new_p = [self._select_tree(ok, n, o) for n, o in zip(new_p, self.params)]
                new_o = [self._select_tree(ok, n, o) for n, o in zip(new_o, self.opt_state)]
                new_s = [self._select_tree(ok, n, o) for n, o in zip(new_s, self.state)]
            self.params, self.opt_state, self.state = new_p, new_o, new_s
            self._it_dev = it + 1
        self.iteration += 1
        self._it_dev_val = self.iteration

    def set_nan_guard(self, budget: Optional[int] = 3) -> None:
        """Opt-in divergence guard: every step checks its loss and gradients
        for NaN/Inf on the device; a non-finite step applies NO update
        (parameters, updater state and layer state stay bitwise as they
        were) and spends one unit of ``budget``; a good step refills it.
        More than ``budget`` consecutive bad steps raise
        :class:`DivergenceError`.  ``budget=None`` switches it off (the
        default), and the step is then exactly the unguarded one.

        Cost when on: the step's flag is read on the host, one device sync
        per step."""
        if budget is not None and budget < 1:
            raise ValueError(f"nan guard budget must be >= 1, got {budget}")
        self._nan_guard_budget = budget
        self._bad_steps = 0

    def _note_guarded_step(self, ok: bool) -> None:
        """Host-side budget accounting of a guarded step: reset on a good
        step, raise past the budget (and start a fresh budget)."""
        if ok:
            self._bad_steps = 0
            return
        self._bad_steps += 1
        logging.getLogger("deeplearning4j_tpu_torch").warning(
            "non-finite gradients at iteration %d — update skipped "
            "(%d/%d bad steps)", self.iteration, self._bad_steps,
            self._nan_guard_budget)
        if self._bad_steps > self._nan_guard_budget:
            bad, self._bad_steps = self._bad_steps, 0
            raise DivergenceError(bad, self._nan_guard_budget)

    def _fire(self, iteration: int, score) -> None:
        for lst in self.listeners:
            lst.iteration_done(self, iteration, score)

    def fit_batch(self, ds: DataSet) -> LazyScore:
        """One optimization step on one minibatch (one per chunk under
        TBPTT).  Returns the loss as a :class:`LazyScore`: reading it
        syncs with the device, and a loop that only chains steps never
        does (unless the nan guard is on)."""
        if self.conf.backprop_type == "tbptt":
            if self._nan_guard_budget is not None:
                raise NotImplementedError(
                    "the nan guard does not compose with TBPTT yet — chunk "
                    "steps apply updates inside a scan; run with "
                    "set_nan_guard(None)")
            return self._fit_batch_tbptt(ds)
        if self._nan_guard_budget is not None:
            return self._fit_batch_guarded(ds)
        # span taxonomy (docs/OBSERVABILITY.md): train/step wraps the host
        # side of one optimizer step; h2d is the batch's moves to the
        # device, dispatch the forward, backward and update.  No-ops when
        # tracing is off.
        with obs_trace.span("train/step", cat="train",
                            iteration=self.iteration + 1):
            with obs_trace.span("train/h2d", cat="train"):
                # tensors already on the device pass through _step's own
                # moves untouched
                ds = DataSet(*self._batch(ds))
            with obs_trace.span("train/dispatch", cat="train"):
                loss, _ = self._step(ds)
        score = LazyScore(loss)
        self._fire(self.iteration, score)
        return score

    def _fit_batch_guarded(self, ds: DataSet) -> LazyScore:
        """``fit_batch`` through the guarded step (``set_nan_guard`` on)."""
        with obs_trace.span("train/step", cat="train", guarded=True,
                            iteration=self.iteration + 1):
            with obs_trace.span("train/h2d", cat="train"):
                ds = DataSet(*self._batch(ds))
            with obs_trace.span("train/dispatch", cat="train"):
                loss, _, ok = self._step(ds, guarded=True)
        # the guard's documented cost: reading the flag is a device sync
        self._note_guarded_step(bool(ok))
        score = LazyScore(loss)
        self._fire(self.iteration, score)
        return score

    def _stacked(self, batches: List[DataSet]) -> Dict[str, Optional[Tensor]]:
        """Each DataSet field of ``batches`` stacked on a new leading axis on
        the device (None where every batch has None); dict labels stack
        entry by entry, under ``labels/<name>``."""
        out: Dict[str, Optional[Tensor]] = {}
        for f in dataclasses.fields(DataSet):
            _stack_field(out, f.name, [getattr(ds, f.name) for ds in batches],
                         self._as_tensor)
        return out

    @staticmethod
    def _batch_at(stacked: Dict[str, Optional[Tensor]], i: int) -> DataSet:
        """Batch ``i`` of ``_stacked``'s output."""
        return DataSet(*(_field_at(stacked, f.name, i) for f in dataclasses.fields(DataSet)))

    @property
    def fit_graph_count(self) -> int:
        """How many ``fit_batches`` CUDA graphs this network holds."""
        return len(self._fit_graphs)

    def fit_batches(self, batches) -> List[LazyScore]:
        """k optimizer steps over a list of same-shaped DataSets, in one
        dispatch: on the card one CUDA graph of the k steps, captured at
        the first call for a given (k, shapes, dtypes) and replayed after;
        on the CPU the k steps eagerly.  Listeners fire after the k steps
        with each step's loss.  TBPTT configurations and listeners with
        ``requires_model_state`` take one ``fit_batch`` per batch, as in
        the reference; the nan guard is not consulted, as in the
        reference.  Without dropout or weight noise the losses, parameters
        and iteration match k ``fit_batch`` calls bitwise; with them the
        random stream differs from k calls' and repeats from a seed."""
        batches = list(batches)
        if not batches:
            return []
        if self.conf.backprop_type == "tbptt" or any(
                getattr(l, "requires_model_state", False) for l in self.listeners):
            return [self.fit_batch(ds) for ds in batches]
        n = len(batches)
        stacked = self._stacked(batches)
        if self.device.type == "cuda":
            from .train_graph import replay_steps
            losses = replay_steps(self, stacked, n)
        else:
            losses = torch.stack([self._step(self._batch_at(stacked, i))[0]
                                  for i in range(n)])
        scores = [LazyScore(losses[i]) for i in range(n)]
        for i, score in enumerate(scores):
            self._fire(self.iteration - n + i + 1, score)
        return scores

    def _init_carries(self, mb: int):
        dtype = self._compute_dtype()
        return [l.init_carry(mb, dtype, self.device) if l.recurrent else None
                for l in self.conf.layers]

    def _fit_batch_tbptt(self, ds: DataSet, step=None) -> LazyScore:
        """Truncated BPTT: the time axis in ``tbptt_length`` chunks, one
        optimizer step per chunk (at iterations ``iteration``,
        ``iteration + 1``, ...), recurrent state carried from chunk to
        chunk.  The score is the mean of the full chunks' losses, folded
        with a ragged tail chunk as (mean·n + tail) / (n + 1).  Listeners
        fire after each chunk's step.  ``step(chunk, carries)`` → (loss,
        carries, ...) takes each chunk's step; ``_step`` by default (the
        data-parallel trainer passes its own)."""
        step = step or self._step
        x, y, m, lm = self._batch(ds)

        def rank_ok(a):
            return a.ndim == 3 or (a.ndim == 2 and not a.is_floating_point())
        if not rank_ok(x) or (y is not None and not rank_ok(y)):
            raise ValueError("TBPTT requires [mb, time, features] inputs and "
                             "[mb, time, classes] labels (or [mb, time] "
                             "integer index arrays)")
        L = self.conf.tbptt_length
        mb, T = x.shape[0], x.shape[1]
        n, tail = divmod(T, L)
        carries = self._init_carries(mb)

        def cut(a, s):
            return None if a is None else a[:, s:s + L]
        losses = []
        for s in range(0, T, L):
            loss, carries = step(DataSet(cut(x, s), cut(y, s), cut(m, s), cut(lm, s)),
                                 carries)[:2]
            losses.append(loss)
            self._fire(self.iteration, LazyScore(loss))
        mean = torch.stack(losses[:n]).mean() if n else None
        if tail:
            mean = losses[-1] if mean is None else (mean * n + losses[-1]) / (n + 1)
        return LazyScore(mean)

    def rnn_time_step(self, x) -> Tensor:
        """Streaming inference that keeps recurrent state across calls:
        one step [mb, f] (or [mb] integer ids) or several [mb, t, f]
        ([mb, t] ids) → the last layer's activations, a tensor on the
        network's device ([mb, out] for one step).  A new batch size
        starts from zero state."""
        x = self._as_tensor(x)
        squeeze = x.ndim == (2 if x.is_floating_point() else 1)
        if squeeze:
            x = x[:, None]
        mb = x.shape[0]
        if self._stream_carries is not None:
            first = next((c for c in self._stream_carries if c is not None), None)
            first = first[0] if isinstance(first, tuple) else first
            if first is not None and first.shape[0] != mb:
                self._stream_carries = None
        if self._stream_carries is None:
            self._stream_carries = self._init_carries(mb)
        with torch.inference_mode():
            y, _, self._stream_carries = self._apply_layers(
                self.params, self.state, x, None, carries=self._stream_carries)
        return y[:, 0] if squeeze and y.ndim == 3 else y

    def rnn_clear_previous_state(self) -> None:
        """Forget the streaming state: the next ``rnn_time_step`` starts
        from zeros."""
        self._stream_carries = None

    @staticmethod
    def _as_iterator(data):
        """A DataSetIterator, a DataSet or an ``(x, y)`` pair as an iterator;
        any other iterable of DataSets (a list) passes through."""
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, DataSet):
            return ListDataSetIterator([data])
        if isinstance(data, tuple) and len(data) == 2:
            return ListDataSetIterator([DataSet(data[0], data[1])])
        if isinstance(data, (str, bytes)) or not hasattr(data, "__iter__"):
            raise TypeError(f"cannot iterate {type(data)}")
        return data

    def fit(self, data, epochs: int = 1) -> List[LazyScore]:
        """Train on a DataSetIterator, a DataSet, an ``(x, y)`` pair or a
        list / iterable of DataSets for ``epochs`` passes; listeners fire
        per iteration, and each epoch's scores are read in one device copy
        at its end.  More than one epoch needs data that can be iterated
        again (not a one-shot iterator)."""
        it = self._as_iterator(data)
        if epochs > 1 and iter(it) is it:
            raise ValueError("fit(epochs > 1) needs data it can iterate again, "
                             "e.g. a list of DataSets, not a one-shot iterator")
        losses: List[LazyScore] = []
        synced = 0
        for _ in range(epochs):
            for ds in it:
                losses.append(self.fit_batch(ds))
            synced = self._end_epoch(losses, synced)
        return losses

    def _end_epoch(self, losses, synced: int) -> int:
        """Epoch epilogue shared by ``fit`` and ``ShardedTrainer.fit``: read
        the epoch's scores in one copy, count the epoch, fire
        ``epoch_done``."""
        materialize_scores(losses[synced:])
        self.epoch += 1
        for lst in self.listeners:
            if hasattr(lst, "epoch_done"):
                lst.epoch_done(self, self.epoch)
        return len(losses)

    # ------------------------------------------------------------------
    # layerwise unsupervised pretraining
    # ------------------------------------------------------------------

    def pretrainable_layers(self) -> List[int]:
        """Indices of layers with an unsupervised objective (RBM,
        AutoEncoder, VariationalAutoencoder)."""
        return [i for i, l in enumerate(self.conf.layers)
                if hasattr(l, "contrastive_divergence")
                or hasattr(l, "reconstruction_score")]

    def pretrain(self, data, epochs: int = 1) -> Dict[int, List[LazyScore]]:
        """Greedy layerwise pretraining: each pretrainable layer in order,
        on the features of the (already pretrained) layers below it;
        labels are ignored.  Returns {layer index: losses}."""
        return {i: self.pretrain_layer(i, data, epochs)
                for i in self.pretrainable_layers()}

    def pretrain_layer(self, i: int, data, epochs: int = 1) -> List[LazyScore]:
        """Unsupervised pretraining of layer ``i``: inputs featurized
        through layers [0, i) in inference mode, then the layer's
        objective (CD-k for an RBM, the reconstruction loss for an
        AutoEncoder, the negative ELBO for a VariationalAutoencoder, its
        noise from the network's generator) through the layer's own
        updater, with its own step counter from 0, gradient normalization
        and constraints."""
        layer = self.conf.layers[i]
        is_rbm = hasattr(layer, "cd_gradients")
        if not is_rbm and not hasattr(layer, "reconstruction_score"):
            raise ValueError(
                f"layer {i} ({type(layer).__name__}) has no unsupervised "
                "objective — pretrainable layers: RBM (contrastive "
                "divergence), AutoEncoder / VariationalAutoencoder "
                "(reconstruction/ELBO)")
        updater = self._updater_for(layer)
        losses: List[LazyScore] = []
        it = 0
        for _ in range(epochs):
            for ds in self._as_iterator(data):
                x = self._as_tensor(ds.features)
                with torch.no_grad():
                    feat = self._apply_layers(self.params, self.state, x, None,
                                              upto=i)[0]
                    feat = self._preprocess(i, feat, self._gen)
                p = self.params[i]
                if is_rbm:
                    with torch.no_grad():
                        g, loss = layer.cd_gradients(p, feat, self._gen)
                else:
                    loss, g = _objective_and_grads(layer, p, feat, self._gen)
                with torch.no_grad():
                    if self.conf.gradient_normalization != GradientNormalization.NONE:
                        g = normalize_gradients(g, self.conf.gradient_normalization,
                                                self.conf.gradient_normalization_threshold)
                    itf = torch.full((), float(it), dtype=torch.float32, device=self.device)
                    p2, self.opt_state[i] = updater.apply(p, g, self.opt_state[i], itf)
                    self.params[i] = apply_constraints(layer.constraints, p2)
                it += 1
                losses.append(LazyScore(loss))
        materialize_scores(losses)
        return losses

    def reconstruction_log_probability(self, x, layer_index: Optional[int] = None,
                                       num_samples: int = 5) -> Tensor:
        """Importance-weighted log p(x) per example [N] from a
        VariationalAutoencoder layer (the first one when ``layer_index`` is
        None): ``x`` featurized through the layers below it in inference
        mode, then the layer's IWAE estimate with ``num_samples`` samples
        drawn from the network's generator.  A tensor on the device."""
        if layer_index is None:
            layer_index = next((i for i, l in enumerate(self.conf.layers)
                                if hasattr(l, "reconstruction_log_probability")), None)
            if layer_index is None:
                raise ValueError("no VariationalAutoencoder layer in this network")
        layer = self.conf.layers[layer_index]
        if not hasattr(layer, "reconstruction_log_probability"):
            raise ValueError(f"layer {layer_index} ({type(layer).__name__}) "
                             "is not a VariationalAutoencoder")
        with torch.no_grad():
            feat = self._apply_layers(self.params, self.state, self._as_tensor(x), None,
                                      upto=layer_index)[0]
            feat = self._preprocess(layer_index, feat, None)
            return layer.reconstruction_log_probability(
                self.params[layer_index], feat, generator=self._gen, num_samples=num_samples)

    def reconstruction_probability(self, x, layer_index: Optional[int] = None,
                                   num_samples: int = 5) -> Tensor:
        """exp(``reconstruction_log_probability``); prefer the log form for
        high-dimensional data."""
        return torch.exp(self.reconstruction_log_probability(x, layer_index, num_samples))

    # ------------------------------------------------------------------
    # inference / scoring
    # ------------------------------------------------------------------

    def score(self, ds: DataSet) -> float:
        """Loss on a DataSet (regularization included) without updating."""
        x, y, m, lm = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, x, y, train=False, mask=m,
                                 label_mask=lm)
        return float(loss)

    def score_examples(self, ds: DataSet, add_regularization_terms: bool = True) -> Tensor:
        """Per-example scores [N] without the batch reduction, a tensor on
        the device; with ``add_regularization_terms`` the network's L1/L2
        score is added to every example (the reference's semantics)."""
        x, y, m, lm = self._batch(ds)
        n = len(self.conf.layers)
        last = self.conf.layers[n - 1]
        if not hasattr(last, "score_examples"):
            raise ValueError(
                f"last layer {type(last).__name__} has no score_examples(); "
                "supported: OutputLayer, LossLayer, RnnOutputLayer")
        with torch.no_grad():
            h, mask_out, _ = self._head_input(self.params, self.state, x, m,
                                              train=False, generator=None)
            lmask = lm if lm is not None else (
                mask_out if y is not None and _ndim(y) == 3 else None)
            pe = last.score_examples(self.params[n - 1], self.state[n - 1], h, y,
                                     mask=lmask)
            if add_regularization_terms:
                pe = pe + self._reg_score(self.params, pe.dtype)
        return pe

    def output(self, x, mask=None) -> Tensor:
        """Inference activations of the last layer, a tensor on the
        network's device.  ``x`` is a tensor or array (token ids for a
        TransformerLM); ``mask`` [B, T] with 1 = real step."""
        x = self._as_tensor(x)
        m = None if mask is None else self._as_tensor(mask)
        with torch.inference_mode():
            y, _, _ = self._apply_layers(self.params, self.state, x, m)
        return y

    def feed_forward(self, x, train: bool = False) -> List[Tensor]:
        """Every layer's activations, tensors on the device.  ``train``
        applies dropout and weight noise from the network's generator."""
        acts: List[Tensor] = []
        with torch.no_grad():
            self._apply_layers(self.params, self.state, self._as_tensor(x), None,
                               train=train, generator=self._gen if train else None,
                               acts=acts)
        return acts

    def evaluate(self, data, evaluation=None):
        """Metrics over ``data`` (an iterator, a DataSet or an ``(x, y)``
        pair) in ``evaluation`` — an ``Evaluation`` by default, or any
        metric of ``evaluation/`` (``ROC``, ``ROCBinary``, ``ROCMultiClass``,
        ``EvaluationBinary``, ``RegressionEvaluation``,
        ``EvaluationCalibration``), fed host arrays."""
        from ..evaluation.evaluation import Evaluation
        ev = evaluation if evaluation is not None else Evaluation()
        for ds in self._as_iterator(data):
            out = self.output(ds.features, mask=ds.features_mask)
            ev.eval(_host(ds.labels), _host(out),
                    mask=None if ds.labels_mask is None else _host(ds.labels_mask))
        return ev

    # ------------------------------------------------------------------
    # listeners / serde
    # ------------------------------------------------------------------

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def clone_params(self):
        """A copy of the parameter trees, tensors cloned (a ``fit_batches``
        graph replay writes the network's tensors in place)."""
        return [tree_unflatten(p, [t.clone() for t in tree_leaves(p)]) for p in self.params]

    def clone_state(self):
        """A copy of the layers' state (running statistics), cloned."""
        return [{k: v.clone() for k, v in s.items()} for s in self.state]

    def save(self, path: str, save_updater: bool = True) -> None:
        from ..utils.serializer import save_model
        save_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: DeviceLike = None) -> "MultiLayerNetwork":
        from ..utils.serializer import load_model
        return load_model(path, load_updater=load_updater, device=device)
