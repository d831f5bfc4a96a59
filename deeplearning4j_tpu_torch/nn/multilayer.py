"""MultiLayerNetwork — the sequential-stack model container (mirrors
``deeplearning4j_tpu/nn/multilayer.py``: configuration, ``init``,
``output``, ``score``, training through ``fit_batch`` / ``fit`` with
standard backprop or TBPTT, and streaming through ``rnn_time_step``).

Parameters are a list of per-layer dicts of tensors keyed as in the JAX
trees; ``opt_state`` is the list of per-layer updater states (``{}`` for
a layer without parameters).  One training step is the reference's:
loss (output layer + L1/L2) → gradients by autograd → per-layer gradient
normalization → per-layer updater ``apply``.  The update builds new
tensors rather than writing in place, as the reference's pure step does.
Recurrent layers thread a carry (``carries``, one entry per layer) through
TBPTT chunks and streaming calls.  Not ported yet: the nan guard,
``fit_batches`` and the stochastic layer settings (dropout, weight noise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..ops.dtypes import canonical_dtype
from ..optimize.score import LazyScore, materialize_scores
from ..utils.device import DeviceLike, resolve_device
from .conf.inputs import InputType
from .layers.base import Layer, config_from_dict, config_to_dict
from .updaters import (Adam, GradientNormalization, Updater,
                       normalize_gradients, tree_leaves, tree_unflatten)

Tensor = torch.Tensor

#: (param, compute) dtype pairs the port runs.  Under float32/bfloat16 the
#: parameters, their gradients and the updater stay float32; floating
#: inputs are cast to bfloat16 and each layer casts a weight to its
#: input's dtype where the reference does (see ``ops.dtypes.matmul``).
_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16))


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
    preprocessors: Dict[int, Any] = dataclasses.field(default_factory=dict)
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
    / ``fit_batch`` / ``fit`` / ``save``.

    ``device`` defaults to ``cuda`` and raises without a card unless
    ``device="cpu"`` is passed.  ``grad_residual`` holds a checkpoint's
    error-feedback residual (one tree shaped like ``params`` with a
    leading slice axis) until a ``parallel.ShardedTrainer`` adopts it, and
    ``save`` writes it back."""

    def __init__(self, conf: MultiLayerConfiguration, device: DeviceLike = None):
        self.conf = conf
        self.device = resolve_device(device)
        if conf.preprocessors:
            raise NotImplementedError("input preprocessors are not ported yet")
        pd, cd = canonical_dtype(conf.param_dtype), canonical_dtype(conf.compute_dtype)
        if (pd, cd) not in _DTYPE_PAIRS:
            raise NotImplementedError(
                f"param/compute dtypes {conf.param_dtype}/{conf.compute_dtype}: "
                "the port runs float32 or bfloat16 with equal param and "
                "compute dtypes, or float32 parameters computed in bfloat16")
        self.params: List[Dict[str, Tensor]] = []
        self.state: List[Dict[str, Tensor]] = []
        self.opt_state: List[Dict] = []
        self.iteration = 0
        self._it_dev: Optional[Tensor] = None   # iteration as an f32 on the device
        self._it_dev_val = -1                   # the value _it_dev holds
        self.epoch = 0
        self.grad_residual: Optional[List[Dict[str, Tensor]]] = None
        self._stream_carries: Optional[List[Any]] = None   # rnn_time_step state
        self.input_types: List[InputType] = []
        self._infer_types()

    def _infer_types(self) -> None:
        """Propagate InputType through the layers, filling n_in fields."""
        self.input_types = []
        t = self.conf.input_type
        if t is None:
            return
        for layer in self.conf.layers:
            if layer.wants is not None and t.kind != layer.wants and not (
                    t.kind == "rnn" and layer.wants == "ff"):
                raise NotImplementedError(
                    f"{type(layer).__name__} wants {layer.wants} input, got "
                    f"{t.kind}: shape-adapting preprocessors are not ported yet")
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
        self.params = [{k: v.to(self.device) for k, v in p.items()} for p in params]
        self.state = [{k: v.to(self.device) for k, v in s.items()} for s in state]
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

    def _apply_layers(self, params, state, x: Tensor, mask: Optional[Tensor], *,
                      train: bool = False, upto: Optional[int] = None, carries=None):
        """Forward through layers [0, upto) (all by default) → (y, mask,
        new_carries).  ``carries`` (one entry per layer, or None for zero
        state) threads recurrent hidden state for TBPTT and streaming."""
        # layers that need the compute dtype apart from their input's
        # (integer-id LSTM inputs) read it from this attribute
        for layer in self.conf.layers:
            layer._compute_dtype = self.conf.compute_dtype
        if x.is_floating_point():
            x = x.to(canonical_dtype(self.conf.compute_dtype))
        n = len(self.conf.layers) if upto is None else upto
        new_carries = list(carries) if carries is not None else [None] * len(self.conf.layers)
        for i in range(n):
            layer = self.conf.layers[i]
            kwargs = {"carry": carries[i]} if layer.recurrent and carries is not None else {}
            out = layer.forward(params[i], state[i], x, train=train, mask=mask, **kwargs)
            x, mask = out.y, out.mask
            new_carries[i] = out.carry
        return x, mask, new_carries

    def _loss(self, params, state, x, labels, *, train: bool,
              mask=None, label_mask=None, carries=None):
        """Full score: the output layer's loss plus every layer's L1/L2
        → (loss, new_carries)."""
        n = len(self.conf.layers)
        h, mask_out, new_carries = self._apply_layers(
            params, state, x, mask, train=train, upto=n - 1, carries=carries)
        last = self.conf.layers[n - 1]
        last._check_train(train)
        lm = label_mask if label_mask is not None else (
            mask_out if labels is not None and labels.ndim == 3 else None)
        if not hasattr(last, "score"):
            raise ValueError(f"last layer {type(last).__name__} has no score(); "
                             "use an output layer")
        loss = last.score(params[n - 1], state[n - 1], h, labels, mask=lm)
        acc = (torch.float64 if canonical_dtype(self.conf.compute_dtype) == torch.float64
               else torch.float32)
        reg = torch.zeros((), dtype=acc, device=loss.device)
        for layer, p in zip(self.conf.layers, params):
            if p:
                reg = reg + layer.regularization_score(p).to(acc)
        return loss.to(acc) + reg, new_carries

    def _apply_updates(self, grads, params, opt_state, it: Tensor):
        """Per layer: gradient normalization, then the updater's ``apply``
        (updater math + param step; Adam/Nadam take the fused kernel K4
        when ``DL4J_TPU_FUSED_UPDATE=1``)."""
        conf = self.conf
        new_params, new_opt = [], []
        for layer, g, p, os_ in zip(conf.layers, grads, params, opt_state):
            if not p:
                new_params.append(p)
                new_opt.append(os_)
                continue
            if layer.constraints:
                raise NotImplementedError(
                    f"layer {layer.name or type(layer).__name__}: parameter "
                    "constraints are not ported yet")
            if conf.gradient_normalization != GradientNormalization.NONE:
                g = normalize_gradients(g, conf.gradient_normalization,
                                        conf.gradient_normalization_threshold)
            p2, os2 = self._updater_for(layer).apply(p, g, os_, it)
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

    def _as_tensor(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a,
                               device=self.device)

    def _loss_and_grads(self, ds: DataSet, carries=None):
        """The training loss on ``ds``, its gradient with respect to every
        parameter (per-layer dicts shaped like ``params``) and the
        recurrent carries after it, detached: the next TBPTT chunk takes
        them as constants, as the reference differentiates each chunk on
        its own."""
        x, y, m, lm = self._batch(ds)
        live = [[t.detach().requires_grad_(True) for t in tree_leaves(p)]
                for p in self.params]
        params = [tree_unflatten(p, ls) for p, ls in zip(self.params, live)]
        with torch.enable_grad():
            loss, new_carries = self._loss(params, self.state, x, y, train=True, mask=m,
                                           label_mask=lm, carries=carries)
            flat = [t for ls in live for t in ls]
            gflat = torch.autograd.grad(loss, flat) if flat else []
        grads, off = [], 0
        for p, ls in zip(self.params, live):
            grads.append(tree_unflatten(p, list(gflat[off:off + len(ls)])))
            off += len(ls)
        return loss.detach(), grads, [_detached(c) for c in new_carries]

    def _step(self, ds: DataSet, carries=None):
        """One optimizer step on ``ds`` at the current iteration, which it
        advances → (loss, carries after it)."""
        loss, grads, carries = self._loss_and_grads(ds, carries)
        it = self._iter_tensor()
        with torch.no_grad():
            self.params, self.opt_state = self._apply_updates(
                grads, self.params, self.opt_state, it)
            self._it_dev = it + 1
        self.iteration += 1
        self._it_dev_val = self.iteration
        return loss, carries

    def fit_batch(self, ds: DataSet) -> LazyScore:
        """One optimization step on one minibatch (one per chunk under
        TBPTT).  Returns the loss as a :class:`LazyScore`: reading it
        syncs with the device, and a loop that only chains steps never
        does."""
        if self.conf.backprop_type == "tbptt":
            return self._fit_batch_tbptt(ds)
        return LazyScore(self._step(ds)[0])

    def _init_carries(self, mb: int):
        dtype = canonical_dtype(self.conf.compute_dtype)
        return [l.init_carry(mb, dtype, self.device) if l.recurrent else None
                for l in self.conf.layers]

    def _fit_batch_tbptt(self, ds: DataSet) -> LazyScore:
        """Truncated BPTT: the time axis in ``tbptt_length`` chunks, one
        optimizer step per chunk (at iterations ``iteration``,
        ``iteration + 1``, ...), recurrent state carried from chunk to
        chunk.  The score is the mean of the full chunks' losses, folded
        with a ragged tail chunk as (mean·n + tail) / (n + 1)."""
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
            loss, carries = self._step(DataSet(cut(x, s), cut(y, s), cut(m, s), cut(lm, s)),
                                       carries)
            losses.append(loss)
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

    def fit(self, data, epochs: int = 1) -> List[LazyScore]:
        """Train on a DataSet, an ``(x, y)`` pair or a list / iterable of
        DataSets for ``epochs`` passes; each epoch's scores are read in
        one device copy at its end.  More than one epoch needs data that
        can be iterated again (not a one-shot iterator)."""
        if isinstance(data, DataSet):
            data = [data]
        elif isinstance(data, tuple) and len(data) == 2:
            data = [DataSet(data[0], data[1])]
        if epochs > 1 and iter(data) is data:
            raise ValueError("fit(epochs > 1) needs data it can iterate again, "
                             "e.g. a list of DataSets, not a one-shot iterator")
        losses: List[LazyScore] = []
        for _ in range(epochs):
            start = len(losses)
            for ds in data:
                losses.append(self.fit_batch(ds))
            materialize_scores(losses[start:])
            self.epoch += 1
        return losses

    def score(self, ds: DataSet) -> float:
        """Loss on a DataSet (regularization included) without updating."""
        x, y, m, lm = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, x, y, train=False, mask=m,
                                 label_mask=lm)
        return float(loss)

    def output(self, x, mask=None) -> Tensor:
        """Inference activations of the last layer, a tensor on the
        network's device.  ``x`` is a tensor or array (token ids for a
        TransformerLM); ``mask`` [B, T] with 1 = real step."""
        x = self._as_tensor(x)
        m = None if mask is None else self._as_tensor(mask)
        with torch.inference_mode():
            y, _, _ = self._apply_layers(self.params, self.state, x, m)
        return y

    def save(self, path: str, save_updater: bool = True) -> None:
        from ..utils.serializer import save_model
        save_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: DeviceLike = None) -> "MultiLayerNetwork":
        from ..utils.serializer import load_model
        return load_model(path, load_updater=load_updater, device=device)
