"""Recurrent-family layers (mirrors ``deeplearning4j_tpu/nn/layers/recurrent.py``):
``LSTM``, ``GravesLSTM``, ``GravesBidirectionalLSTM``, ``SimpleRnn``,
``Bidirectional``, ``RnnOutputLayer`` and ``LastTimeStep``.

Layout [mb, time, features]; gate order in the 4·n_out columns
``[i, f, o, g]``; parameter keys ``W`` (input), ``RW`` (recurrent), ``b``
and, for peephole cells, ``pW`` [3·n_out] (i, f, o), with the suffixes
``F``/``B`` for ``GravesBidirectionalLSTM``'s two directions and nested
``fwd``/``bwd`` trees for ``Bidirectional``.

The input projection is hoisted out of the reference's ``lax.scan`` over
time (one [mb·t, f] × [f, 4n] product, or the row gather ``W[x]`` for
integer ids).  The standard cell (no peepholes, sigmoid gates, tanh) runs
the whole scan through ``ops/lstm_kernel.lstm_sequence``: on the card one
K5a launch per layer and sequence, and K5b in its backward; on the CPU
the per-step loop.  Other activations and peepholes take the general
path, a Python loop that adds ``h @ RW + b`` each step, as in the
reference.  Streaming is ``forward`` with the carry passed in and
returned (``MultiLayerNetwork.rnn_time_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ...ops.activations import get_activation
from ...ops.dtypes import canonical_dtype
from ...ops.initializers import init_weight
from ...ops.losses import get_loss, summed_per_example
from ...ops.lstm_kernel import hold as _hold
from ...ops.lstm_kernel import lstm_sequence
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


def _standard_cell(cfg) -> bool:
    return (not cfg.peephole and cfg.gate_activation == "sigmoid"
            and cfg.activation == "tanh")


def _lstm_cell(cfg, params, carry, zx_t, mask_t=None, suffix=""):
    """One step of the general cell (peepholes or other activations):
    carry (h, c), the input's projection ``zx_t`` = x_t @ W [mb, 4n],
    mask_t [mb] or None → the new (h, c)."""
    h, c = carry
    RW = params["RW" + suffix].to(zx_t.dtype)
    b = params["b" + suffix].to(zx_t.dtype)
    z = zx_t + h @ RW + b  # [mb, 4n]
    n = cfg.n_out
    zi, zf, zo, zg = z[:, :n], z[:, n:2 * n], z[:, 2 * n:3 * n], z[:, 3 * n:]
    gate = get_activation(cfg.gate_activation)
    act = get_activation(cfg.activation)
    if cfg.peephole:
        pW = params["pW" + suffix].to(z.dtype)
        pi, pf, po = pW[:n], pW[n:2 * n], pW[2 * n:]
        i = gate(zi + c * pi)
        f = gate(zf + c * pf)
        c_new = f * c + i * act(zg)
        o = gate(zo + c_new * po)
    else:
        i, f, o = gate(zi), gate(zf), gate(zo)
        c_new = f * c + i * act(zg)
    h_new = o * act(c_new)
    return _hold(mask_t, h_new, h), _hold(mask_t, c_new, c)


def _scan_lstm(cfg, params, x, mask, h0, c0, reverse=False, suffix=""):
    """The cell over time: x [mb, t, f] (or integer ids [mb, t]) →
    outputs [mb, t, n_out] and the final (h, c).  ``reverse`` walks from
    the last step to the first and still writes step t's output at t."""
    W = params["W" + suffix]
    if not x.is_floating_point():
        # gather in the compute dtype (h0's): W's is the param dtype
        zx = W[x.long()].to(h0.dtype)   # [mb, t, 4n]
    else:
        zx = x @ W.to(x.dtype)          # [mb, t, 4n]
    if _standard_cell(cfg):
        return lstm_sequence(zx, params["RW" + suffix].to(zx.dtype),
                             params["b" + suffix].to(zx.dtype), h0, c0, mask, reverse)
    t_len = zx.shape[1]
    carry = (h0, c0)
    hs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        carry = _lstm_cell(cfg, params, carry, zx[:, t],
                           None if mask is None else mask[:, t], suffix)
        hs[t] = carry[0]
    return torch.stack(hs, dim=1), carry


def _compute_dtype(layer, params, key: str, x: Tensor) -> torch.dtype:
    """The carry dtype: the input's for dense input; for integer ids the
    container's compute dtype (set by ``_apply_layers``), else the
    parameter's."""
    if x.is_floating_point():
        return x.dtype
    return canonical_dtype(getattr(layer, "_compute_dtype", None) or params[key].dtype)


def _dropout_dense(layer: Layer, x: Tensor, train: bool, generator) -> Tensor:
    """Input dropout on dense inputs only: the reference skips it on raw
    ids."""
    return layer._maybe_dropout(x, train, generator) if x.is_floating_point() else x


@register_layer
@dataclasses.dataclass
class LSTM(Layer):
    """Standard LSTM, no peepholes."""

    wants = "rnn"
    recurrent = True

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    activation: str = "tanh"
    peephole: bool = False

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def _init_direction(self, generator, dtype, suffix="") -> Dict[str, Tensor]:
        n = self.n_out
        b = torch.zeros((4 * n,), dtype=dtype)
        b[n:2 * n] = self.forget_gate_bias_init  # forget-gate bias
        p = {
            "W" + suffix: init_weight((self.n_in, 4 * n), self._winit(), self.n_in, n,
                                      dtype, generator),
            "RW" + suffix: init_weight((n, 4 * n), self._winit(), n, n, dtype, generator),
            "b" + suffix: b,
        }
        if self.peephole:
            p["pW" + suffix] = init_weight((3 * n,), "uniform", n, n, dtype, generator)
        return p

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return self._init_direction(generator, dtype)

    def init_carry(self, mb: int, dtype=torch.float32, device=None) -> Tuple[Tensor, Tensor]:
        return (torch.zeros((mb, self.n_out), dtype=dtype, device=device),
                torch.zeros((mb, self.n_out), dtype=dtype, device=device))

    def forward(self, params, state, x, *, train=False, generator=None, mask=None,
                carry=None) -> ForwardOut:
        x = _dropout_dense(self, x, train, generator)
        cdt = _compute_dtype(self, params, "W", x)
        h0, c0 = carry if carry is not None else self.init_carry(x.shape[0], cdt, x.device)
        ys, final = _scan_lstm(self, params, x, mask, h0, c0)
        return ForwardOut(ys, state, mask, final)


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013)."""

    peephole: bool = True


@register_layer
@dataclasses.dataclass
class GravesBidirectionalLSTM(LSTM):
    """Bidirectional peephole LSTM; the two directions' outputs are
    SUMMED.  Not streamable (the backward direction needs the whole
    sequence), so it takes no carry, as in the reference."""

    recurrent = False
    peephole: bool = True

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        p = self._init_direction(generator, dtype, suffix="F")
        p.update(self._init_direction(generator, dtype, suffix="B"))
        return p

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = _dropout_dense(self, x, train, generator)
        cdt = _compute_dtype(self, params, "WF", x)
        h0, c0 = self.init_carry(x.shape[0], cdt, x.device)
        fwd, _ = _scan_lstm(self, params, x, mask, h0, c0, reverse=False, suffix="F")
        bwd, _ = _scan_lstm(self, params, x, mask, h0, c0, reverse=True, suffix="B")
        return ForwardOut(fwd + bwd, state, mask)


@register_layer
@dataclasses.dataclass
class SimpleRnn(Layer):
    """Vanilla RNN: h_t = act(x_t·W + h_{t-1}·RW + b)."""

    wants = "rnn"
    recurrent = True

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {
            "W": init_weight((self.n_in, self.n_out), self._winit(), self.n_in, self.n_out,
                             dtype, generator),
            "RW": init_weight((self.n_out, self.n_out), self._winit(), self.n_out,
                              self.n_out, dtype, generator),
            "b": torch.full((self.n_out,), float(self.bias_init), dtype=dtype),
        }

    def init_carry(self, mb: int, dtype=torch.float32, device=None):
        return torch.zeros((mb, self.n_out), dtype=dtype, device=device)

    def forward(self, params, state, x, *, train=False, generator=None, mask=None,
                carry=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        act = get_activation(self.activation)
        W = params["W"].to(x.dtype)
        RW = params["RW"].to(x.dtype)
        b = params["b"].to(x.dtype)
        h = carry if carry is not None else self.init_carry(x.shape[0], x.dtype, x.device)
        hs = []
        for t in range(x.shape[1]):
            h = _hold(None if mask is None else mask[:, t],
                      act(x[:, t] @ W + h @ RW + b), h)
            hs.append(h)
        return ForwardOut(torch.stack(hs, dim=1), state, mask, h)


@register_layer
@dataclasses.dataclass
class Bidirectional(Layer):
    """Runs any recurrent layer forward and backward in time and combines
    the two outputs: ``concat`` / ``add`` / ``mul`` / ``average``."""

    layer: Optional[Layer] = None
    mode: str = "concat"

    def infer_nin(self, in_type: InputType) -> None:
        self.layer.infer_nin(in_type)

    def output_type(self, in_type: InputType) -> InputType:
        inner = self.layer.output_type(in_type)
        if self.mode == "concat":
            return InputType.recurrent(inner.size * 2, inner.timesteps)
        return inner

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"fwd": self.layer.init_params(generator, in_type, dtype),
                "bwd": self.layer.init_params(generator, in_type, dtype)}

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        fwd = self.layer.forward(params["fwd"], {}, x, train=train, generator=generator,
                                 mask=mask).y
        mrev = None if mask is None else torch.flip(mask, dims=(1,))
        bwd = self.layer.forward(params["bwd"], {}, torch.flip(x, dims=(1,)),
                                 train=train, generator=generator, mask=mrev).y
        bwd = torch.flip(bwd, dims=(1,))
        if self.mode == "concat":
            y = torch.cat([fwd, bwd], dim=-1)
        elif self.mode == "add":
            y = fwd + bwd
        elif self.mode == "mul":
            y = fwd * bwd
        elif self.mode == "average":
            y = 0.5 * (fwd + bwd)
        else:
            raise ValueError(self.mode)
        return ForwardOut(y, state, mask)

    def regularization_score(self, params):
        return (self.layer.regularization_score(params["fwd"])
                + self.layer.regularization_score(params["bwd"]))


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(Layer):
    """Time-distributed dense head: act(x·W + b) over [mb, t, n_in]."""

    wants = "rnn"

    n_in: int = 0
    n_out: int = 0
    loss: str = "mcxent"
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return self._dense_init(generator, self.n_in, self.n_out, dtype)

    def _pre(self, params, x):
        """Pre-activation logits (the decode head reads these)."""
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        return ForwardOut(self._act(self._pre(params, x)), state, mask)

    def score(self, params, state, x, labels, *,
              mask: Optional[Tensor] = None) -> Tensor:
        """Mean loss of the pre-activations [mb, t, n_out] against
        ``labels`` (one-hot [mb, t, n_out] or class ids [mb, t])."""
        return get_loss(self.loss)(labels, self._pre(params, x),
                                   self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        """[mb] scores: the per-timestep loss summed over the sequence."""
        return summed_per_example(self.loss, labels, self._pre(params, x),
                                  self.activation, mask)


@register_layer
@dataclasses.dataclass
class LastTimeStep(Layer):
    """Wrapper: run the inner recurrent layer and emit only its last
    (masked) time step, [mb, features]."""

    layer: Optional[Layer] = None

    def infer_nin(self, in_type: InputType) -> None:
        self.layer.infer_nin(in_type)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.layer.output_type(in_type).size)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return self.layer.init_params(generator, in_type, dtype)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        out = self.layer.forward(params, state, x, train=train, generator=generator,
                                 mask=mask)
        ys = out.y  # [mb, t, f]
        if mask is not None:
            idx = torch.clamp(mask.to(torch.int32).sum(dim=1) - 1, min=0).long()
            y = ys[torch.arange(ys.shape[0], device=ys.device), idx]
        else:
            y = ys[:, -1]
        return ForwardOut(y, out.state, None)

    def regularization_score(self, params):
        return self.layer.regularization_score(params)
