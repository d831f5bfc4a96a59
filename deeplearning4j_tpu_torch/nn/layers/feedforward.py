"""Feed-forward layers (mirrors ``deeplearning4j_tpu/nn/layers/feedforward.py``:
``Dense``, ``OutputLayer``, ``LossLayer``, ``Embedding`` and
``EmbeddingSequence``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...ops.losses import get_loss, summed_per_example
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


@register_layer
@dataclasses.dataclass
class Dense(Layer):
    """Fully connected: y = act(x·W + b).  Recurrent inputs [mb, t, f] are
    handled time-distributed, as in the reference."""

    wants = "ff"

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size if in_type.kind in ("ff", "rnn") else in_type.flat_size()

    def output_type(self, in_type: InputType) -> InputType:
        if in_type.kind == "rnn":
            return InputType.recurrent(self.n_out, in_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        p = self._dense_init(generator, self.n_in, self.n_out, dtype)
        if not self.has_bias:
            del p["b"]
        return p

    def _pre(self, params, x: Tensor) -> Tensor:
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def forward(self, params, state, x, *, train=False, mask=None) -> ForwardOut:
        self._check_train(train)
        return ForwardOut(self._act(self._pre(params, x)), state, mask)


@register_layer
@dataclasses.dataclass
class OutputLayer(Dense):
    """Dense + loss head; ``loss`` names an ``ops.losses`` entry, fused
    with softmax/sigmoid in log space."""

    loss: str = "mcxent"

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        return get_loss(self.loss)(labels, self._pre(params, x),
                                   self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        """[mb] per-example scores (the loss summed over output features)."""
        return summed_per_example(self.loss, labels, self._pre(params, x),
                                  self.activation, mask)


@register_layer
@dataclasses.dataclass
class LossLayer(Layer):
    """Parameter-free loss head: the activation in ``forward``, the loss
    of the input in ``score``."""

    loss: str = "mse"

    def forward(self, params, state, x, *, train=False, mask=None) -> ForwardOut:
        self._check_train(train)
        return ForwardOut(self._act(x), state, mask)

    def score(self, params, state, x, labels, *, mask: Optional[Tensor] = None) -> Tensor:
        return get_loss(self.loss)(labels, x, self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[Tensor] = None) -> Tensor:
        return summed_per_example(self.loss, labels, x, self.activation, mask)


@register_layer
@dataclasses.dataclass
class Embedding(Layer):
    """Index → vector lookup; input is int indices [mb] or [mb, 1]."""

    n_in: int = 0   # vocab size
    n_out: int = 0  # embedding dim
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        p = self._dense_init(generator, self.n_in, self.n_out, dtype)
        if not self.has_bias:
            del p["b"]
        return p

    def _lookup(self, params, idx):
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return self._act(y)

    def forward(self, params, state, x, *, train=False, mask=None) -> ForwardOut:
        self._check_train(train)
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return ForwardOut(self._lookup(params, idx), state, mask)


@register_layer
@dataclasses.dataclass
class EmbeddingSequence(Embedding):
    """Sequence of indices [mb, t] → [mb, t, n_out]."""

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def forward(self, params, state, x, *, train=False, mask=None) -> ForwardOut:
        self._check_train(train)
        return ForwardOut(self._lookup(params, x.long()), state, mask)
