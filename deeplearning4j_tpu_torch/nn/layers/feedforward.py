"""Embedding layers (mirrors ``deeplearning4j_tpu/nn/layers/feedforward.py``:
``Embedding`` and ``EmbeddingSequence``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer


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

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, torch.Tensor]:
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
