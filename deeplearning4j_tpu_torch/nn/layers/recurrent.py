"""Recurrent-family layers (mirrors ``deeplearning4j_tpu/nn/layers/recurrent.py``;
``RnnOutputLayer`` only)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...ops.losses import get_loss, summed_per_example
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer


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

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return self._dense_init(generator, self.n_in, self.n_out, dtype)

    def _pre(self, params, x):
        """Pre-activation logits (the decode head reads these)."""
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def forward(self, params, state, x, *, train=False, mask=None) -> ForwardOut:
        self._check_train(train)
        return ForwardOut(self._act(self._pre(params, x)), state, mask)

    def score(self, params, state, x, labels, *,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean loss of the pre-activations [mb, t, n_out] against
        ``labels`` (one-hot [mb, t, n_out] or class ids [mb, t])."""
        return get_loss(self.loss)(labels, self._pre(params, x),
                                   self.activation or "identity", mask)

    def score_examples(self, params, state, x, labels, *,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[mb] scores: the per-timestep loss summed over the sequence."""
        return summed_per_example(self.loss, labels, self._pre(params, x),
                                  self.activation, mask)
