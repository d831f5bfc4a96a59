"""Normalization (mirrors ``deeplearning4j_tpu/nn/layers/normalization.py``:
``layer_norm`` and the ``LayerNorm`` layer; BatchNorm and LRN wait for the
conv path, ROADMAP queue 5)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalize the last axis with statistics in at least float32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(acc) + beta.to(acc)).to(x.dtype)


@register_layer
@dataclasses.dataclass
class LayerNorm(Layer):
    """Per-token normalization over the feature axis, then the activation."""

    n_features: int = 0
    eps: float = 1e-5

    def infer_nin(self, in_type: InputType) -> None:
        if not self.n_features:
            self.n_features = in_type.size

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"gamma": torch.ones((self.n_features,), dtype=dtype),
                "beta": torch.zeros((self.n_features,), dtype=dtype)}

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(
            self._act(layer_norm(x, params["gamma"], params["beta"], self.eps)),
            state, mask)
