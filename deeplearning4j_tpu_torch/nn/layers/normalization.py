"""Normalization (mirrors ``deeplearning4j_tpu/nn/layers/normalization.py``:
``BatchNormalization``, ``LocalResponseNormalization``, ``layer_norm`` and
the ``LayerNorm`` layer).

BatchNormalization keeps the reference's running statistics, which are
not ``F.batch_norm``'s: the state holds the BIASED batch variance, updated
as ``decay·old + (1 - decay)·batch`` (decay 0.9, in the state's dtype).
In bfloat16 or float16 compute the batch variance is ``E[x²] - E[x]²``
with float32-accumulating means (x² rounded to the compute dtype first);
in float32 and float64 it is the two-pass variance.  The statistics are
plain tensor ops, so the gradient flows through them as it does through
the reference's ``jnp.mean`` / ``jnp.var``; the container detaches the
new state and writes it back after each training step.

A data-parallel trainer's dense path takes the training-mode moments over
the GLOBAL batch, as the reference's one program over a sharded batch
does.  It sets the hook ``global_batch(sum_fn, ranks)`` for the length of
its step: ``batch_sum`` then sums a per-rank partial over every rank
(``sum_fn``, an all-reduce whose backward all-reduces the gradient), and
the moments are those sums over ``ranks`` times the local row count.  The
math stays the layer's own (two passes in float32 and float64, E[x²] −
E[x]² with float32 means in bfloat16).  Without the hook ``batch_sum`` is
the identity and the moments are the local ``torch.mean`` / ``torch.var``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


#: (sum over every data-parallel rank, rank count) while a trainer's
#: dense step runs in this thread; None otherwise
_GLOBAL_BATCH: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "global_batch", default=None)


@contextlib.contextmanager
def global_batch(sum_fn: Callable[[Tensor], Tensor], ranks: int):
    """Within the block, batch statistics (BatchNormalization's moments, a
    center-loss head's class sums) are taken over every rank's rows:
    ``sum_fn`` sums a tensor over the ranks, differentiably."""
    token = _GLOBAL_BATCH.set((sum_fn, int(ranks)))
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_sum(t: Tensor) -> Tensor:
    """A per-rank partial sum over the batch, summed over every rank under
    ``global_batch`` (the identity otherwise)."""
    hook = _GLOBAL_BATCH.get()
    return t if hook is None else hook[0](t)


def _moments(x: Tensor, axes) -> tuple:
    """Training-mode batch mean and biased variance over ``axes``."""
    low = x.element_size() < 4
    acc = torch.promote_types(x.dtype, torch.float32)
    hook = _GLOBAL_BATCH.get()
    if hook is None:
        if low:
            mean = torch.mean(x, dim=axes, dtype=acc)
            mean2 = torch.mean(x * x, dim=axes, dtype=acc)
            return mean, torch.clamp_min(mean2 - mean * mean, 0.0)
        return torch.mean(x, dim=axes), torch.var(x, dim=axes, unbiased=False)
    n = math.prod(x.shape[a] for a in axes) * hook[1]
    if low:
        sums = batch_sum(torch.stack([torch.sum(x, dim=axes, dtype=acc),
                                      torch.sum(x * x, dim=axes, dtype=acc)]))
        mean, mean2 = sums[0] / n, sums[1] / n
        return mean, torch.clamp_min(mean2 - mean * mean, 0.0)
    mean = batch_sum(torch.sum(x, dim=axes)) / n
    return mean, batch_sum(torch.sum((x - mean) ** 2, dim=axes)) / n


def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float: a scalar operand, so
    no tensor is made on the device (a CUDA graph capture refuses a host
    to device copy)."""
    return float(torch.tensor(v, dtype=dtype))


def _one_minus(v: float, dtype: torch.dtype) -> float:
    """``1 - v`` with ``v`` first rounded to ``dtype``, as the reference's
    ``1 - jnp.asarray(decay, dtype)``."""
    return float(1 - torch.tensor(v, dtype=dtype))


@register_layer
@dataclasses.dataclass
class BatchNormalization(Layer):
    """BN over the trailing feature/channel axis: CNN [mb, h, w, c] per
    channel, FF [mb, f] per feature.  State ``mean`` / ``var`` are the
    running statistics (not trained by gradients)."""

    n_features: int = 0
    eps: float = 1e-5
    decay: float = 0.9
    lock_gamma_beta: bool = False

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_features == 0:
            self.n_features = in_type.channels if in_type.kind == "cnn" else in_type.size

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.ones((self.n_features,), dtype=dtype),
                "beta": torch.zeros((self.n_features,), dtype=dtype)}

    def init_state(self, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"mean": torch.zeros((self.n_features,), dtype=dtype),
                "var": torch.ones((self.n_features,), dtype=dtype)}

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        axes = tuple(range(x.ndim - 1))
        if train:
            mean, var = _moments(x, axes)
            sd = state["mean"].dtype
            d, keep = _rounded(self.decay, sd), _one_minus(self.decay, sd)
            new_state = {"mean": d * state["mean"] + keep * mean.to(sd),
                         "var": d * state["var"] + keep * var.to(sd)}
        else:
            mean, var = state["mean"].to(x.dtype), state["var"].to(x.dtype)
            new_state = state
        inv = torch.rsqrt(var.to(x.dtype) + _rounded(self.eps, x.dtype))
        y = (x - mean.to(x.dtype)) * inv
        if not self.lock_gamma_beta:
            y = y * params["gamma"].to(x.dtype) + params["beta"].to(x.dtype)
        return ForwardOut(self._act(y), new_state, mask)

    def has_params(self) -> bool:
        return not self.lock_gamma_beta


@register_layer
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Cross-channel LRN over NHWC: y = x / (k + α/n · Σ x²)^β, the sum over
    a window of ``n`` channels centred on each (zeros past the ends)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self) -> bool:
        return False

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        c = x.shape[-1]
        half = self.n // 2
        padded = F.pad(x * x, (half, half))
        window = padded[..., 0:c]
        for i in range(1, self.n):
            window = window + padded[..., i:i + c]
        denom = (self.k + (self.alpha / self.n) * window) ** self.beta
        return ForwardOut(x / denom, state, mask)


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
