"""Dropout variants, weight noise and parameter constraints (mirrors
``deeplearning4j_tpu/nn/conf/regularizers.py``).

A layer's ``dropout`` field takes a float (classic inverted dropout, the
drop probability) or one of the dropout configs below; ``weight_noise``
holds a weight-noise config applied to the weight parameters on each
training forward; ``constraints`` lists constraints applied after each
parameter update.  All are registered configs, so a layer's JSON carries
them both ways.

Every random number comes from one of two draw functions, ``bernoulli``
and ``normal``, which take the network's ``torch.Generator`` (on the
network's device).  The draws are made in the reference's order (layer
by layer; within weight noise, by sorted parameter name), so a test that
replaces these two functions and the reference's ``jax.random.bernoulli``
/ ``jax.random.normal`` with one shared source of numbers feeds both
packages the same noise.  The streams themselves differ: torch's Philox
is not jax's threefry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from ..layers.base import register_config

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------


def bernoulli(generator: torch.Generator, p: Union[float, Tensor], shape) -> Tensor:
    """A bool tensor of ``shape``, True with probability ``p`` (a float or
    a tensor broadcast to ``shape``), on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return u < p


def normal(generator: torch.Generator, shape) -> Tensor:
    """A float32 N(0, 1) tensor of ``shape`` on the generator's device."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device)


def _zero(x: Tensor) -> Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# dropout family (input dropout)
# ---------------------------------------------------------------------------


@register_config
@dataclasses.dataclass
class Dropout:
    """Classic inverted dropout; ``p`` is the DROP probability."""

    p: float = 0.5

    def apply(self, generator, x: Tensor, train: bool) -> Tensor:
        if not train or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = bernoulli(generator, keep, x.shape)
        return torch.where(mask, x / keep, _zero(x))


@register_config
@dataclasses.dataclass
class SpatialDropout:
    """Channel-wise dropout: one draw per (example, channel), broadcast over
    the axes between ([mb, t, f] → mask [mb, 1, f])."""

    p: float = 0.5

    def apply(self, generator, x: Tensor, train: bool) -> Tensor:
        if not train or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        mask = bernoulli(generator, keep, shape)
        return torch.where(mask, x / keep, _zero(x))


@register_config
@dataclasses.dataclass
class AlphaDropout:
    """SELU-compatible dropout: dropped units take α' = −λα, then an affine
    correction (a, b) restores zero mean and unit variance."""

    p: float = 0.5

    _LAMBDA = 1.0507009873554805
    _ALPHA = 1.6732632423543772

    def apply(self, generator, x: Tensor, train: bool) -> Tensor:
        if not train or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        alpha_p = -self._LAMBDA * self._ALPHA
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        mask = bernoulli(generator, keep, x.shape)
        held = torch.where(mask, x, torch.full((), alpha_p, dtype=x.dtype, device=x.device))
        return (a * held + b).to(x.dtype)


@register_config
@dataclasses.dataclass
class GaussianDropout:
    """Multiplicative N(1, rate/(1−rate)) noise."""

    rate: float = 0.5

    def apply(self, generator, x: Tensor, train: bool) -> Tensor:
        if not train or self.rate <= 0.0:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = 1.0 + std * normal(generator, x.shape)
        return x * noise.to(x.dtype)


@register_config
@dataclasses.dataclass
class GaussianNoise:
    """Additive N(0, stddev²) noise."""

    stddev: float = 0.1

    def apply(self, generator, x: Tensor, train: bool) -> Tensor:
        if not train or self.stddev <= 0.0:
            return x
        return x + self.stddev * normal(generator, x.shape).to(x.dtype)


def apply_dropout(dropout, generator, x: Tensor, train: bool) -> Tensor:
    """A layer's ``dropout`` field: a float is classic dropout, a config
    its own ``apply``."""
    if dropout is None:
        return x
    if isinstance(dropout, (int, float)):
        # graftcheck: disable=GC101 (the isinstance guard above makes dropout a STATIC Python number here, not a tensor)
        return Dropout(float(dropout)).apply(generator, x, train) if dropout > 0 else x
    return dropout.apply(generator, x, train)


# ---------------------------------------------------------------------------
# weight noise (applied to weight parameters per training forward)
# ---------------------------------------------------------------------------

#: parameter keys the noise and the constraints leave alone (biases and
#: normalization statistics)
WEIGHT_KEYS_EXCLUDED = ("b", "vb", "hb", "beta", "gamma", "mean", "var")


def _is_weight(key: str) -> bool:
    return key not in WEIGHT_KEYS_EXCLUDED


@register_config
@dataclasses.dataclass
class DropConnect:
    """Per-weight Bernoulli masking; ``p`` is the RETAIN probability."""

    p: float = 0.5

    def apply(self, generator, params: Dict[str, Tensor], train: bool) -> Dict[str, Tensor]:
        if not train:
            return params
        out = dict(params)
        for k, v in sorted(params.items()):
            if _is_weight(k):
                mask = bernoulli(generator, self.p, v.shape)
                out[k] = torch.where(mask, v, _zero(v))
        return out


@register_config
@dataclasses.dataclass
class WeightNoise:
    """Additive or multiplicative gaussian weight noise."""

    stddev: float = 0.01
    additive: bool = True
    mean: float = 0.0

    def apply(self, generator, params: Dict[str, Tensor], train: bool) -> Dict[str, Tensor]:
        if not train:
            return params
        out = dict(params)
        for k, v in sorted(params.items()):
            if _is_weight(k):
                noise = (self.mean + self.stddev * normal(generator, v.shape)).to(v.dtype)
                out[k] = v + noise if self.additive else v * noise
        return out


def apply_weight_noise(noise, generator, params: Dict[str, Tensor],
                       train: bool) -> Dict[str, Tensor]:
    if noise is None or not params:
        return params
    return noise.apply(generator, params, train)


def maybe_weight_noise(layer, params: Dict[str, Tensor], train: bool,
                       generator: Optional[torch.Generator]) -> Dict[str, Tensor]:
    """A layer's ``weight_noise`` applied to its parameters before its
    forward in training (the container calls this)."""
    if not train or layer.weight_noise is None or generator is None or not params:
        return params
    return layer.weight_noise.apply(generator, params, train)


# ---------------------------------------------------------------------------
# constraints (applied after each parameter update)
# ---------------------------------------------------------------------------


def _norm_axes(v: Tensor) -> Tuple[int, ...]:
    """Every axis but the last (output) one: per-output-unit norms."""
    return tuple(range(max(v.ndim - 1, 1)))


def _unit_norms(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=_norm_axes(v), keepdim=True))


@register_config
@dataclasses.dataclass
class MaxNormConstraint:
    """Clip each unit's L2 norm to ``max_norm``."""

    max_norm: float = 2.0

    def apply(self, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        out = dict(params)
        for k, v in params.items():
            if _is_weight(k) and v.ndim >= 2:
                n = _unit_norms(v)
                out[k] = torch.where(n > self.max_norm,
                                     v * (self.max_norm / torch.clamp_min(n, 1e-12)), v)
        return out


@register_config
@dataclasses.dataclass
class MinMaxNormConstraint:
    """Scale each unit's norm into [min_norm, max_norm], blended by ``rate``."""

    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def apply(self, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        out = dict(params)
        for k, v in params.items():
            if _is_weight(k) and v.ndim >= 2:
                n = _unit_norms(v)
                clipped = torch.clamp(n, self.min_norm, self.max_norm)
                scale = 1.0 - self.rate + self.rate * clipped / torch.clamp_min(n, 1e-12)
                out[k] = v * scale
        return out


@register_config
@dataclasses.dataclass
class UnitNormConstraint:
    """Each unit's norm set to 1."""

    def apply(self, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        out = dict(params)
        for k, v in params.items():
            if _is_weight(k) and v.ndim >= 2:
                out[k] = v / torch.clamp_min(_unit_norms(v), 1e-12)
        return out


@register_config
@dataclasses.dataclass
class NonNegativeConstraint:
    """Every parameter clamped at >= 0."""

    def apply(self, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: torch.clamp_min(v, 0.0) for k, v in params.items()}


def apply_constraints(constraints, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    if not constraints or not params:
        return params
    for c in constraints:
        params = c.apply(params)
    return params
