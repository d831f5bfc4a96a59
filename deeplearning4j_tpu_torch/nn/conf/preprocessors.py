"""Input preprocessors — shape adapters between layer families (mirrors
``deeplearning4j_tpu/nn/conf/preprocessors.py``).

Recurrent activations are [mb, t, f].  The reshapes are tensor ops, so
autograd reverses them.  The four preprocessors that touch convolutional
activations (``CnnToFeedForward``, ``FeedForwardToCnn``, ``CnnToRnn``,
``RnnToCnn``) wait for the conv path (ROADMAP queue 5), where the NHWC or
NCHW layout is decided once for all conv code: their configs parse, so a
checkpoint names them, and building a network with one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..layers.base import register_config
from . import regularizers
from .inputs import InputType

Tensor = torch.Tensor


@dataclasses.dataclass
class Preprocessor:
    #: stochastic preprocessors take the network's generator in training
    wants_rng = False

    def apply(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def output_type(self, in_type: InputType) -> InputType:
        raise NotImplementedError


class _WaitsForConv(Preprocessor):
    """A convolutional preprocessor: parsed, and refused when a network is
    built with it."""

    def _refuse(self, *_):
        raise NotImplementedError(
            f"{type(self).__name__}: the convolutional preprocessors are not "
            "ported yet (ROADMAP queue 5, with the conv layers and their "
            "NHWC/NCHW layout)")

    apply = _refuse
    output_type = _refuse


@register_config
@dataclasses.dataclass
class CnnToFeedForward(_WaitsForConv):
    pass


@register_config
@dataclasses.dataclass
class FeedForwardToCnn(_WaitsForConv):
    height: int = 0
    width: int = 0
    channels: int = 0


@register_config
@dataclasses.dataclass
class CnnToRnn(_WaitsForConv):
    pass


@register_config
@dataclasses.dataclass
class RnnToCnn(_WaitsForConv):
    channels: int = 1


@register_config
@dataclasses.dataclass
class RnnToFeedForward(Preprocessor):
    """[mb, t, f] → [mb*t, f]."""

    def apply(self, x: Tensor) -> Tensor:
        return x.reshape(-1, x.shape[-1])

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(in_type.size)


@register_config
@dataclasses.dataclass
class FeedForwardToRnn(Preprocessor):
    """[mb*t, f] → [mb, t, f]."""

    timesteps: int = 0

    def apply(self, x: Tensor) -> Tensor:
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(in_type.size, self.timesteps)


def _per_example(v: Tensor, x: Tensor) -> Tensor:
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _std(flat: Tensor) -> Tensor:
    """Population standard deviation per row (``jnp.std``'s ddof 0)."""
    return torch.std(flat, dim=1, unbiased=False)


@register_config
@dataclasses.dataclass
class UnitVariance(Preprocessor):
    """Per-example unit variance."""

    def apply(self, x: Tensor) -> Tensor:
        std = _per_example(_std(x.reshape(x.shape[0], -1)), x)
        return x / torch.clamp_min(std, 1e-8)

    def output_type(self, in_type: InputType) -> InputType:
        return in_type


@register_config
@dataclasses.dataclass
class ZeroMean(Preprocessor):
    """Per-example zero mean (optionally unit variance too)."""

    unit_variance: bool = False

    def apply(self, x: Tensor) -> Tensor:
        flat = x.reshape(x.shape[0], -1)
        y = x - _per_example(torch.mean(flat, dim=1), x)
        if self.unit_variance:
            y = y / torch.clamp_min(_per_example(_std(flat), x), 1e-8)
        return y

    def output_type(self, in_type: InputType) -> InputType:
        return in_type


@register_config
@dataclasses.dataclass
class Composable(Preprocessor):
    """A chain of preprocessors."""

    steps: list = dataclasses.field(default_factory=list)

    def apply(self, x: Tensor) -> Tensor:
        for s in self.steps:
            x = s.apply(x)
        return x

    def output_type(self, in_type: InputType) -> InputType:
        for s in self.steps:
            in_type = s.output_type(in_type)
        return in_type


@register_config
@dataclasses.dataclass
class BinomialSampling(Preprocessor):
    """Bernoulli-sample activations in [0, 1].  In training the network
    passes its generator, so every step draws fresh noise; outside
    training a generator seeded with ``seed`` gives a fixed sample."""

    seed: int = 12345
    wants_rng = True

    def apply(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(int(self.seed))
        p = torch.clamp(x, 0.0, 1.0)
        return regularizers.bernoulli(generator, p, p.shape).to(x.dtype)

    def output_type(self, in_type: InputType) -> InputType:
        return in_type
