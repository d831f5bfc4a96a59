"""Input preprocessors — shape adapters between layer families (mirrors
``deeplearning4j_tpu/nn/conf/preprocessors.py``).

Convolutional activations are NHWC [mb, h, w, c] and recurrent ones
[mb, t, f] (``nn/layers/convolution.py`` states the layout).  The
reshapes are tensor ops, so autograd reverses them.
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


@register_config
@dataclasses.dataclass
class CnnToFeedForward(Preprocessor):
    """[mb, h, w, c] → [mb, h·w·c], flattened in H, W, C order (the NHWC
    layout's own order; a flatten of the NCHW view would feed a Dense
    layer its inputs permuted)."""

    def apply(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], -1)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(in_type.flat_size())


@register_config
@dataclasses.dataclass
class FeedForwardToCnn(Preprocessor):
    """[mb, h·w·c] → [mb, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def apply(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_config
@dataclasses.dataclass
class CnnToRnn(Preprocessor):
    """[mb, h, w, c] → [mb, t = h, w·c]: time is the height, the features
    of a step are its row's width times channels."""

    def apply(self, x: Tensor) -> Tensor:
        mb, h, w, c = x.shape
        return x.reshape(mb, h, w * c)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(in_type.width * in_type.channels, in_type.height)


@register_config
@dataclasses.dataclass
class RnnToCnn(Preprocessor):
    """[mb, t, f] → [mb, t, f / c, c], the inverse of ``CnnToRnn``."""

    channels: int = 1

    def apply(self, x: Tensor) -> Tensor:
        mb, t, f = x.shape
        return x.reshape(mb, t, f // self.channels, self.channels)

    def output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps or 0
        return InputType.convolutional(t, in_type.size // self.channels, self.channels)


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
