"""Pooling family (mirrors ``deeplearning4j_tpu/nn/layers/pooling.py``:
``Subsampling2D``, ``Subsampling1D`` and ``GlobalPooling`` with its rnn
masks).  Max, avg, sum and pnorm pooling over NHWC activations (see
``convolution.py`` for the layout).  ``same`` pads as XLA's ``SAME``
does, the odd pad at the end: max pooling pads with ``-inf``, the others
with zeros, and avg pooling then divides by the count of real elements
in each window, not by the window's size.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer
from .convolution import _conv_out_size, _pad_nhwc, _pair, spatial_pads

Tensor = torch.Tensor


def _window_sum(x: Tensor, kernel, stride) -> Tensor:
    """Sum over each window of an NHWC tensor, padding 0 → NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride, divisor_override=1)
    return y.permute(0, 2, 3, 1)


def _pool2d(x: Tensor, kind: str, kernel, stride, mode: str, pnorm: int = 2) -> Tensor:
    """``reduce_window`` pooling of an NHWC tensor under ``mode``'s padding."""
    kernel, stride = tuple(kernel), tuple(stride)
    pads = spatial_pads(x.shape[1:3], kernel, stride, (1, 1), mode)
    if kind == "max":
        xp = _pad_nhwc(x, pads, float("-inf"))
        return F.max_pool2d(xp.permute(0, 3, 1, 2), kernel, stride).permute(0, 2, 3, 1)
    if kind in ("avg", "sum"):
        y = _window_sum(_pad_nhwc(x, pads), kernel, stride)
        if kind == "sum":
            return y
        if mode != "same":
            return y / (kernel[0] * kernel[1])
        ones = x.new_ones((1,) + tuple(x.shape[1:3]) + (1,))
        return y / _window_sum(_pad_nhwc(ones, pads), kernel, stride)
    if kind == "pnorm":
        p = float(pnorm)
        y = _window_sum(_pad_nhwc(x.abs() ** p, pads), kernel, stride)
        return y ** (1.0 / p)
    raise ValueError(f"unknown pooling type {kind}")


@register_layer
@dataclasses.dataclass
class Subsampling2D(Layer):
    """2-D pooling over NHWC activations."""

    pooling: str = "max"
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        h = _conv_out_size(in_type.height, self.kernel[0], self.stride[0], self.convolution_mode)
        w = _conv_out_size(in_type.width, self.kernel[1], self.stride[1], self.convolution_mode)
        return InputType.convolutional(h, w, in_type.channels)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        y = _pool2d(x, self.pooling, self.kernel, self.stride, self.convolution_mode, self.pnorm)
        return ForwardOut(y, state, mask)


@register_layer
@dataclasses.dataclass
class Subsampling1D(Layer):
    """1-D pooling over [mb, t, f] along time."""

    pooling: str = "max"
    kernel: int = 2
    stride: int = 2
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps
        if t is not None:
            t = _conv_out_size(t, self.kernel, self.stride, self.convolution_mode)
        return InputType.recurrent(in_type.size, t)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        y = _pool2d(x[:, :, None, :], self.pooling, (self.kernel, 1), (self.stride, 1),
                    self.convolution_mode, self.pnorm)
        return ForwardOut(y[:, :, 0, :], state, mask)


@register_layer
@dataclasses.dataclass
class GlobalPooling(Layer):
    """Global pooling: CNN [mb, h, w, c] → [mb, c], RNN [mb, t, f] → [mb, f]
    with the per-step mask honoured (and consumed)."""

    pooling: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        if in_type.kind == "rnn":
            return InputType.feed_forward(in_type.size)
        if in_type.kind == "cnn":
            return InputType.feed_forward(in_type.channels)
        return in_type

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        if x.ndim == 4:
            axes, m = (1, 2), None
        elif x.ndim == 3:
            axes, m = (1,), mask
        else:
            raise ValueError(f"GlobalPooling expects rank 3/4, got {tuple(x.shape)}")
        p = float(self.pnorm)
        if m is not None:
            mx = m[..., None].to(x.dtype)
            if self.pooling == "max":
                y = torch.amax(x.masked_fill(mx <= 0, float("-inf")), dim=axes)
            elif self.pooling == "sum":
                y = torch.sum(x * mx, dim=axes)
            elif self.pooling == "avg":
                y = torch.sum(x * mx, dim=axes) / torch.clamp_min(torch.sum(mx, dim=axes), 1.0)
            elif self.pooling == "pnorm":
                y = torch.sum((x.abs() * mx) ** p, dim=axes) ** (1.0 / p)
            else:
                raise ValueError(self.pooling)
        elif self.pooling == "max":
            y = torch.amax(x, dim=axes)
        elif self.pooling == "sum":
            y = torch.sum(x, dim=axes)
        elif self.pooling == "avg":
            y = torch.mean(x, dim=axes)
        elif self.pooling == "pnorm":
            y = torch.sum(x.abs() ** p, dim=axes) ** (1.0 / p)
        else:
            raise ValueError(self.pooling)
        return ForwardOut(y, state, None)
