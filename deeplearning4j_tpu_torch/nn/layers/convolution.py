"""Convolution family (mirrors ``deeplearning4j_tpu/nn/layers/convolution.py``:
``Convolution2D``, ``Convolution1D``, ``Deconvolution2D``,
``SeparableConvolution2D``, ``ZeroPadding2D`` / ``1D``, ``Cropping2D`` and
``Upsampling2D`` / ``1D``).

Layout, decided once here for all of the port's conv code:

  - Activations stay in the reference's layouts at every boundary: CNN
    tensors are logically NHWC ``[mb, h, w, c]``, temporal ones
    ``[mb, t, f]``.  Inside a layer ``x.permute(0, 3, 1, 2)`` is an NCHW
    view with channels-last strides, which cuDNN convolves without a
    copy; the result is permuted back, again a view.
  - Kernels stay HWIO in ``params`` (``[kh, kw, in, out]``; 1-D: WIO), as
    the reference stores them, so checkpoints, the weight bridge, the
    updater state and the fused update's flat buffer need no transpose.
    The convolution takes ``W.permute(3, 2, 0, 1)``; autograd carries the
    gradient back in HWIO.  The price is one weight copy per conv per call.
  - ``convolution_mode``: ``same`` pads as XLA's ``SAME`` does (output
    ``ceil(n / s)``, the odd pad at the END), ``truncate`` and ``strict``
    pad nothing (floor; ``strict`` refuses sizes that leave a remainder).
    torch's symmetric ``padding=`` cannot express an odd total (ResNet-50's
    7x7 / 2 stem pads (2, 3) on 224), so such a pad is an explicit
    ``F.pad`` and the convolution runs with padding 0.
  - ``Deconvolution2D`` is ``lax.conv_transpose`` with its default
    ``transpose_kernel=False``: the kernel is used unflipped over the input
    dilated by the stride (zeros inserted), padded as jax pads the
    transpose.  It is not ``conv_transpose2d``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...ops.initializers import init_weight
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_out_size(size: int, k: int, s: int, mode: str, dilation: int = 1) -> int:
    eff_k = (k - 1) * dilation + 1
    if mode == "same":
        return -(-size // s)
    out = (size - eff_k) // s + 1
    if mode == "strict" and (size - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.Strict: size {size} kernel {k} stride {s} leaves remainder "
            f"(reference ConvolutionMode semantics)")
    return out


def spatial_pads(sizes: Sequence[int], kernel, stride, dilation, mode: str):
    """Per-axis (before, after) pads of ``mode`` over the spatial sizes:
    none for ``truncate`` / ``strict``; for ``same`` XLA's ``SAME``, which
    puts the odd element after."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = 0
        if mode == "same":
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_nhwc(x: Tensor, pads, value: float = 0.0) -> Tensor:
    """Pad the spatial axes of an [mb, *spatial, c] tensor (a no-op when
    every pad is 0)."""
    if not any(a or b for a, b in pads):
        return x
    flat = [0, 0]   # the channel axis
    for a, b in reversed(pads):
        flat += [a, b]
    return F.pad(x, flat, value=value)


def conv2d_nhwc(x: Tensor, w_hwio: Tensor, stride, dilation, mode: str,
                groups: int = 1) -> Tensor:
    """``lax.conv_general_dilated(x, w, stride, mode, rhs_dilation,
    ("NHWC", "HWIO", "NHWC"), feature_group_count=groups)`` on an NHWC
    tensor and an HWIO kernel → NHWC.  A symmetric pad goes to the
    convolution itself, an asymmetric one to ``F.pad`` first."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    pads = spatial_pads(x.shape[1:3], (kh, kw), stride, dilation, mode)
    if all(a == b for a, b in pads):
        padding = tuple(a for a, _ in pads)
    else:
        x, padding = _pad_nhwc(x, pads), (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), stride=tuple(stride),
                 padding=padding, dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def _bias(y: Tensor, params, has_bias: bool) -> Tensor:
    return y + params["b"].to(y.dtype) if has_bias else y


@register_layer
@dataclasses.dataclass
class Convolution2D(Layer):
    """2-D convolution, NHWC activations, HWIO kernel."""

    wants = "cnn"

    n_in: int = 0   # input channels
    n_out: int = 0  # output channels
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)
        self.dilation = _pair(self.dilation)

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.channels

    def output_type(self, in_type: InputType) -> InputType:
        h = _conv_out_size(in_type.height, self.kernel[0], self.stride[0], self.convolution_mode, self.dilation[0])
        w = _conv_out_size(in_type.width, self.kernel[1], self.stride[1], self.convolution_mode, self.dilation[1])
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        kh, kw = self.kernel
        fan_in = self.n_in * kh * kw
        fan_out = self.n_out * kh * kw
        p = {"W": init_weight((kh, kw, self.n_in, self.n_out), self._winit(), fan_in,
                              fan_out, dtype, generator)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return p

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        y = conv2d_nhwc(x, params["W"].to(x.dtype), self.stride, self.dilation,
                        self.convolution_mode)
        return ForwardOut(self._act(_bias(y, params, self.has_bias)), state, mask)


@register_layer
@dataclasses.dataclass
class Convolution1D(Layer):
    """1-D (temporal) convolution over [mb, t, f], WIO kernel."""

    n_in: int = 0
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    dilation: int = 1
    convolution_mode: str = "same"
    has_bias: bool = True

    def infer_nin(self, in_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = in_type.size

    def output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps
        if t is not None:
            t = _conv_out_size(t, self.kernel, self.stride, self.convolution_mode, self.dilation)
        return InputType.recurrent(self.n_out, t)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        fan_in = self.n_in * self.kernel
        fan_out = self.n_out * self.kernel
        p = {"W": init_weight((self.kernel, self.n_in, self.n_out), self._winit(), fan_in,
                              fan_out, dtype, generator)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return p

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        (pad,) = spatial_pads(x.shape[1:2], (self.kernel,), (self.stride,),
                              (self.dilation,), self.convolution_mode)
        if pad[0] == pad[1]:
            padding = pad[0]
        else:
            x, padding = _pad_nhwc(x, [pad]), 0
        y = F.conv1d(x.permute(0, 2, 1), params["W"].to(x.dtype).permute(2, 1, 0),
                     stride=self.stride, padding=padding, dilation=self.dilation)
        y = y.permute(0, 2, 1)
        return ForwardOut(self._act(_bias(y, params, self.has_bias)), state, mask)


def _transpose_pads(k: int, s: int, mode: str) -> Tuple[int, int]:
    """jax's ``_conv_transpose_padding`` for an effective kernel size ``k``."""
    if mode == "same":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


@register_layer
@dataclasses.dataclass
class Deconvolution2D(Convolution2D):
    """Transposed convolution as ``lax.conv_transpose`` computes it with
    ``transpose_kernel=False`` (see the module's docstring)."""

    def output_type(self, in_type: InputType) -> InputType:
        if self.convolution_mode == "same":
            h = in_type.height * self.stride[0]
            w = in_type.width * self.stride[1]
        else:
            h = (in_type.height - 1) * self.stride[0] + (self.kernel[0] - 1) * self.dilation[0] + 1
            w = (in_type.width - 1) * self.stride[1] + (self.kernel[1] - 1) * self.dilation[1] + 1
        return InputType.convolutional(h, w, self.n_out)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        (sh, sw), (dh, dw) = self.stride, self.dilation
        mb, h, w, c = x.shape
        if sh > 1 or sw > 1:   # the input dilated by the stride
            xd = x.new_zeros((mb, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
            xd[:, ::sh, ::sw] = x
            x = xd
        pads = [_transpose_pads((k - 1) * d + 1, s, self.convolution_mode)
                for k, s, d in zip(self.kernel, self.stride, self.dilation)]
        x = _pad_nhwc(x, pads)
        y = F.conv2d(x.permute(0, 3, 1, 2), params["W"].to(x.dtype).permute(3, 2, 0, 1),
                     dilation=(dh, dw)).permute(0, 2, 3, 1)
        return ForwardOut(self._act(_bias(y, params, self.has_bias)), state, mask)


@register_layer
@dataclasses.dataclass
class SeparableConvolution2D(Convolution2D):
    """Depthwise then pointwise convolution.  The depthwise kernel ``dW``
    is HWIO with I = 1 and O = n_in·depth_multiplier, grouped by input
    channel: output channel j reads input channel j // depth_multiplier,
    which is ``groups=n_in`` over the weight ``[n_in·dm, 1, kh, kw]``."""

    depth_multiplier: int = 1

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        kh, kw = self.kernel
        dm = self.depth_multiplier
        fan_in_d = kh * kw
        p = {
            "dW": init_weight((kh, kw, 1, self.n_in * dm), self._winit(), fan_in_d,
                              fan_in_d * dm, dtype, generator),
            "pW": init_weight((1, 1, self.n_in * dm, self.n_out), self._winit(),
                              self.n_in * dm, self.n_out, dtype, generator),
        }
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return p

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        y = conv2d_nhwc(x, params["dW"].to(x.dtype), self.stride, self.dilation,
                        self.convolution_mode, groups=self.n_in)
        y = conv2d_nhwc(y, params["pW"].to(x.dtype), (1, 1), (1, 1), "truncate")
        return ForwardOut(self._act(_bias(y, params, self.has_bias)), state, mask)


@register_layer
@dataclasses.dataclass
class ZeroPadding2D(Layer):
    """Spatial zero padding; ``padding`` = (top, bottom, left, right)."""

    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        t, b, l, r = self.padding
        return InputType.convolutional(in_type.height + t + b, in_type.width + l + r, in_type.channels)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        t, b, l, r = self.padding
        return ForwardOut(_pad_nhwc(x, [(t, b), (l, r)]), state, mask)


@register_layer
@dataclasses.dataclass
class ZeroPadding1D(Layer):
    """Temporal zero padding of [mb, t, f]."""

    padding: Tuple[int, int] = (1, 1)

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps
        if t is not None:
            t = t + self.padding[0] + self.padding[1]
        return InputType.recurrent(in_type.size, t)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(_pad_nhwc(x, [tuple(self.padding)]), state, mask)


@register_layer
@dataclasses.dataclass
class Cropping2D(Layer):
    """Spatial cropping; ``cropping`` = (top, bottom, left, right)."""

    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        t, b, l, r = self.cropping
        return InputType.convolutional(in_type.height - t - b, in_type.width - l - r, in_type.channels)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        t, b, l, r = self.cropping
        h, w = x.shape[1], x.shape[2]
        return ForwardOut(x[:, t:h - b, l:w - r, :], state, mask)


@register_layer
@dataclasses.dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size`` = (sh, sw)."""

    size: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.size = _pair(self.size)

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.convolutional(in_type.height * self.size[0], in_type.width * self.size[1], in_type.channels)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        y = x.repeat_interleave(self.size[0], dim=1).repeat_interleave(self.size[1], dim=2)
        return ForwardOut(y, state, mask)


@register_layer
@dataclasses.dataclass
class Upsampling1D(Layer):
    """Nearest-neighbour upsampling of [mb, t, f] along time."""

    size: int = 2

    def has_params(self) -> bool:
        return False

    def output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps
        return InputType.recurrent(in_type.size, None if t is None else t * self.size)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        return ForwardOut(x.repeat_interleave(self.size, dim=1), state, mask)
