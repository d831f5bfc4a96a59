"""Fused LSTM cell: the gate math of one step in one pass (mirrors
``deeplearning4j_tpu/ops/lstm_kernel.py``).

The cell's products (x·W hoisted over time, h·RW per step) stay plain
``torch.matmul``; this module covers the elementwise rest: three
sigmoids, two tanhs and the products and sums that give (h', c') from
the preactivations z [mb, 4n] in gate order ``[i|f|o|g]`` and the cell
state c [mb, n].  ``lstm_cell_fwd`` is kernel K5a and ``lstm_cell_bwd``
kernel K5b: for CUDA tensors they launch the CUDA C++ kernels in
``csrc/lstm_cell.cu`` (which replace the TPU kernels
``deeplearning4j_tpu/ops/lstm_kernel.py::_fwd_kernel`` and
``::_bwd_kernel``); for CPU tensors, and only then, they run the plain
versions ``lstm_cell_plain`` / ``lstm_cell_bwd_plain``, copies of the
reference's ``_plain_cell`` / ``_bwd_math``.

Dispatch (``fused_lstm_cell``), by the tensor's device alone:
  - a CPU tensor, of any dtype: the plain cell, differentiated by
    autograd (the reference's default, and its exact float64 path);
  - a CUDA tensor: ``LSTMCell``, whose forward is K5a and whose backward
    is K5b on the saved (z, c), as the reference's custom VJP recomputes
    the gates in ``_bwd_math``.  float32 and bfloat16 reach the kernels;
    anything they do not take raises.
The reference keeps its kernel opt-in (``DL4J_TPU_FUSED_LSTM``) because
XLA's fusion beat it on the TPU; on the card the kernel replaces about
ten eager launches per step, so it has no switch here.  The reference's
``n >= 128`` and batch-tile ``>= 8`` gates are not carried over: they are
the TPU's 128-lane and VMEM tiling rules, and a thread per (row, unit)
has no such constraint.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

Tensor = torch.Tensor

def _gates(z: Tensor, n: int):
    i = torch.sigmoid(z[:, :n])
    f = torch.sigmoid(z[:, n:2 * n])
    o = torch.sigmoid(z[:, 2 * n:3 * n])
    g = torch.tanh(z[:, 3 * n:])
    return i, f, o, g


def lstm_cell_plain(z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """K5a's plain version (the reference's ``_plain_cell``) → (h', c')."""
    i, f, o, g = _gates(z, c.shape[-1])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_cell_bwd_plain(z: Tensor, c: Tensor, dh: Tensor,
                        dcn: Tensor) -> Tuple[Tensor, Tensor]:
    """K5b's plain version (the reference's ``_bwd_math``): the closed-form
    cell backward from the (z, c) residuals, gates recomputed → (dz, dc)."""
    i, f, o, g = _gates(z, c.shape[-1])
    c_new = f * c + i * g
    tc = torch.tanh(c_new)
    do = dh * tc
    dct = dcn + dh * o * (1.0 - tc * tc)
    dz = torch.cat([
        dct * g * i * (1.0 - i),
        dct * c * f * (1.0 - f),
        do * o * (1.0 - o),
        dct * i * (1.0 - g * g),
    ], dim=1)
    return dz, dct * f


@functools.lru_cache(maxsize=None)
def _fns():
    """(fwd, bwd) C entry points of the built library, signatures set once."""
    from ..utils import cuda_build

    lib = cuda_build.load("lstm_cell")
    fwd, bwd = lib.dl4j_lstm_cell_fwd, lib.dl4j_lstm_cell_bwd
    for fn, n_ptr in ((fwd, 4), (bwd, 6)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fwd, bwd


def _check(z: Tensor, c: Tensor, *more: Tensor) -> None:
    """Raise for anything the kernels do not take: one CUDA device, f32 or
    bf16 throughout, z [mb, 4n] and the rest [mb, n], contiguous rows."""
    ts = (z, c) + more
    if not all(t.is_cuda and t.device == z.device for t in ts):
        raise ValueError("the LSTM cell kernels need every tensor on one CUDA device")
    if z.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != z.dtype for t in ts):
        raise TypeError("the LSTM cell kernels take float32 or bfloat16 tensors "
                        f"of one dtype, got {[str(t.dtype) for t in ts]}")
    if c.ndim != 2 or c.numel() == 0 or tuple(z.shape) != (c.shape[0], 4 * c.shape[1]) \
            or any(tuple(t.shape) != tuple(c.shape) for t in more):
        raise ValueError("the LSTM cell kernels take z [mb, 4n] and c [mb, n] "
                         f"(mb, n >= 1), got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the LSTM cell kernels take contiguous row-major tensors")


def _launch(fn, ins, outs, mb: int, n: int, dtype) -> None:
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins + outs), mb, n,
                int(dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"LSTM cell kernel launch failed (code {rc})")


def lstm_cell_fwd_cuda(z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch K5a (``csrc/lstm_cell.cu``) → (h', c') in the input dtype."""
    _check(z, c)
    h, c_new = torch.empty_like(c), torch.empty_like(c)
    _launch(_fns()[0], (z, c), (h, c_new), c.shape[0], c.shape[1], z.dtype)
    lstm_cell_fwd_cuda.launches += 1
    return h, c_new


lstm_cell_fwd_cuda.launches = 0


def lstm_cell_bwd_cuda(z: Tensor, c: Tensor, dh: Tensor,
                       dcn: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch K5b (``csrc/lstm_cell.cu``) → (dz, dc) in the input dtype."""
    _check(z, c, dh, dcn)
    dz, dc = torch.empty_like(z), torch.empty_like(c)
    _launch(_fns()[1], (z, c, dh, dcn), (dz, dc), c.shape[0], c.shape[1], z.dtype)
    lstm_cell_bwd_cuda.launches += 1
    return dz, dc


lstm_cell_bwd_cuda.launches = 0


def lstm_cell_fwd(z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """K5a: CPU tensors run the plain version; CUDA tensors run the kernel."""
    if z.device.type == "cpu":
        return lstm_cell_plain(z, c)
    return lstm_cell_fwd_cuda(z, c)


def lstm_cell_bwd(z: Tensor, c: Tensor, dh: Tensor, dcn: Tensor) -> Tuple[Tensor, Tensor]:
    """K5b: CPU tensors run the plain version; CUDA tensors run the kernel."""
    if z.device.type == "cpu":
        return lstm_cell_bwd_plain(z, c, dh, dcn)
    return lstm_cell_bwd_cuda(z, c, dh, dcn)


class LSTMCell(torch.autograd.Function):
    """The reference's custom VJP around the fused cell: forward K5a,
    backward K5b from the saved (z, c).  An unused output's cotangent
    (the last step's dc') arrives as zeros (``materialize_grads``)."""

    @staticmethod
    def forward(ctx, z: Tensor, c: Tensor):
        ctx.set_materialize_grads(True)
        ctx.save_for_backward(z, c)
        return lstm_cell_fwd(z, c)

    @staticmethod
    def backward(ctx, dh: Tensor, dcn: Tensor):
        z, c = ctx.saved_tensors
        # a step's dh is a strided slice of the stacked outputs' gradient
        return lstm_cell_bwd(z, c, dh.to(z.dtype).contiguous(),
                             dcn.to(z.dtype).contiguous())


def fused_lstm_cell(z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """(h', c') from preactivations z [mb, 4n] (gates ``[i|f|o|g]``) and cell
    state c [mb, n]: the plain cell for CPU tensors, else K5a/K5b."""
    if z.device.type == "cpu":
        return lstm_cell_plain(z, c)
    return LSTMCell.apply(z.contiguous(), c.contiguous())
