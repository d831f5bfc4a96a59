"""The LSTM layer's step loop and its cell backward as kernels (mirrors
``deeplearning4j_tpu/ops/lstm_kernel.py``).

The standard cell (gate order ``[i|f|o|g]``, sigmoid gates, tanh) over a
sequence: for each step t (backwards with ``reverse``),
z_t = zx_t + h_{t-1} @ RW + b from the hoisted input projection zx
[mb, T, 4n], then (h, c) from the cell and, with a mask [mb, T], the hold
m·new + (1 - m)·old.  ``lstm_seq_fwd`` is kernel K5a: on CUDA tensors the
whole loop of one layer is one persistent launch of ``csrc/lstm_cell.cu``
(which replaces the TPU kernel ``deeplearning4j_tpu/ops/lstm_kernel.py::
_fwd_kernel``, a cell step inside ``lax.scan`` that XLA fused with h·RW and
the gate sums; the card has no such fusion, and the reference module
names this seam for a multi-step-fused variant).  ``lstm_cell_bwd`` is
kernel K5b (``::_bwd_kernel``), the closed-form cell backward.  For CPU
tensors, and only then, they run the plain versions
``lstm_seq_fwd_plain`` / ``lstm_cell_bwd_plain`` (copies of the
reference's ``_plain_cell`` / ``_bwd_math`` around the plain step).

Dispatch (``lstm_sequence``), by the tensor's device and dtype:
  - a CPU tensor, of any dtype, or a float64 one on any device:
    ``lstm_sequence_plain``, the per-step loop differentiated by autograd
    (the reference's default, and its exact float64 path: its
    ``_use_pallas`` never sends float64 to the kernel either);
  - a float32, bfloat16 or float16 CUDA tensor: ``LSTMSequence``, whose forward is
    K5a and whose backward is one reverse loop of K5b and the dz·RWᵀ
    product per step, then dRW, db and dzx each in one call over all
    steps.  Anything else the kernels do not take raises.
The reference keeps its kernel opt-in (``DL4J_TPU_FUSED_LSTM``) because
XLA's fusion beat it on the TPU; on the card K5a replaces four launches a
step, so it has no switch here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
Carry = Tuple[Tensor, Tensor]


def _gates(z: Tensor, n: int):
    i = torch.sigmoid(z[:, :n])
    f = torch.sigmoid(z[:, n:2 * n])
    o = torch.sigmoid(z[:, 2 * n:3 * n])
    g = torch.tanh(z[:, 3 * n:])
    return i, f, o, g


def lstm_cell_plain(z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """The cell of one step (the reference's ``_plain_cell``) → (h', c')."""
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


def hold(mask_t: Optional[Tensor], new: Tensor, old: Tensor) -> Tensor:
    """A masked step keeps the old state: m·new + (1 - m)·old."""
    if mask_t is None:
        return new
    m = mask_t[:, None].to(new.dtype)
    return m * new + (1 - m) * old


def _steps(t_len: int, reverse: bool):
    return range(t_len - 1, -1, -1) if reverse else range(t_len)


def _plain_loop(zx, RW, b, h0, c0, mask, reverse, keep):
    """The per-step loop: ``torch.matmul``, the two adds, the cell and the
    hold.  With ``keep`` it also gathers every step's z and c."""
    t_len = zx.shape[1]
    h, c = h0, c0
    hs = [None] * t_len
    zs, cs = ([None] * t_len, [None] * t_len) if keep else (None, None)
    for t in _steps(t_len, reverse):
        z = zx[:, t] + h @ RW + b
        h_new, c_new = lstm_cell_plain(z, c)
        m = None if mask is None else mask[:, t]
        h, c = hold(m, h_new, h), hold(m, c_new, c)
        hs[t] = h
        if keep:
            zs[t], cs[t] = z, c
    return hs, zs, cs, h, c


def lstm_sequence_plain(zx: Tensor, RW: Tensor, b: Tensor, h0: Tensor, c0: Tensor,
                        mask: Optional[Tensor] = None,
                        reverse: bool = False) -> Tuple[Tensor, Carry]:
    """K5a's plain version, the per-step loop under autograd:
    zx [mb, T, 4n] → (hs [mb, T, n], (h_T, c_T))."""
    hs, _, _, h, c = _plain_loop(zx, RW, b, h0, c0, mask, reverse, keep=False)
    return torch.stack(hs, dim=1), (h, c)


def lstm_seq_fwd_plain(zx: Tensor, RW: Tensor, b: Tensor, h0: Tensor, c0: Tensor,
                       mask: Optional[Tensor] = None, reverse: bool = False):
    """K5a's outputs from the plain loop: (hs [mb, T, n], z [T, mb, 4n],
    c [T, mb, n] of every step, h_T, c_T)."""
    hs, zs, cs, h, c = _plain_loop(zx, RW, b, h0, c0, mask, reverse, keep=True)
    return torch.stack(hs, dim=1), torch.stack(zs), torch.stack(cs), h, c


@functools.lru_cache(maxsize=None)
def _fns():
    """(seq_fwd, cell_bwd) C entry points of the built library, signatures
    set once."""
    from ..utils import cuda_build

    lib = cuda_build.load("lstm_cell")
    fwd, bwd = lib.dl4j_lstm_seq_fwd, lib.dl4j_lstm_cell_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fwd, bwd


#: the kernels' dtype codes (the C entries' ``dtype`` argument)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_tensors(what: str, ts) -> None:
    """One CUDA device, float32, bfloat16 or float16 throughout, contiguous."""
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"the {what} needs every tensor on one CUDA device")
    if ts[0].dtype not in _DTYPE_CODE or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"the {what} takes float32, bfloat16 or float16 tensors of one "
                        f"dtype, got {[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"the {what} takes contiguous row-major tensors")


def _check(z: Tensor, c: Tensor, *more: Tensor) -> None:
    """Raise for anything K5b does not take: z [mb, 4n] and the rest
    [mb, n] on one CUDA device, f32, bf16 or f16, contiguous rows."""
    ts = (z, c) + more
    _check_tensors("LSTM cell kernels", ts)
    if c.ndim != 2 or c.numel() == 0 or tuple(z.shape) != (c.shape[0], 4 * c.shape[1]) \
            or any(tuple(t.shape) != tuple(c.shape) for t in more):
        raise ValueError("the LSTM cell kernels take z [mb, 4n] and c [mb, n] "
                         f"(mb, n >= 1), got {[tuple(t.shape) for t in ts]}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lstm_seq_fwd_cuda(zx: Tensor, RW: Tensor, b: Tensor, h0: Tensor, c0: Tensor,
                      mask: Optional[Tensor] = None, reverse: bool = False):
    """Launch K5a (``csrc/lstm_cell.cu``) over the whole sequence →
    (hs [mb, T, n], z [T, mb, 4n], c [T, mb, n], h_T, c_T) in the input
    dtype.  ``lstm_seq_fwd_cuda.plan`` holds the last launch's (grid,
    RW resident in shared memory)."""
    ts = (zx, RW, b, h0, c0)
    _check_tensors("LSTM sequence kernel", ts)
    if mask is not None and mask.device != zx.device:
        raise ValueError("the LSTM sequence kernel needs the mask on zx's CUDA device")
    mb, n = h0.shape if h0.ndim == 2 else (0, 0)
    t_len = zx.shape[1] if zx.ndim == 3 else 0
    if (mb < 1 or n < 1 or t_len < 1 or tuple(zx.shape) != (mb, t_len, 4 * n)
            or tuple(RW.shape) != (n, 4 * n) or tuple(b.shape) != (4 * n,)
            or tuple(c0.shape) != (mb, n)
            or (mask is not None and tuple(mask.shape) != (mb, t_len))):
        raise ValueError("the LSTM sequence kernel takes zx [mb, T, 4n], RW [n, 4n], b [4n], "
                         "h0 and c0 [mb, n] and a mask [mb, T] (mb, T, n >= 1), got "
                         f"{[tuple(t.shape) for t in ts]}")
    dev = zx.device
    # the mask as the plain version applies it (m in the compute dtype), in f32
    m = None if mask is None else mask.to(zx.dtype).float().contiguous()
    hs = torch.empty((mb, t_len, n), dtype=zx.dtype, device=dev)
    zs = torch.empty((t_len, mb, 4 * n), dtype=zx.dtype, device=dev)
    cs = torch.empty((t_len, mb, n), dtype=zx.dtype, device=dev)
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    arrived = torch.zeros(1, dtype=torch.int32, device=dev)
    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        rc = _fns()[0](*(t.data_ptr() for t in ts), None if m is None else m.data_ptr(),
                       *(t.data_ptr() for t in (hs, zs, cs, h_t, c_t, arrived)),
                       mb, t_len, n, int(bool(reverse)), _DTYPE_CODE[zx.dtype],
                       plan, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"LSTM sequence kernel launch failed (code {rc})")
    lstm_seq_fwd_cuda.launches += 1
    lstm_seq_fwd_cuda.plan = (plan[0], bool(plan[1]))
    return hs, zs, cs, h_t, c_t


lstm_seq_fwd_cuda.launches = 0
lstm_seq_fwd_cuda.plan = None


def lstm_cell_bwd_cuda(z: Tensor, c: Tensor, dh: Tensor, dcn: Tensor,
                       out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Launch K5b (``csrc/lstm_cell.cu``) → (dz, dc) in the input dtype;
    dz goes to ``out`` when given (contiguous, z's shape and dtype)."""
    _check(z, c, dh, dcn)
    if out is None:
        out = torch.empty_like(z)
    else:
        _check(out, c)
    dc = torch.empty_like(c)
    with torch.cuda.device(z.device):
        rc = _fns()[1](*(t.data_ptr() for t in (z, c, dh, dcn, out, dc)), c.shape[0],
                       c.shape[1], _DTYPE_CODE[z.dtype], _stream(z.device))
    if rc != 0:
        raise RuntimeError(f"LSTM cell kernel launch failed (code {rc})")
    lstm_cell_bwd_cuda.launches += 1
    return out, dc


lstm_cell_bwd_cuda.launches = 0


def lstm_seq_fwd(zx: Tensor, RW: Tensor, b: Tensor, h0: Tensor, c0: Tensor,
                 mask: Optional[Tensor] = None, reverse: bool = False):
    """K5a: CPU tensors run the plain loop; CUDA tensors run the kernel."""
    if zx.device.type == "cpu":
        return lstm_seq_fwd_plain(zx, RW, b, h0, c0, mask, reverse)
    return lstm_seq_fwd_cuda(zx, RW, b, h0, c0, mask, reverse)


def lstm_cell_bwd(z: Tensor, c: Tensor, dh: Tensor, dcn: Tensor,
                  out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K5b: CPU tensors run the plain version; CUDA tensors run the kernel."""
    if z.device.type == "cpu":
        dz, dc = lstm_cell_bwd_plain(z, c, dh, dcn)
        return (dz if out is None else out.copy_(dz)), dc
    return lstm_cell_bwd_cuda(z, c, dh, dcn, out)


class LSTMSequence(torch.autograd.Function):
    """The layer's forward over a sequence as one Function: forward K5a,
    backward one reverse loop over the steps, per step K5b from the saved
    (z_t, c_{t-1}) and dh_{t-1} = dz_t @ RWᵀ; then dRW as one product over
    all mb·T rows, db as one sum and dzx as one tensor.  Unused outputs'
    cotangents arrive as zeros (``materialize_grads``).  Inputs: zx
    [mb, T, 4n], RW [n, 4n], b [4n], h0, c0 [mb, n], mask [mb, T] or None,
    reverse → (hs [mb, T, n], h_T, c_T)."""

    @staticmethod
    def forward(ctx, zx, RW, b, h0, c0, mask, reverse):
        hs, zs, cs, h_t, c_t = lstm_seq_fwd(zx, RW, b, h0, c0, mask, reverse)
        ctx.set_materialize_grads(True)
        ctx.save_for_backward(RW, h0, c0, hs, zs, cs, mask)
        ctx.reverse = bool(reverse)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        RW, h0, c0, hs, zs, cs, mask = ctx.saved_tensors
        t_len, mb, n4 = zs.shape
        dt = zs.dtype
        rev = ctx.reverse
        dhs = dhs.to(dt)
        dz = torch.empty_like(zs)                      # [T, mb, 4n]
        RWt = RW.t()
        if mask is not None:
            m = mask.to(dt).t()[..., None]             # [T, mb, 1]
            om = 1 - m
        gh, gc = dh_t.to(dt), dc_t.to(dt).contiguous()
        for t in _steps(t_len, not rev):               # the forward's steps, last first
            first = t == (t_len - 1 if rev else 0)
            c_prev = c0 if first else cs[t + 1 if rev else t - 1]
            g = dhs[:, t] + gh
            if mask is None:
                _, gc = lstm_cell_bwd(zs[t], c_prev, g, gc, out=dz[t])
                gh = dz[t] @ RWt
            else:      # the hold: m to the cell, 1 - m straight to the carry
                _, dc = lstm_cell_bwd(zs[t], c_prev, m[t] * g, m[t] * gc, out=dz[t])
                gh = torch.addmm(om[t] * g, dz[t], RWt)
                gc = torch.addcmul(dc, om[t], gc)
        need = ctx.needs_input_grad
        dzx = dz.transpose(0, 1) if need[0] else None
        dRW = db = None
        if need[1]:
            hs_t = hs.transpose(0, 1)                  # h_{t-1} of every step, time-major
            h_prev = (torch.cat([hs_t[1:], h0[None]]) if rev
                      else torch.cat([h0[None], hs_t[:-1]]))
            dRW = h_prev.reshape(t_len * mb, -1).t() @ dz.reshape(t_len * mb, n4)
        if need[2]:
            db = dz.reshape(t_len * mb, n4).sum(0)
        return dzx, dRW, db, gh, gc, None, None


def lstm_sequence(zx: Tensor, RW: Tensor, b: Tensor, h0: Tensor, c0: Tensor,
                  mask: Optional[Tensor] = None,
                  reverse: bool = False) -> Tuple[Tensor, Carry]:
    """The standard cell over a sequence: zx [mb, T, 4n] (gates
    ``[i|f|o|g]``) → (hs [mb, T, n], (h_T, c_T)); the plain loop for CPU
    tensors and for float64 (the kernels have no float64 form, and the
    reference's ``_use_pallas`` sends float64 to its plain cell too), else
    K5a/K5b."""
    if zx.device.type == "cpu" or zx.dtype == torch.float64:
        return lstm_sequence_plain(zx, RW, b, h0, c0, mask, reverse)
    args = [t.contiguous() for t in (zx, RW, b, h0, c0)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        hs, h_t, c_t = LSTMSequence.apply(*args, mask, reverse)
    else:
        hs, _, _, h_t, c_t = lstm_seq_fwd_cuda(*args, mask, reverse)
    return hs, (h_t, c_t)
