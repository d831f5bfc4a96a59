"""Multi-head attention: the plain ``mha`` path and flash attention
forward and backward (mirrors ``deeplearning4j_tpu/ops/attention.py``).

``flash_forward`` is kernel K1 (``csrc/flash_fwd.cu``, replacing the TPU
kernel ``_flash_kernel``); ``flash_backward`` runs kernels K2 (dK, dV)
and K3 (dQ) (``csrc/flash_bwd.cu``, replacing ``_flash_bwd_dkdv_kernel``
and ``_flash_bwd_dq_kernel``).  For a CUDA tensor each launches its
kernel; for a CPU tensor, and only then, it runs its plain PyTorch
version (``flash_forward_plain``, ``flash_backward_plain``).  A CUDA call
that a kernel cannot take raises: no path falls back.  The forward
returns O and the per-row log-sum-exp (LSE, +1e30 for rows that never
saw a live key); the backward rebuilds p from that LSE, so such rows get
exactly zero gradients.  ``flash_mha`` ties them together with a
``torch.autograd.Function``, as the reference's ``_flash_mha_p`` custom
VJP does.

Routing kept from the reference (``_kernel_eligible``): float64 goes to
``mha``, and a layer mask goes to ``mha`` (``models/transformer.py``).
Unlike the TPU kernel, the CUDA kernel masks ragged edges itself, so
lengths that do not tile still run it.

Layout convention: [batch, heads, seq, head_dim] (BHTD).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30   # large-finite: keeps masked rows NaN-free
LSE_EMPTY = 1e30  # LSE of a row with no live key

Tensor = torch.Tensor


def causal_bias(tq: int, tk: int, q_off: int = 0, k_off: int = 0,
                device=None) -> Tensor:
    """Additive causal bias [tq, tk]: 0 where the global query index is
    >= the global key index, ``NEG_INF`` elsewhere."""
    qi = torch.arange(tq, device=device)[:, None] + q_off
    ki = torch.arange(tk, device=device)[None, :] + k_off
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(qi >= ki, zero, torch.full_like(zero, NEG_INF))


def _score_bias(T: int, S: int, kmask: Optional[Tensor], causal: bool,
                device) -> Optional[Tensor]:
    """The kernels' additive bias: causal part plus key-mask part, each
    ``NEG_INF`` where blocked (so a key blocked twice sits at 2·NEG_INF)."""
    bias = causal_bias(T, S, device=device) if causal else None
    if kmask is not None:
        kb = torch.where(kmask[:, None, None, :] != 0, 0.0, NEG_INF).float()
        bias = kb if bias is None else bias + kb
    return bias


def split_heads(x: Tensor, n_heads: int) -> Tensor:
    """[B, T, H*D] → [B, H, T, D]."""
    b, t, dm = x.shape
    return x.reshape(b, t, n_heads, dm // n_heads).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    """[B, H, T, D] → [B, T, H*D]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
        mask: Optional[Tensor] = None, scale: Optional[float] = None) -> Tensor:
    """Plain attention: softmax(q·kᵀ·scale (+mask)) · v.  ``mask``
    broadcastable to [B,H,T,S], 1 = attend; softmax in at least f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        scores = scores + causal_bias(scores.shape[-2], scores.shape[-1],
                                      device=q.device).to(scores.dtype)
    if mask is not None:
        scores = torch.where(mask.bool(), scores,
                             torch.full_like(scores, NEG_INF))
    acc = torch.promote_types(scores.dtype, torch.float32)
    p = torch.softmax(scores.to(acc), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def blockwise_update(acc: Tensor, m: Tensor, l: Tensor, q: Tensor, k: Tensor,
                     v: Tensor, scale: float, bias: Optional[Tensor] = None):
    """One online-softmax step (reference ``blockwise_update``): fold the
    (q, k-block) score tile into the f32 accumulators ``acc`` [..., T, D]
    (un-normalized output), ``m`` [..., T, 1] (running max) and ``l``
    [..., T, 1] (running denominator) → (acc, m, l).  Products take the
    input dtype and sum in f32; ``p`` takes v's dtype before the P·V
    product; float64 inputs run in f32.  Ring attention runs on it."""
    if q.dtype == torch.float64:
        q, k, v = q.float(), k.float(), v.float()
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1, keepdim=True)
    acc_new = acc * correction + torch.matmul(p.to(v.dtype), v).float()
    return acc_new, m_new, l_new


def _check(q: Tensor, k: Tensor, v: Tensor, kmask: Optional[Tensor]):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q [B,H,T,D], k/v [B,H,S,D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, heads or head_dim")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kmask is not None and tuple(kmask.shape) != (q.shape[0], k.shape[2]):
        raise ValueError(f"kmask must be [B, S] = {(q.shape[0], k.shape[2])}, "
                         f"got {tuple(kmask.shape)}")


def flash_forward_plain(q: Tensor, k: Tensor, v: Tensor,
                        kmask: Optional[Tensor], causal: bool,
                        scale: float) -> Tuple[Tensor, Tensor]:
    """K1's plain PyTorch version: the ``blockwise_update`` math over all
    keys at once.  Scores and statistics in f32; p takes v's dtype
    before the P·V product; the running max starts at ``NEG_INF``, so a
    row whose every key is masked averages v and gets LSE +1e30.
    → (o [B,H,T,D] in q's dtype, lse [B,H,T] f32)."""
    _check(q, k, v, kmask)
    T, S = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = _score_bias(T, S, kmask, causal, q.device)
    if bias is not None:
        s = s + bias
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    ls = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / ls
    lse = torch.where(m > NEG_INF / 2, m + torch.log(ls),
                      torch.full_like(m, LSE_EMPTY))
    return o.to(q.dtype), lse[..., 0]


@functools.lru_cache(maxsize=None)
def _flash_fn():
    """``dl4j_flash_fwd`` from the built library, its C signature set once."""
    from ..utils import cuda_build

    fn = cuda_build.load("flash_fwd").dl4j_flash_fwd
    fn.restype = ctypes.c_int        # pointers as c_void_p, or ctypes cuts them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def flash_forward_cuda(q: Tensor, k: Tensor, v: Tensor,
                       kmask: Optional[Tensor], causal: bool,
                       scale: float) -> Tuple[Tensor, Tensor]:
    """Launch K1 (``csrc/flash_fwd.cu``) on CUDA tensors.  Raises for
    anything the kernel does not take (D > 128, other dtypes, tensors on
    different devices)."""
    _check(q, k, v, kmask)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_forward_cuda needs q, k, v on one CUDA device")
    B, H, T, D = q.shape
    S = k.shape[2]
    if D > 128:
        raise ValueError(f"the flash kernel supports head_dim <= 128, got {D}")
    fn = _flash_fn()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    km = None
    if kmask is not None:
        km = kmask.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if km is None else km.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, H, T, S, D, float(scale), int(bool(causal)),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash forward kernel launch failed (code {rc})")
    # graftcheck: disable=GC103 (capture-time launch counter: a capturer reads what the capture added, takes it back and adds it at each replay)
    flash_forward_cuda.launches += 1
    return o, lse


flash_forward_cuda.launches = 0


def flash_forward(q: Tensor, k: Tensor, v: Tensor,
                  kmask: Optional[Tensor] = None, causal: bool = False,
                  scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """K1: → (o [B,H,T,D], lse [B,H,T] f32).  CPU tensors run the plain
    version; CUDA tensors run the kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, kmask, causal, scale)
    return flash_forward_cuda(q, k, v, kmask, causal, scale)


def flash_delta(o: Tensor, g: Tensor) -> Tensor:
    """delta = rowsum(g·o) [B,H,T] in f32, the softmax-Jacobian row term
    both backward kernels read; a plain op outside them, as in the
    reference."""
    return (g.float() * o.float()).sum(dim=-1)


def _bwd_p_ds(q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor,
              delta: Tensor, kmask: Optional[Tensor], causal: bool,
              scale: float) -> Tuple[Tensor, Tensor]:
    """The ``_bwd_tile`` math over all (query, key) pairs at once: p =
    exp(s + bias - lse) rebuilt from the forward's LSE, and ds =
    p·(g·vᵀ - delta)·scale, zeroed where the bias blocks.  Both come back
    rounded to the input dtype (as f32), as the products that read them
    take them."""
    _check(q, k, v, kmask)
    bias = _score_bias(q.shape[2], k.shape[2], kmask, causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    if bias is not None:
        ds = ds * (bias > NEG_INF / 2).float()
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dkdv_plain(q, k, v, g, lse, delta, kmask, causal: bool,
                         scale: float) -> Tuple[Tensor, Tensor]:
    """K2's plain PyTorch version: dk = dsᵀ·q, dv = pᵀ·g (f32 sums)."""
    p, ds = _bwd_p_ds(q, k, v, g, lse, delta, kmask, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, g, lse, delta, kmask, causal: bool,
                       scale: float) -> Tensor:
    """K3's plain PyTorch version: dq = ds·k (f32 sums)."""
    _, ds = _bwd_p_ds(q, k, v, g, lse, delta, kmask, causal, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_backward_plain(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                         lse: Tensor, delta: Tensor, kmask: Optional[Tensor],
                         causal: bool, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 and K3's plain versions together → (dq, dk, dv)."""
    dk, dv = flash_bwd_dkdv_plain(q, k, v, g, lse, delta, kmask, causal, scale)
    dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, kmask, causal, scale)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    """(``dl4j_flash_bwd_dkdv``, ``dl4j_flash_bwd_dq``) from the built
    library, their C signatures set once."""
    from ..utils import cuda_build

    lib = cuda_build.load("flash_bwd")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    dkdv, dq = lib.dl4j_flash_bwd_dkdv, lib.dl4j_flash_bwd_dq
    dkdv.restype = dq.restype = ctypes.c_int
    dkdv.argtypes = [ctypes.c_void_p] * 9 + tail
    dq.argtypes = [ctypes.c_void_p] * 8 + tail
    return dkdv, dq


def _bwd_args(q, k, v, g, lse, delta, kmask):
    """Checked, contiguous kernel operands on q's CUDA device."""
    _check(q, k, v, kmask)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, g, lse, delta)):
        raise ValueError("the flash backward kernels need every operand on one CUDA device")
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must match q {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    B, H, T, D = q.shape
    if D > 128:
        raise ValueError(f"the flash kernels support head_dim <= 128, got {D}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B,H,T] = {(B, H, T)}")
    km = None if kmask is None else kmask.to(device=q.device, dtype=torch.int32).contiguous()
    return [t.contiguous() for t in (q, k, v, g, lse, delta)] + [km]


def flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, kmask, causal: bool,
                        scale: float) -> Tuple[Tensor, Tensor]:
    """Launch K2 (``csrc/flash_bwd.cu``): → (dk, dv) [B,H,S,D]."""
    q, k, v, g, lse, delta, km = _bwd_args(q, k, v, g, lse, delta, kmask)
    B, H, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_fns()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if km is None else km.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, T, k.shape[2], D, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash backward dK/dV kernel launch failed (code {rc})")
    # graftcheck: disable=GC103 (capture-time launch counter: a capturer reads what the capture added, takes it back and adds it at each replay)
    flash_bwd_dkdv_cuda.launches += 1
    return dk, dv


flash_bwd_dkdv_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, kmask, causal: bool,
                      scale: float) -> Tensor:
    """Launch K3 (``csrc/flash_bwd.cu``): → dq [B,H,T,D]."""
    q, k, v, g, lse, delta, km = _bwd_args(q, k, v, g, lse, delta, kmask)
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_fns()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if km is None else km.data_ptr(), dq.data_ptr(),
            B, H, T, k.shape[2], D, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash backward dQ kernel launch failed (code {rc})")
    # graftcheck: disable=GC103 (capture-time launch counter: a capturer reads what the capture added, takes it back and adds it at each replay)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_backward(q: Tensor, k: Tensor, v: Tensor, kmask: Optional[Tensor],
                   o: Tensor, lse: Tensor, g: Tensor, causal: bool,
                   scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 + K3: (dq, dk, dv) of O = attention(q, k, v) for the cotangent
    ``g``, from the forward's O and LSE.  CPU tensors run the plain
    version; CUDA tensors run the kernels."""
    delta = flash_delta(o, g)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, g, lse, delta, kmask, causal, scale)
    dk, dv = flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, kmask, causal, scale)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, kmask, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """O = flash attention, its gradient from the flash backward (the
    reference's ``_flash_mha_p`` custom VJP).  The forward keeps
    (q, k, v, kmask, O, LSE); the key mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal: bool, scale: float):
        o, lse = flash_forward(q, k, v, kmask, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kmask, ctx.causal, ctx.scale = kmask, causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, ctx.kmask, o, lse, g.contiguous(),
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_mha(q: Tensor, k: Tensor, v: Tensor, causal: bool = False,
              scale: Optional[float] = None,
              kmask: Optional[Tensor] = None) -> Tensor:
    """Fused blockwise attention, forward (K1) and backward (K2, K3).
    ``kmask`` [B, S], 1 = attend.  float64 takes ``mha`` (autograd
    through plain PyTorch), as the reference's ``_kernel_eligible`` does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.float64:
        m = None if kmask is None else kmask[:, None, None, :]
        return mha(q, k, v, causal=causal, mask=m, scale=scale)
    return FlashAttention.apply(q, k, v, kmask, causal, scale)
