"""Paged KV-cache and deterministic attention for autoregressive decode
(mirrors ``deeplearning4j_tpu/ops/kv_cache.py``; the f32 pool only).

The pool is one buffer per K and V of shape [n_layers, n_pages,
page_size, n_heads, d_head]; a slot's cache is the pages its page-table
row names.  Page 0 is the scratch page: inactive slots' table rows are
all zero, so the fixed-shape decode step writes every slot and masked
slots' writes land in scratch, never read unmasked.

Unlike the reference, whose pools are immutable JAX values threaded
through each call, the port writes pages IN PLACE (no copy of a pool
that can hold hundreds of MB); the write functions still return the
pool so call sites read as in the reference.

``det_attention`` is kernel D1 (``csrc/det_attention.cu``) on a CUDA
tensor and ``det_attention_plain`` on a CPU tensor.  The reference's
bitwise decode-vs-re-encode contract needs each query row's reduction
order to depend on nothing but that row; D1 fixes that order (keys in
fixed 64-key chunks from key 0, one partial per (row, chunk) computed
the same way in its split-key and tiled launches, partials combined in
ascending chunk order), and masked keys add exact zeros, so prefill (L
keys), step (L keys) and re-encode (t keys) give the same bits.  ``det_attention_plain`` keeps
the reference's formulation, broadcast-multiply plus trailing-axis sums
with ``NEG_INF`` masking, and takes every sum in ascending order (a
cumulative sum's last entry), so on the CPU too masked keys add exact
zeros and the decode program holds the bitwise contract.  Eager PyTorch
materializes the [B,H,Tq,L,d] product that XLA fuses away, so it walks
the query rows in chunks that keep each transient under
``DET_CHUNK_BYTES``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Callable, NamedTuple

import torch

from .attention import NEG_INF

Tensor = torch.Tensor

SCRATCH_PAGE = 0      # pool page 0: write target for masked-out slots
DET_CHUNK_BYTES = 256 << 20


class KVCache(NamedTuple):
    """The page pools for K and V, [n_layers, n_pages, page_size,
    n_heads, d_head] each."""

    k_pages: Tensor
    v_pages: Tensor


def alloc_cache(n_layers: int, n_pages: int, page_size: int, n_heads: int,
                d_head: int, dtype=torch.float32, device=None) -> KVCache:
    """Zero-filled f32 pool; ``n_pages`` includes the scratch page 0."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"only float32 KV pages are ported (int8 pages wait), got {dtype}")
    shape = (n_layers, n_pages, page_size, n_heads, d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages a request of ``n_tokens`` total (prompt + generated) needs."""
    return max(1, math.ceil(n_tokens / page_size))


def write_prefill(pages: Tensor, layer: int, page_table_row: Tensor,
                  kv: Tensor, offset: int = 0) -> Tensor:
    """Write a prompt's rows ``kv`` [T, H, d] into one slot's pages at
    positions ``offset``..``offset+T-1``; rows past the slot's capacity
    go to the scratch page.  In place; returns ``pages``."""
    t = kv.shape[0]
    page_size = pages.shape[2]
    pps = page_table_row.shape[0]
    pos = offset + torch.arange(t, device=pages.device)
    idx = pos // page_size
    page_idx = torch.where(idx < pps, page_table_row[idx.clamp(max=pps - 1)],
                           torch.full_like(idx, SCRATCH_PAGE))
    pages[layer, page_idx, pos % page_size] = kv
    return pages


def write_step(pages: Tensor, layer: int, page_table: Tensor,
               positions: Tensor, kv: Tensor) -> Tensor:
    """Write one token per slot: ``page_table`` [S, pps], ``positions``
    [S], ``kv`` [S, H, d].  Masked slots arrive with zeroed table rows
    and so write the scratch page.  In place; returns ``pages``."""
    page_size = pages.shape[2]
    s = torch.arange(page_table.shape[0], device=pages.device)
    page_idx = page_table[s, positions // page_size]
    pages[layer, page_idx, positions % page_size] = kv
    return pages


def gather_layer(pages: Tensor, layer: int, page_table: Tensor) -> Tensor:
    """[S, pps] table → [S, L, H, d] contiguous view of one layer's rows
    (L = pps * page_size)."""
    g = pages[layer][page_table]            # [S, pps, page, H, d]
    s, pps, page, h, d = g.shape
    return g.reshape(s, pps * page, h, d)


def _seq_sum(x: Tensor, dim: int) -> Tensor:
    """Sum over ``dim`` taken in ascending order (the last entry of a
    cumulative sum), so entries past a row's last nonzero one leave it
    unchanged: a sum over L keys equals the sum over the first t when
    the rest are exact zeros."""
    return x.cumsum(dim=dim).select(dim, -1)


def det_scores(q: Tensor, k: Tensor) -> Tensor:
    """[B,H,Tq,d] x [B,H,L,d] → [B,H,Tq,L] by broadcast-multiply and an
    ordered trailing-axis sum."""
    return _seq_sum(q[:, :, :, None, :] * k[:, :, None, :, :], -1)


def det_weighted_sum(p: Tensor, v: Tensor) -> Tensor:
    """[B,H,Tq,L] x [B,H,L,d] → [B,H,Tq,d]; exact-zero weights
    contribute exact zeros."""
    return _seq_sum(p[:, :, :, :, None] * v[:, :, None, :, :], -2)


def det_attention_plain(q: Tensor, k: Tensor, v: Tensor, bias: Tensor) -> Tensor:
    """D1's plain PyTorch version: row-deterministic attention over a key
    length L.

    ``q`` [B,H,Tq,d]; ``k``/``v`` [B,H,L,d]; ``bias`` broadcastable to
    [B,H,Tq,L], 0 on visible keys and ``NEG_INF`` elsewhere.  Query rows
    run in chunks so no [B,H,rows,L,d] transient passes
    ``DET_CHUNK_BYTES``; each row's arithmetic is the same either way."""
    B, H, Tq, d = q.shape
    L = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    row_bytes = B * H * L * d * q.element_size()
    rows = max(1, DET_CHUNK_BYTES // max(row_bytes, 1))
    outs = []
    for a in range(0, Tq, rows):
        b = min(Tq, a + rows)
        bias_c = bias[..., a:b, :] if bias.shape[-2] == Tq else bias
        s = det_scores(q[:, :, a:b], k) * scale + bias_c
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / _seq_sum(e, -1)[..., None]
        outs.append(det_weighted_sum(p, v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


#: D1 takes its split-key launch for calls of at most this many query rows
#: (one row tile): the decode step, and short prefills
SPLIT_ROWS = 32
DET_CHUNK = 64       # D1's fixed key chunk


@functools.lru_cache(maxsize=None)
def _det_fn():
    """``dl4j_det_attention`` from the built library, its C signature set once."""
    from ..utils import cuda_build

    fn = cuda_build.load("det_attention").dl4j_det_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p])
    return fn


def _aligned(t: Tensor) -> bool:
    """Rows of ``t`` [B,H,L,d] start on 16 bytes: what D1's 16-byte copies read."""
    return t.stride(3) == 1 and all(s % 4 == 0 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def det_attention_cuda(q: Tensor, k: Tensor, v: Tensor, bias: Tensor) -> Tensor:
    """Launch D1 (``csrc/det_attention.cu``) on CUDA tensors: its
    split-key launch for at most ``SPLIT_ROWS`` query rows, else its
    tiled launch; both give a row the same bits.  ``q``, ``k`` and ``v``
    may be strided views (the gathered pages, the projections split into
    heads) with a unit last stride; ``bias`` is read through its
    broadcast strides.  A head width that is not a multiple of 4 is
    zero-padded (exact: the padding adds 0·0 to each score).  Raises for
    anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"det_attention wants q [B,H,Tq,d], k/v [B,H,L,d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not all(t.dtype == torch.float32 for t in (q, k, v, bias)):
        raise TypeError("the det_attention kernel takes float32 q, k, v and bias")
    if not all(t.is_cuda and t.device == q.device for t in (k, v, bias)) or not q.is_cuda:
        raise ValueError("det_attention_cuda needs q, k, v, bias on one CUDA device")
    B, H, Tq, d = q.shape
    L = k.shape[2]
    if d > 128:
        raise ValueError(f"the det_attention kernel supports head_dim <= 128, got {d}")
    scale = 1.0 / math.sqrt(d)
    bias = bias.expand(B, H, Tq, L)
    if d % 4:
        pad = lambda t: torch.nn.functional.pad(t, (0, 4 - d % 4))
        q, k, v = pad(q), pad(k), pad(v)
    if q.stride(3) != 1:
        q = q.contiguous()
    if not (_aligned(k) and k.stride() == v.stride() and _aligned(v)):
        k, v = k.contiguous(), v.contiguous()
    dk = k.shape[3]
    split = Tq <= SPLIT_ROWS
    part = None
    if split:
        n_chunks = -(-L // DET_CHUNK)
        part = torch.empty(B * H * Tq * n_chunks * (dk + 2), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, H, Tq, dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _det_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), None if part is None else part.data_ptr(),
                       B, H, Tq, L, dk, *q.stride()[:3], *k.stride()[:3],
                       *bias.stride(), scale, int(split), stream)
    if rc != 0:
        raise RuntimeError(f"det_attention kernel launch failed (code {rc})")
    det_attention_cuda.launches += 1
    return out if dk == d else out[..., :d]


det_attention_cuda.launches = 0


def det_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor) -> Tensor:
    """Row-deterministic attention over a key length L (D1 on the card,
    the plain version on the CPU)."""
    if q.device.type == "cpu":
        return det_attention_plain(q, k, v, bias)
    return det_attention_cuda(q, k, v, bias)


class DecodeProgram(NamedTuple):
    """The functions and static config a model hands the decode engine.

      prefill(params, k_pages, v_pages, page_table_row, tokens, n_real)
          -> (k_pages, v_pages, logits [V])   one slot, bucketed length
      step(params, k_pages, v_pages, page_table, tokens, positions,
           active) -> (k_pages, v_pages, logits [S, V])   all slots
      reencode(params, tokens [B, T]) -> logits [B, T, V]
          the full-forward reference decode is checked against
    """

    prefill: Callable[..., Any]
    step: Callable[..., Any]
    reencode: Callable[..., Any]
    n_layers: int
    n_heads: int
    d_head: int
    vocab_size: int
    max_len: int            # L: fixed key length = pages_per_slot * page_size
    page_size: int
    pages_per_slot: int
