"""Paged KV-cache and deterministic attention for autoregressive decode
(mirrors ``deeplearning4j_tpu/ops/kv_cache.py``: the f32 pool, the
int8 ``QuantPages`` pool, and page transfer for disaggregated decode).

The pool is one buffer per K and V of shape [n_layers, n_pages,
page_size, n_heads, d_head]; a slot's cache is the pages its page-table
row names.  Page 0 is the scratch page: inactive slots' table rows are
all zero, so the fixed-shape decode step writes every slot and masked
slots' writes land in scratch, never read unmasked.  ``kv_dtype="int8"``
stores each row as int8 values with one f32 scale (amax/127), quantized
on write and dequantized in ``gather_layer``, so attention stays f32.

Unlike the reference, whose pools are immutable JAX values threaded
through each call, the port writes pages IN PLACE (no copy of a pool
that can hold hundreds of MB, and fixed addresses for a CUDA graph);
the write functions still return the pool so call sites read as in the
reference.  Out-of-range page-table reads clamp, as JAX's gathers do.

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

import collections
import ctypes
import functools
import json
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .attention import NEG_INF

Tensor = torch.Tensor

SCRATCH_PAGE = 0      # pool page 0: write target for masked-out slots
DET_CHUNK_BYTES = 256 << 20


class QuantPages(NamedTuple):
    """Int8 page pool (``kv_dtype="int8"``): ``q`` [n_layers, n_pages,
    page_size, n_heads, d_head] int8 and ``scale`` [n_layers, n_pages,
    page_size] f32, one symmetric scale per cached row (pages fill
    append-only, so a row's scale never changes once written)."""

    q: Tensor
    scale: Tensor


class ShardedPages(tuple):
    """A tensor-parallel program's page pool: one f32 pool a head shard,
    [n_layers, n_pages, page_size, n_heads / n, d_head] each, shard s on
    its own device.  The engine's page ids index every shard alike."""


KVPool = Union[Tensor, QuantPages, ShardedPages]


class KVCache(NamedTuple):
    """The page pools for K and V, [n_layers, n_pages, page_size,
    n_heads, d_head] each (or ``QuantPages``)."""

    k_pages: KVPool
    v_pages: KVPool


def _leaves(pages: KVPool):
    return tuple(pages) if isinstance(pages, (QuantPages, ShardedPages)) else (pages,)


def alloc_cache(n_layers: int, n_pages: int, page_size: int, n_heads: int,
                d_head: int, dtype=torch.float32, device=None,
                kv_dtype: Optional[str] = None,
                shard_devices: Optional[Sequence] = None) -> KVCache:
    """Zero-filled pool; ``n_pages`` includes the scratch page 0.
    ``kv_dtype`` None/"f32"/"float32" gives f32 pages, "int8"/"i8"
    ``QuantPages`` (zero scales dequantize untouched rows to the 0.0 an
    f32 pool starts with).  ``shard_devices`` gives ``ShardedPages``:
    the heads split evenly over those devices (f32 only)."""
    if kv_dtype not in (None, "f32", "float32", "int8", "i8"):
        raise ValueError(f"kv_dtype {kv_dtype!r} not supported (float32 or int8)")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"KV pages hold float32 values (or kv_dtype='int8'), got {dtype}")
    shape = (n_layers, n_pages, page_size, n_heads, d_head)
    if shard_devices:
        if kv_dtype in ("int8", "i8"):
            raise ValueError("int8 pages cannot be split into head shards")
        n = len(shard_devices)
        shard = shape[:3] + (n_heads // n, d_head)
        return KVCache(*(ShardedPages(torch.zeros(shard, dtype=dtype, device=d)
                                      for d in shard_devices) for _ in range(2)))
    if kv_dtype in ("int8", "i8"):
        pool = lambda: QuantPages(torch.zeros(shape, dtype=torch.int8, device=device),
                                  torch.zeros(shape[:3], dtype=torch.float32,
                                              device=device))
        return KVCache(pool(), pool())
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def pool_nbytes(pages) -> int:
    """Resident bytes of a pool, a ``KVCache`` or any nesting of them
    (values and any quantization scales)."""
    if isinstance(pages, Tensor):
        return pages.numel() * pages.element_size()
    return sum(pool_nbytes(p) for p in pages)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages a request of ``n_tokens`` total (prompt + generated) needs."""
    return max(1, math.ceil(n_tokens / page_size))


def _quantize_rows(kv: Tensor) -> tuple:
    """Per-row symmetric int8: ``kv`` [..., H, d] → (int8 values, f32
    scales [...]) with scale = amax/127, rounded half to even and
    clipped to ±127; a zero row gets scale 1.0 (dequantizes to exact
    zeros).  A row holding inf or NaN gets a non-finite scale, so its
    dequantized values are non-finite and the poison check still sees
    them.  (The reference's ``amax > 0`` test gives a NaN row scale 1.0
    and so drops the NaN; inf rows agree.)"""
    amax = kv.abs().amax(dim=(-2, -1))
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.nan_to_num(torch.round(kv / scale[..., None, None]), nan=0.0)
    return q.clamp(-127, 127).to(torch.int8), scale.float()


def _pool_set(pages: KVPool, layer: int, page_idx: Tensor, slot_idx: Tensor,
              kv: Tensor) -> KVPool:
    """Write f32 rows into an f32 or int8 pool (quantizing on write)."""
    if isinstance(pages, QuantPages):
        q, sc = _quantize_rows(kv)
        pages.q[layer, page_idx, slot_idx] = q
        pages.scale[layer, page_idx, slot_idx] = sc
    else:
        pages[layer, page_idx, slot_idx] = kv
    return pages


def _page_size(pages: KVPool) -> int:
    return _leaves(pages)[0].shape[2]


def _table_pages(table: Tensor, s_idx, idx: Tensor) -> Tensor:
    """``table[s_idx, idx]`` with an index past the table routed to the
    scratch page (rows beyond a slot's capacity)."""
    pps = table.shape[-1]
    inside = table[s_idx, idx.clamp(0, pps - 1)]
    return torch.where(idx < pps, inside, torch.full_like(inside, SCRATCH_PAGE))


def write_prefill(pages: KVPool, layer: int, page_table_row: Tensor,
                  kv: Tensor, offset=0) -> KVPool:
    """Write a prompt's rows ``kv`` [T, H, d] into one slot's pages at
    positions ``offset``..``offset+T-1``; rows past the slot's capacity
    go to the scratch page.  In place; returns ``pages``."""
    page_size = _page_size(pages)
    pos = offset + torch.arange(kv.shape[0], device=kv.device)
    page_idx = _table_pages(page_table_row[None], 0, pos // page_size)
    return _pool_set(pages, layer, page_idx, pos % page_size, kv)


def write_step(pages: KVPool, layer: int, page_table: Tensor,
               positions: Tensor, kv: Tensor) -> KVPool:
    """Write one token per slot: ``page_table`` [S, pps], ``positions``
    [S], ``kv`` [S, H, d].  Masked slots arrive with zeroed table rows
    and so write the scratch page; a position past the table reads its
    last entry, as the reference's clamped gather does.  In place;
    returns ``pages``."""
    page_size = _page_size(pages)
    s = torch.arange(page_table.shape[0], device=kv.device)
    idx = (positions // page_size).clamp(0, page_table.shape[1] - 1)
    return _pool_set(pages, layer, page_table[s, idx], positions % page_size, kv)


def write_tokens(pages: KVPool, layer: int, page_table: Tensor,
                 positions: Tensor, kv: Tensor) -> KVPool:
    """Write a range of tokens per slot (speculative verify):
    ``page_table`` [S, pps], ``positions`` [S] (each slot's first row),
    ``kv`` [S, T, H, d] at positions ``positions[s]``..``+T-1``; rows
    past the slot's capacity go to the scratch page.  In place; returns
    ``pages``."""
    page_size = _page_size(pages)
    s_n, t_n = kv.shape[:2]
    pos = positions[:, None] + torch.arange(t_n, device=kv.device)[None, :]
    s_idx = torch.arange(s_n, device=kv.device)[:, None]
    page_idx = _table_pages(page_table, s_idx, pos // page_size)
    return _pool_set(pages, layer, page_idx, pos % page_size, kv)


def gather_layer(pages: KVPool, layer: int, page_table: Tensor) -> Tensor:
    """[S, pps] table → [S, L, H, d] view of one layer's rows (L = pps *
    page_size), as f32: int8 pools dequantize here, so D1 sees f32."""
    if isinstance(pages, QuantPages):
        g = (pages.q[layer][page_table].float()
             * pages.scale[layer][page_table][..., None, None])
    else:
        g = pages[layer][page_table]            # [S, pps, page, H, d]
    s, pps, page, h, d = g.shape
    return g.reshape(s, pps * page, h, d)


def scrub_pool(pages: KVPool, ids: Tensor) -> KVPool:
    """Zero the given page ids in every layer — values and, for int8
    pools, scales (a stale scale would rescale the next tenant's rows).
    In place; returns ``pages``."""
    for leaf in _leaves(pages):
        leaf[:, ids] = 0
    return pages


def reset_pool(pages: KVPool) -> KVPool:
    """Zero a whole pool in place (after a crash)."""
    for leaf in _leaves(pages):
        leaf.zero_()
    return pages


# -- page transfer (disaggregated prefill/decode) ------------------------------------


def gather_pages(pages: KVPool, ids: Tensor) -> KVPool:
    """Pages ``ids`` of every layer as a dense payload [n_layers,
    len(ids), page_size, n_heads, d_head]: the export half of a
    prefill→decode transfer.  Bits are copied as stored: f32 rows
    verbatim, an int8 pool's ``q`` and ``scale`` verbatim (a
    ``QuantPages`` payload).  A ``ShardedPages`` pool's shards are
    concatenated along the head axis, so the payload always holds all
    heads, on the first shard's device."""
    if isinstance(pages, QuantPages):
        return QuantPages(pages.q[:, ids.to(pages.q.device)],
                          pages.scale[:, ids.to(pages.scale.device)])
    if isinstance(pages, ShardedPages):
        dev = pages[0].device
        return torch.cat([p[:, ids.to(p.device)].to(dev) for p in pages], dim=3)
    return pages[:, ids.to(pages.device)]


def set_pages(pages: KVPool, ids: Tensor, payload: KVPool) -> KVPool:
    """Write a gathered ``payload`` at page ids ``ids`` (generally not
    the ids it was gathered from): the attach half of a transfer, in
    place (``index_copy_`` into the pool's own storage, which a captured
    graph keeps reading).  A ``ShardedPages`` pool takes an all-heads
    payload and splits it along the head axis over its shards.  Returns
    ``pages``."""
    if isinstance(pages, QuantPages):
        for leaf, part in zip(pages, payload):
            leaf.index_copy_(1, ids.to(leaf.device), part.to(leaf.device, leaf.dtype))
        return pages
    if isinstance(pages, ShardedPages):
        per = pages[0].shape[3]
        for s, leaf in enumerate(pages):
            part = payload[:, :, :, s * per:(s + 1) * per]
            leaf.index_copy_(1, ids.to(leaf.device), part.to(leaf.device, leaf.dtype))
        return pages
    pages.index_copy_(1, ids.to(pages.device), payload.to(pages.device, pages.dtype))
    return pages


def pool_layout(pages: KVPool) -> tuple:
    """(n_layers, page_size, all heads, d_head, kv dtype name) of a
    pool: what a transfer's payload must match to attach."""
    lead = _leaves(pages)[0]
    heads = sum(p.shape[3] for p in pages) if isinstance(pages, ShardedPages) \
        else lead.shape[3]
    kind = "int8" if isinstance(pages, QuantPages) else "float32"
    return (lead.shape[0], lead.shape[2], heads, lead.shape[4], kind)


class PageTransfer(NamedTuple):
    """One request's exported KV pages on the host.

    ``n_pages`` real pages; ``k`` / ``v`` are numpy payloads [n_layers,
    n_pages, page_size, n_heads, d_head]: float32 arrays, or
    ``QuantPages`` of numpy arrays (int8 ``q`` and float32 row ``scale``)
    for an int8 pool.  ``pack_transfer`` / ``unpack_transfer`` are the
    wire form, the reference's byte for byte; the round trip is bitwise."""

    n_pages: int
    k: Any
    v: Any


_TRANSFER_MAGIC = b"KVPX1\n"


def _transfer_arrays(t: PageTransfer):
    out = []
    for name, side in (("k", t.k), ("v", t.v)):
        if isinstance(side, QuantPages):
            out.append((name + ".q", side.q))
            out.append((name + ".scale", side.scale))
        else:
            out.append((name, side))
    return out


def transfer_nbytes(t: PageTransfer) -> int:
    """Payload bytes a transfer puts on the wire (header excluded)."""
    return int(sum(np.asarray(a).nbytes for _, a in _transfer_arrays(t)))


def pack_transfer(t: PageTransfer) -> bytes:
    """The wire form of a ``PageTransfer``: the magic ``b"KVPX1\\n"``, an
    8-byte big-endian header length, a JSON header (page count and each
    array's name, dtype and shape), then the raw arrays in header order.
    No pickling: ``unpack_transfer`` validates untrusted bytes."""
    arrs = [(n, np.ascontiguousarray(np.asarray(a))) for n, a in _transfer_arrays(t)]
    header = json.dumps({
        "n_pages": int(t.n_pages),
        "arrays": [{"name": n, "dtype": a.dtype.name, "shape": a.shape}
                   for n, a in arrs],
    }).encode()
    body = b"".join(a.tobytes() for _, a in arrs)
    return _TRANSFER_MAGIC + len(header).to_bytes(8, "big") + header + body


def unpack_transfer(data: bytes) -> PageTransfer:
    """Inverse of ``pack_transfer``.  Raises ``ValueError`` on a bad
    magic, a truncated header or body, or a corrupt header, so a decode
    host fails the one request the bytes belong to before it allocates a
    page."""
    m = len(_TRANSFER_MAGIC)
    if len(data) < m + 8 or data[:m] != _TRANSFER_MAGIC:
        raise ValueError("not a KV page transfer (bad magic)")
    hlen = int.from_bytes(data[m:m + 8], "big")
    if len(data) < m + 8 + hlen:
        raise ValueError("truncated page transfer (header)")
    try:
        header = json.loads(data[m + 8:m + 8 + hlen])
        descs = header["arrays"]
        n_pages = int(header["n_pages"])
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"corrupt page transfer header: {e}") from e
    off = m + 8 + hlen
    parts: dict = {}
    try:
        for d in descs:
            dt = np.dtype(d["dtype"])
            shape = tuple(int(x) for x in d["shape"])
            nbytes = int(dt.itemsize * math.prod(shape)) if shape else dt.itemsize
            if len(data) < off + nbytes:
                raise ValueError(f"truncated page transfer (array {d['name']})")
            parts[d["name"]] = np.frombuffer(data[off:off + nbytes], dtype=dt).reshape(shape)
            off += nbytes
    except (KeyError, TypeError) as e:
        raise ValueError(f"corrupt page transfer header: {e}") from e

    def side(name):
        if name in parts:
            return parts[name]
        if name + ".q" in parts and name + ".scale" in parts:
            return QuantPages(parts[name + ".q"], parts[name + ".scale"])
        raise ValueError(f"page transfer missing {name!r} payload")

    return PageTransfer(n_pages=n_pages, k=side("k"), v=side("v"))


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
    zero-padded (exact: the padding adds 0·0 to each score).  Head widths
    up to 256 (instances at 64, 128 and 256: ``instances`` counts launches
    by ``"d<bucket>"``).  Raises for anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"det_attention wants q [B,H,Tq,d], k/v [B,H,L,d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not all(t.dtype == torch.float32 for t in (q, k, v, bias)):
        raise TypeError("the det_attention kernel takes float32 q, k, v and bias")
    B, H, Tq, d = q.shape
    L = k.shape[2]
    if d > 256:
        raise ValueError(f"the det_attention kernel supports head_dim <= 256, got {d}")
    if not all(t.is_cuda and t.device == q.device for t in (k, v, bias)) or not q.is_cuda:
        raise ValueError("det_attention_cuda needs q, k, v, bias on one CUDA device")
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
    det_attention_cuda.instances[f"d{64 if d <= 64 else 128 if d <= 128 else 256}"] += 1
    return out if dk == d else out[..., :d]


det_attention_cuda.launches = 0
det_attention_cuda.instances = collections.Counter()


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

    Optional entry points (None when the model does not provide them):

      prefill_at(params, k_pages, v_pages, page_table_row, tokens,
                 n_real, offset) -> (k_pages, v_pages, logits [V])
          the prefill with rows at positions offset..offset+Tb-1,
          attending over the rows already in the slot's pages (a
          prefix-cache suffix, or one chunk of a chunked prefill)
      spec_step(params, k_pages, v_pages, page_table, tokens [S, T],
                positions [S], active [S])
          -> (k_pages, v_pages, logits [S, T, V])
          speculative verify: T tokens per slot in one call
      step_multi(params, k_pages, v_pages, page_table, tokens,
                 positions, active, temps, top_ks, top_ps, seeds, steps,
                 budgets, eos_id, horizon)
          -> (k_pages, v_pages, tokens [H, S], finite [H, S],
              logits [H, S, V])
          ``horizon`` (an int H) decode steps with on-device sampling
          (``ops.sampling.sample_tokens_device`` at ``steps + j``); a
          slot that samples ``eos_id`` (-1: none), runs out of its
          budget or gives non-finite logits leaves the live set and its
          later writes go to the scratch page, so live slots' bits are
          those of H plain steps.  It reads nothing back to the host, so
          a CUDA graph can hold it.
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
    prefill_at: Any = None
    spec_step: Any = None
    step_multi: Any = None
    tp: int = 1                  # head shards of a tensor-parallel program
    shard_devices: Any = None    # their devices (``ShardedPages``)
