"""Gradient compression — the wire format of the cross-slice (``dcn``)
exchange tier (mirrors ``deeplearning4j_tpu/ops/compression.py``).

The reference's ``EncodingHandler`` behind ``SharedTrainingMaster`` picks
between ``thresholdEncode`` (one signed int32 index per transmitted
element: the int's sign is the update's, its magnitude the element's
index + 1) and ``bitmapEncode`` (2 bits per element), and keeps what it
did not transmit in a residual that is added back next step (error
feedback).  ``ShardedTrainer(grad_compression=...)`` runs this tier over
``torch.distributed``: each slice encodes its bucket, the ENCODED
buffers are all-gathered over the dcn group, and every rank decodes and
sums them.

Two encodings, as in the reference:

  threshold  — at most ``k = n/16`` elements per message.  Fixed
               ``threshold=t`` sends sign·t for the elements with
               |g| >= t (largest first when more than k clear t); the
               adaptive default (``threshold=None``) sends the k largest
               |g| at scale = mean |selected|.
  bitmap     — 2-bit codes packed 16 to a uint32 ({0, +scale, -scale});
               adaptive scale = mean |g|.

A fixed threshold always takes the one-pass encode, which skips the
top-k sort: an element's slot is the count of selected elements before
it, so the message lists the selection in index order.  When at most k
elements clear t it is the same set as the top-k pack's, so decode gives
the same bits.  On CUDA tensors the one-pass pack is kernel K6
(``csrc/threshold_encode.cu``, which replaces the TPU kernel
``deeplearning4j_tpu/ops/compression.py::_encode_kernel``): one launch
encodes every bucket of a step (``threshold_encode_buckets_cuda``), and
``threshold_encode_cuda`` is its one-bucket case; on CPU tensors, and
only there, it is ``threshold_encode_buckets_plain``, the reference's
plain twin ``_streaming_pack`` on each bucket.  The reference's switches
``DL4J_TPU_FUSED_ENCODE`` and ``DL4J_TPU_FUSED_ENCODE_PALLAS`` are not
read: on the card they could only keep K6 off the main path.

The reference decides "count <= k" inside ``lax.cond``.  Eager PyTorch
needs the count on the host, so a step's fixed-threshold encode
(``encode_wire``) runs the one-pass pack once over every bucket, writing
each message straight into the wire buffer and each bucket's selection
count beside it, reads the counts in one copy, and encodes again with the
top-k pack, over its slice of the wire, only a bucket whose count exceeds
k.  Top-k (the adaptive mode and the overflow) is a stable descending
sort, so ties go to the lower index as ``lax.top_k`` breaks them.

Decode sums the P gathered messages participant by participant, in rank
order, each over every bucket at once (bucket index ranges are
disjoint): a message's indices are distinct, so every add is a gather,
an add and a scatter with no atomics, and every rank computes the same
bits from the same messages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

METHODS = ("threshold", "bitmap")
#: the reference EncodingHandler's default threshold (fixed-threshold mode)
DEFAULT_THRESHOLD = 1e-3
#: capacity of the threshold encoding: at most n/16 elements per message
#: (the reference switches to bitmapEncode above this density)
THRESHOLD_DENSITY_CAP = 1.0 / 16.0
#: 2-bit codes, 16 to a uint32 word
BITMAP_LANES = 16
#: bucket granularity of the exchange (see GradBucketer)
DEFAULT_BUCKET_BYTES = 4 << 20


def default_k_max(n: int) -> int:
    """Threshold-encoding message capacity for an n-element bucket."""
    return 0 if n == 0 else max(1, int(n * THRESHOLD_DENSITY_CAP))


def _f32(t: float) -> float:
    """``t`` rounded to float32, the value the comparisons use."""
    return float(torch.tensor(t, dtype=torch.float32))


def _sign_index(g: Tensor, idx: Tensor) -> Tensor:
    """sign(g[idx])·(idx + 1) as int32 (a zero gradient counts as +)."""
    sign = torch.where(g[idx] >= 0, 1, -1).to(torch.int32)
    return sign * (idx.to(torch.int32) + 1)


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, indices) of the k largest, ties to the lower index
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


# ---------------------------------------------------------------------------
# fixed-threshold packs
# ---------------------------------------------------------------------------

def _topk_pack(g: Tensor, mag: Tensor, k: int, threshold: float) -> Tensor:
    """The reference-exact fixed-mode pack: top-k over the masked
    magnitudes (largest first when more than k clear t)."""
    vals, idx = _top_k(torch.where(mag >= threshold, mag, 0.0), k)
    return torch.where(vals > 0.0, _sign_index(g, idx), 0).to(torch.int32)


def _streaming_pack(g: Tensor, mag: Tensor, k: int, threshold: float, n: int) -> Tensor:
    """K6's plain version (the reference's ``_streaming_pack``): slot =
    exclusive running count of the selections; selections past k are
    dropped.  Precondition (the caller's): at most k elements clear t."""
    sel = mag >= threshold
    pos = torch.cumsum(sel.to(torch.int32), 0) - 1
    payload = (torch.where(g >= 0, 1, -1).to(torch.int32)
               * (torch.arange(n, dtype=torch.int32, device=g.device) + 1))
    slot = torch.where(sel & (pos < k), pos, k).to(torch.int64)
    out = torch.zeros(k + 1, dtype=torch.int32, device=g.device)
    out.index_put_((slot,), payload)      # slot k is the drop slot
    return out[:k]


def threshold_encode_buckets_plain(g: Tensor, sizes: Sequence[int], ks: Sequence[int],
                                   threshold: float,
                                   out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K6's plain version: ``_streaming_pack`` of each bucket.  Buckets of
    ``sizes`` elements lie end to end in the flat ``g``, their messages of
    ``ks`` slots end to end in ``out`` (int32, allocated when None) →
    ``(out, counts int32[len(sizes)])``, counts being each bucket's number
    of selections (which may exceed its k)."""
    if out is None:
        out = torch.empty(sum(ks), dtype=torch.int32, device=g.device)
    counts = []
    for s, m, n, k in zip(_prefix(sizes), _prefix(ks), sizes, ks):
        gb = g[s:s + n]
        mag = gb.abs()
        out[m:m + k] = _streaming_pack(gb, mag, k, threshold, n)
        counts.append((mag >= threshold).sum())
    return out, torch.stack(counts).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _encode_fn():
    """``dl4j_threshold_encode`` from the built library, signature set once."""
    from ..utils import cuda_build

    fn = cuda_build.load("threshold_encode").dl4j_threshold_encode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    return fn


#: elements per tile of K6 (256 threads x 4 float4), as csrc/threshold_encode.cu
ENC_TILE = 4096
#: the most tiles one block of K6 streams (a segment), as csrc/threshold_encode.cu
ENC_SEG_TILES = 16


def _seg_tiles(tiles: int, sms: int) -> int:
    """Tiles a segment for a launch of ``tiles`` tiles on ``sms`` SMs: up to
    ENC_SEG_TILES, while the launch keeps about 8 segments an SM (a small
    launch gets a block for each tile).  A step of the TransformerLM's 156
    buckets gets ENC_SEG_TILES; the smaller counts serve small launches,
    mainly the one-bucket ``threshold_encode_cuda`` (ROADMAP queue 2 item 7)."""
    return max(1, min(ENC_SEG_TILES, tiles // (8 * sms)))


@functools.lru_cache(maxsize=64)
def _encode_table(sizes: Tuple[int, ...], ks: Tuple[int, ...], seg_tiles: int,
                  device: torch.device):
    """K6's tables on ``device`` for buckets of ``sizes`` elements end to
    end, messages of ``ks`` slots end to end, segments of ``seg_tiles``
    tiles → ``(buckets, segments, n_segments)``: one row per bucket as
    csrc's ``Bucket`` (int64 g_off, msg_off, then int32 n, k, first_seg,
    segs) and one per segment as its ``Segment`` (int64 first element,
    then int32 bucket, valid elements); a bucket has
    max(1, ceil(n / (seg_tiles * ENC_TILE))) segments.  Built once per
    layout, so a step uploads nothing."""
    span = seg_tiles * ENC_TILE
    segs = [max(1, -(-n // span)) for n in sizes]
    rows = [[g, m, n | (k << 32), f | (c << 32)] for g, m, n, k, f, c in
            zip(_prefix(sizes), _prefix(ks), sizes, ks, _prefix(segs), segs)]
    as_t = functools.partial(torch.tensor, dtype=torch.int64)
    b = torch.repeat_interleave(torch.arange(len(sizes)), as_t(segs))
    j = torch.arange(b.numel()) - as_t(_prefix(segs))[b]          # segment within its bucket
    valid = (as_t(sizes)[b] - j * span).clamp(max=span)
    seg_rows = torch.stack([as_t(_prefix(sizes))[b] + j * span, b | (valid << 32)], 1)
    return as_t(rows).to(device), seg_rows.to(device), b.numel()


def _launch_encode(g: Tensor, sizes: Sequence[int], ks: Sequence[int], threshold: float,
                   out: Tensor) -> Tensor:
    """One K6 launch over the buckets → counts int32[len(sizes)] on the
    card.  Raises for anything the kernel does not take."""
    if not (g.is_cuda and out.is_cuda and g.device == out.device):
        raise ValueError("the threshold encode kernel needs g and out on one CUDA device")
    if g.dtype != torch.float32 or out.dtype != torch.int32:
        raise TypeError("the threshold encode kernel takes float32 g and int32 out, "
                        f"got {g.dtype} and {out.dtype}")
    if g.ndim != 1 or out.ndim != 1 or not (g.is_contiguous() and out.is_contiguous()):
        raise ValueError("the threshold encode kernel takes flat contiguous buffers, "
                         f"got {tuple(g.shape)} and {tuple(out.shape)}")
    if not sizes or len(sizes) != len(ks) \
            or not all(0 <= n < 2 ** 31 - 1 and 0 <= k < 2 ** 31 for n, k in zip(sizes, ks)) \
            or sum(sizes) > g.numel() or sum(ks) > out.numel():
        raise ValueError("the threshold encode kernel takes buckets of 0 <= n < 2^31 - 1 "
                         "elements and 0 <= k < 2^31 slots inside g and out, got "
                         f"{len(sizes)} sizes summing to {sum(sizes)} for {g.numel()} "
                         f"elements, {len(ks)} capacities summing to {sum(ks)} for "
                         f"{out.numel()} slots")
    if not threshold > 0:
        raise ValueError(f"the threshold must be > 0, got {threshold}")
    tiles = sum(max(1, -(-n // ENC_TILE)) for n in sizes)
    seg_tiles = _seg_tiles(tiles, torch.cuda.get_device_properties(g.device).multi_processor_count)
    table, seg_table, segs = _encode_table(tuple(sizes), tuple(ks), seg_tiles, g.device)
    if segs >= 2 ** 31:
        raise ValueError(f"the threshold encode kernel takes < 2^31 segments, got {segs}")
    # the status words and the ticket, zeroed: the launch's one memset; the
    # counts after them
    scratch = torch.zeros(segs + 1 + -(-len(sizes) // 2), dtype=torch.int64, device=g.device)
    counts = scratch[segs + 1:].view(torch.int32)[:len(sizes)]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = _encode_fn()(g.data_ptr(), _f32(threshold), table.data_ptr(),
                          seg_table.data_ptr(), segs, seg_tiles, out.data_ptr(),
                          counts.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"threshold encode kernel launch failed (code {rc})")
    return counts


def threshold_encode_buckets_cuda(g: Tensor, sizes: Sequence[int], ks: Sequence[int],
                                  threshold: float,
                                  out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Launch K6 (``csrc/threshold_encode.cu``) once over every bucket →
    ``(out, counts)``, bitwise ``threshold_encode_buckets_plain``: buckets
    of ``sizes`` elements end to end in the flat f32 ``g``, messages of
    ``ks`` slots end to end in the int32 ``out`` (allocated when None; the
    trainer passes its wire buffer); counts int32[len(sizes)] on the card.
    Raises for anything the kernel does not take."""
    if out is None:
        out = torch.empty(sum(ks), dtype=torch.int32, device=g.device)
    counts = _launch_encode(g, sizes, ks, threshold, out)
    threshold_encode_buckets_cuda.launches += 1
    return out, counts


threshold_encode_buckets_cuda.launches = 0


def threshold_encode_cuda(g: Tensor, k: int, threshold: float) -> Tuple[Tensor, Tensor]:
    """Launch K6 on one bucket (the table's one-entry case) → ``(out,
    count)``: out is int32[k] holding sign(g_i)·(i+1) for every i with
    |g_i| >= t in ascending i, then zeros, bitwise ``_streaming_pack``
    (selections past k are dropped); count is the number of selections,
    an int32 scalar on the card.  Raises for anything the kernel does not
    take."""
    if not g.is_cuda:
        raise ValueError("threshold_encode_cuda needs a CUDA tensor")
    if g.dtype != torch.float32:
        raise TypeError(f"the threshold encode kernel takes float32, got {g.dtype}")
    n = g.numel()
    if g.ndim != 1 or not g.is_contiguous() or not 1 <= n < 2 ** 31 - 1:
        raise ValueError("the threshold encode kernel takes a non-empty flat "
                         f"contiguous buffer of < 2^31 - 1 elements, got {tuple(g.shape)}")
    if not 1 <= k < 2 ** 31 or not threshold > 0:
        raise ValueError(f"k must be >= 1 and the threshold > 0, got k={k}, t={threshold}")
    out = torch.empty(k, dtype=torch.int32, device=g.device)
    counts = _launch_encode(g, (n,), (k,), threshold, out)
    threshold_encode_cuda.launches += 1
    return out, counts[0]


threshold_encode_cuda.launches = 0


def one_pass_pack(g: Tensor, sizes: Sequence[int], ks: Sequence[int], threshold: float,
                  out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K6 over every bucket and each bucket's selection count (see
    ``threshold_encode_buckets_cuda``): CPU tensors run the plain version;
    CUDA tensors run the kernel."""
    if g.device.type == "cpu":
        return threshold_encode_buckets_plain(g, sizes, ks, threshold, out)
    return threshold_encode_buckets_cuda(g, sizes, ks, threshold, out)


# ---------------------------------------------------------------------------
# threshold encoding (reference thresholdEncode analog)
# ---------------------------------------------------------------------------

def _check_threshold(threshold: Optional[float]) -> None:
    if threshold is not None and not threshold > 0:
        raise ValueError(f"threshold must be > 0, got {threshold}")


def _flat(gs: Sequence[Tensor]) -> Tensor:
    """The buckets end to end as one flat buffer: a view where they are
    consecutive slices of one buffer (the trainer's), else a copy."""
    first = gs[0]
    if len(gs) == 1:
        return first
    base, off = first.untyped_storage().data_ptr(), first.storage_offset()
    for g in gs:
        if not (g.is_contiguous() and g.untyped_storage().data_ptr() == base
                and g.storage_offset() == off):
            return torch.cat(gs)
        off += g.numel()
    return first.as_strided((off - first.storage_offset(),), (1,))


def _fixed_threshold_wire(gs: Sequence[Tensor], ks_max: Sequence[int], t: float):
    """Every bucket's fixed-threshold message and scale in one int32 wire
    buffer (``pack_messages``'s layout) → ``(wire, lens, [(count, k)])``.

    One one-pass pack (one K6 launch on the card) writes every message
    into the wire and counts every bucket; the counts are read in one
    copy, and a bucket whose count exceeds k is encoded again by the top-k
    pack over its slice.  The (count, k) pairs are those of the buckets
    with elements and k > 0; the others send zeros at scale 0."""
    sizes = [g.numel() for g in gs]
    live = [n > 0 and k > 0 for n, k in zip(sizes, ks_max)]
    lens = [min(k, n) if ok else max(k, 0) for n, k, ok in zip(sizes, ks_max, live)]
    total = sum(lens)
    wire = torch.empty(total + len(gs), dtype=torch.int32, device=gs[0].device)
    _, counts = one_pass_pack(_flat(gs), sizes, lens, t, wire)
    scales = wire[total:].view(torch.float32)
    scales.fill_(t)
    if not all(live):
        scales[[i for i, ok in enumerate(live) if not ok]] = 0.0
    counts = counts.tolist()                        # the step's one host read
    for g, o, k, c, ok in zip(gs, _prefix(lens), lens, counts, live):
        if ok and c > k:
            wire[o:o + k] = _topk_pack(g, g.abs(), k, t)
    return wire, lens, [(c, k) for c, k, ok in zip(counts, lens, live) if ok]


def threshold_encode_buckets(buckets: Sequence[Tensor], k_max: Optional[Sequence[int]] = None,
                             threshold: Optional[float] = None):
    """``threshold_encode`` of every bucket of one step →
    ``([(enc, scale)], [(count, k)])``.

    With a fixed threshold the messages are slices of one wire buffer
    (``_fixed_threshold_wire``: one one-pass pack over every bucket, the
    overflowing buckets encoded again by the top-k pack); the second list
    holds each counted bucket's (count, k) in bucket order.  It is empty in
    the adaptive mode.  ``k_max`` defaults to ``default_k_max`` per
    bucket."""
    _check_threshold(threshold)
    gs, ks = _as_buckets(buckets, k_max)
    if threshold is None:
        return [_adaptive_encode(g, min(k, g.numel())) if min(k, g.numel()) > 0
                else _empty_message(k, g.device) for g, k in zip(gs, ks)], []
    if not gs:
        return [], []
    wire, lens, counts = _fixed_threshold_wire(gs, ks, _f32(threshold))
    scales = wire[sum(lens):].view(torch.float32)
    return [(wire[o:o + k], scales[i]) for i, (o, k) in enumerate(zip(_prefix(lens), lens))], \
        counts


def _as_buckets(buckets: Sequence[Tensor], k_max: Optional[Sequence[int]]):
    """(flat f32 buckets, their k_max): ``default_k_max`` where not given."""
    ks = [default_k_max(b.numel()) for b in buckets] if k_max is None else list(k_max)
    return [b.reshape(-1).float() for b in buckets], ks


def _empty_message(k_max: int, device) -> Tuple[Tensor, Tensor]:
    """A bucket with nothing to send (no elements, or k <= 0): zeros at scale 0."""
    return (torch.zeros(max(k_max, 0), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def _adaptive_encode(g: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest |g| at scale = their mean (zero magnitudes never)."""
    vals, idx = _top_k(g.abs(), k)
    valid = vals > 0.0
    scale = (torch.where(valid, vals, 0.0).sum()
             / valid.sum().clamp_min(1).to(torch.float32))
    enc = torch.where(valid, _sign_index(g, idx), 0).to(torch.int32)
    return enc, scale.to(torch.float32)


def threshold_encode(g: Tensor, k_max: int,
                     threshold: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """Encode a 1-D gradient into ``(enc int32[k], scale f32[])``.

    ``enc`` entries are ``sign(g)·(index+1)`` for the selected elements and
    0 for unused capacity.  The decoded value of every transmitted element
    is ``sign·scale``:

      threshold=None (adaptive) — the k_max largest |g| (zero magnitudes
        never), scale = their mean;
      threshold=t    (reference-exact) — |g| >= t (largest first past
        capacity), scale = t.  A message that fits takes the one-pass
        pack (K6 on CUDA), index-ordered."""
    return threshold_encode_buckets([g], [k_max], threshold)[0][0]


@functools.lru_cache(maxsize=64)
def _layout(sizes: Tuple[int, ...], lens: Tuple[int, ...], device: torch.device):
    """Per-bucket (start, size, message length) as tensors on ``device``,
    for decoding every bucket of a flat buffer at once."""
    as_t = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return as_t(_prefix(sizes)), as_t(sizes), as_t(lens)


def _stack(enc: Tensor, scale: Tensor):
    """One message ([m], []) or a stack ([P, m], [P]) → ([P, m], [P, 1])."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=enc.device)
    return enc.reshape(-1, enc.shape[-1]), scale.reshape(-1, 1)


def _threshold_decode_flat(enc: Tensor, scales: Tensor, sizes, lens) -> Tensor:
    """Sum of P participants' threshold messages over a flat buffer cut
    into buckets: ``enc [P, sum(lens)]`` (each bucket's message in turn),
    ``scales [P, n_buckets]`` → f32[sum(sizes)], participant by
    participant in order."""
    n = sum(sizes)
    starts, _, lens_t = _layout(tuple(sizes), tuple(lens), enc.device)
    offset = starts.repeat_interleave(lens_t, output_size=enc.shape[1])
    out = torch.zeros(n + 1, dtype=torch.float32, device=enc.device)   # slot n: empty entries
    for e, s in zip(enc, scales):
        idx = torch.where(e == 0, n, e.abs().to(torch.int64) - 1 + offset)
        val = torch.sign(e).to(torch.float32) * s.repeat_interleave(lens_t,
                                                                    output_size=e.numel())
        out.index_put_((idx,), out[idx] + val)
    return out[:n]


def threshold_decode(enc: Tensor, scale: Tensor, n: int) -> Tensor:
    """Decode (and SUM) threshold messages back to a dense f32[n]: one
    message (``enc [k]``, ``scale []``) or a gathered stack (``enc [P, k]``,
    ``scale [P]``), participant by participant in order."""
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=enc.device)
    enc, scale = _stack(enc, scale)
    return _threshold_decode_flat(enc, scale, [n], [enc.shape[1]])


# ---------------------------------------------------------------------------
# bitmap encoding (reference bitmapEncode analog)
# ---------------------------------------------------------------------------

_SHIFTS = [2 * i for i in range(BITMAP_LANES)]


def bitmap_encode(g: Tensor, threshold: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """Encode a 1-D gradient into ``(words uint32[ceil(n/16)], scale f32[])``:
    2-bit codes, 0 → not sent, 1 → +scale, 2 → -scale.  ``threshold=None``
    uses scale = mean |g|; a fixed threshold is the reference's
    bitmapEncode.  The words are held in an int32 tensor with the uint32
    bits (PyTorch's uint32 has no shifts on every device)."""
    n = g.numel()
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=g.device),
                torch.zeros((), dtype=torch.float32, device=g.device))
    _check_threshold(threshold)
    g = g.reshape(-1).float()
    mag = g.abs()
    scale = (mag.mean() if threshold is None
             else torch.tensor(_f32(threshold), dtype=torch.float32, device=g.device))
    sel = (mag >= scale) & (scale > 0)          # scale 0: a zero gradient sends nothing
    code = torch.where(sel, torch.where(g >= 0, 1, 2), 0).to(torch.int64)
    pad = (-n) % BITMAP_LANES
    lanes = torch.nn.functional.pad(code, (0, pad)).reshape(-1, BITMAP_LANES)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=g.device)
    words = (lanes << shifts).sum(1)            # disjoint bit pairs: the sum is an OR
    return _as_int32_bits(words), scale.to(torch.float32)


def _as_int32_bits(words: Tensor) -> Tensor:
    """int64 values in [0, 2^32) → int32 holding the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _bitmap_decode_flat(words: Tensor, scales: Tensor, sizes, lens) -> Tensor:
    """Sum of P participants' bitmap messages over a flat buffer cut into
    buckets: ``words [P, sum(lens)]`` (each bucket's words in turn, its
    last word padded), ``scales [P, n_buckets]`` → f32[sum(sizes)],
    summed in participant order."""
    n = sum(sizes)
    _, sizes_t, _ = _layout(tuple(sizes), tuple(lens), words.device)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    offs = [BITMAP_LANES * o for o in _prefix(lens)]
    total = None
    for w, s in zip(words, scales):
        u = w.to(torch.int64) & 0xFFFFFFFF
        codes = ((u[:, None] >> shifts) & 3).reshape(-1)
        if len(sizes) == 1:
            codes = codes[:n]
        else:   # drop each bucket's padding codes
            codes = torch.cat([codes[o:o + m] for o, m in zip(offs, sizes)])
        v = (torch.where(codes == 1, 1.0, torch.where(codes == 2, -1.0, 0.0))
             * s.repeat_interleave(sizes_t, output_size=n))
        total = v if total is None else total + v
    return total.to(torch.float32)


def _prefix(xs) -> List[int]:
    """Exclusive running sums of ``xs``."""
    out, acc = [], 0
    for x in xs:
        out.append(acc)
        acc += x
    return out


def bitmap_decode(words: Tensor, scale: Tensor, n: int) -> Tensor:
    """Decode (and SUM) bitmap messages to a dense f32[n]: ``words [W]`` /
    ``scale []`` or gathered ``words [P, W]`` / ``scale [P]``, summed in
    participant order."""
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=words.device)
    words, scale = _stack(words, scale)
    return _bitmap_decode_flat(words, scale, [n], [words.shape[1]])


# ---------------------------------------------------------------------------
# the compressed collective
# ---------------------------------------------------------------------------

def encode_buckets(buckets: Sequence[Tensor], method: str = "threshold",
                   threshold: Optional[float] = None,
                   k_max: Optional[Sequence[int]] = None):
    """Every bucket's (message, scale) under ``method``, and the (count, k)
    of every fixed-threshold bucket (``threshold_encode_buckets``)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "threshold":
        return threshold_encode_buckets(buckets, k_max, threshold)
    return [bitmap_encode(b, threshold) for b in buckets], []


def pack_messages(msgs: Sequence[Tuple[Tensor, Tensor]]) -> Tensor:
    """One int32 wire buffer: every message, then every scale's f32 bits."""
    if not msgs:
        return torch.zeros(0, dtype=torch.int32)
    scales = torch.stack([s.reshape(()) for _, s in msgs]).view(torch.int32)
    return torch.cat([e for e, _ in msgs] + [scales])


def encode_wire(buckets: Sequence[Tensor], method: str = "threshold",
                threshold: Optional[float] = None, k_max: Optional[Sequence[int]] = None):
    """Every bucket of a step encoded into one int32 wire buffer
    (``pack_messages``'s layout) → ``(wire, lens, [(count, k)])``: lens are
    the messages' lengths in words.  A fixed threshold writes the messages
    straight into the wire (``_fixed_threshold_wire``); the other modes
    encode each bucket and pack them."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "threshold" and threshold is not None and buckets:
        _check_threshold(threshold)
        return _fixed_threshold_wire(*_as_buckets(buckets, k_max), _f32(threshold))
    msgs, counts = encode_buckets(buckets, method, threshold, k_max)
    return pack_messages(msgs), [e.numel() for e, _ in msgs], counts


def decode_wire(method: str, wire: Tensor, sizes: Sequence[int],
                lens: Sequence[int]) -> Tensor:
    """Decode-sum P packed wire buffers (``wire [P, L]``, ``pack_messages``
    of buckets of ``sizes`` elements whose messages have ``lens`` words)
    into one flat f32[sum(sizes)], participant by participant in order."""
    total = sum(lens)
    enc, scales = wire[:, :total], wire[:, total:].contiguous().view(torch.float32)
    flat = _threshold_decode_flat if method == "threshold" else _bitmap_decode_flat
    return flat(enc, scales, list(sizes), list(lens))


def decode(method: str, enc: Tensor, scale: Tensor, n: int) -> Tensor:
    return (threshold_decode if method == "threshold" else bitmap_decode)(enc, scale, n)


def compressed_pmean(buckets, group=None, method: str = "threshold",
                     threshold: Optional[float] = None, k_max=None, gather=None,
                     with_counts: bool = False):
    """Compressed mean of 1-D buckets over a process group: encode
    locally, all-gather the ENCODED buffers (the only bytes that cross
    the group), decode-sum in rank order, divide by the group size.

    ``buckets`` is one 1-D tensor or a list of them (one gather carries
    every bucket's message); the result is ``(mean, local_decoded)``, or
    two lists of them: the caller keeps ``g - local_decoded`` as its
    error-feedback residual.  ``with_counts`` appends the (count, k) of
    every fixed-threshold bucket.  ``gather(wire) -> [P, L]`` replaces
    the ``torch.distributed.all_gather`` over ``group``."""
    single = isinstance(buckets, Tensor)
    bs = [buckets] if single else list(buckets)
    ks = None if k_max is None else ([k_max] if single else list(k_max))
    wire, lens, counts = encode_wire(bs, method, threshold, ks)
    if not bs:
        return ([], [], counts) if with_counts else ([], [])
    if gather is None:
        gather = functools.partial(all_gather_stack, group=group)
    gathered = gather(wire)
    sizes = [b.numel() for b in bs]
    local = decode_wire(method, wire[None], sizes, lens)
    mean = decode_wire(method, gathered, sizes, lens) / gathered.shape[0]
    means, locals_ = list(mean.split(sizes)), list(local.split(sizes))
    out = (means[0], locals_[0]) if single else (means, locals_)
    return out + (counts,) if with_counts else out


def all_gather_stack(t: Tensor, group=None) -> Tensor:
    """``torch.distributed.all_gather`` of ``t`` over ``group`` → [P, *t.shape]."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def flat_leaves(tree) -> List[Tensor]:
    """Leaves of a list/dict tree (the port's per-layer parameter lists) in
    the JAX flatten order: list order, sorted dict keys."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]


def rebuild(template, leaves):
    """The inverse of ``flat_leaves``: ``template``'s structure over ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


class GradBucketer:
    """Partition a gradient tree (the port's list of per-layer dicts) into
    fixed-size 1-D f32 buckets, in the reference's leaf order.  Bucket
    boundaries come from the params template and are part of the wire
    format: the same instance flattens and unflattens."""

    def __init__(self, tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        leaves = flat_leaves(tree)
        self.template = tree
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(math.prod(s)) for s in self.shapes]
        self.total = int(sum(self.sizes))
        per = max(1, int(bucket_bytes) // 4)
        self.bounds = [(s, min(s + per, self.total)) for s in range(0, self.total, per)]

    @property
    def n_buckets(self) -> int:
        return len(self.bounds)

    def bucket_sizes(self) -> List[int]:
        return [e - s for s, e in self.bounds]

    def flat(self, tree) -> Tensor:
        """tree → one flat f32 buffer of ``total`` elements."""
        leaves = flat_leaves(tree)
        if not leaves:
            return torch.zeros(0, dtype=torch.float32)
        return torch.cat([l.reshape(-1).float() for l in leaves])

    def split(self, flat: Tensor) -> List[Tensor]:
        """flat buffer → the buckets (views)."""
        return [flat[s:e] for s, e in self.bounds]

    def flatten(self, tree) -> List[Tensor]:
        """tree (same structure as the template) → list of f32 buckets."""
        return self.split(self.flat(tree)) if self.total else []

    def unflat(self, flat: Tensor, cast: bool = True):
        """flat buffer → tree.  ``cast=True`` restores each leaf's template
        dtype (gradients); ``cast=False`` keeps f32 (residuals never
        round-trip through a lower-precision param dtype)."""
        out, off = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaf = flat[off:off + size].reshape(shape)
            out.append(leaf.to(dtype) if cast else leaf)
            off += size
        return rebuild(self.template, out)

    def unflatten(self, buckets: List[Tensor], cast: bool = True):
        """list of f32 buckets → tree (see ``unflat``)."""
        if not buckets:
            return rebuild(self.template, [])
        return self.unflat(torch.cat(buckets), cast)


# ---------------------------------------------------------------------------
# analytic wire model
# ---------------------------------------------------------------------------

def encoded_message_bytes(n: int, method: str = "threshold",
                          k_max: Optional[int] = None) -> int:
    """Per-participant wire bytes of one bucket's encoded message
    (indices/words buffer + the f32 scale)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if n == 0:
        return 0
    if method == "threshold":
        k = k_max if k_max is not None else default_k_max(n)
        return 4 * min(k, n) + 4
    return 4 * math.ceil(n / BITMAP_LANES) + 4


def compression_stats(n_params: int, method: str = "threshold",
                      n_slices: int = 2,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                      k_max: Optional[int] = None, itemsize: int = 4,
                      dcn_gbps: float = 25.0) -> dict:
    """Analytic accounting of the dcn tier for an ``n_params`` model, per
    participant per step: a dense ring all-reduce moves about
    2·itemsize·n bytes; the compressed all-gather (P-1)·message bytes.
    ``*_exchange_ms`` divides by ``dcn_gbps`` (an assumed link rate, not
    a measurement)."""
    per = max(1, int(bucket_bytes) // 4)
    sizes = ([min(per, n_params - s) for s in range(0, n_params, per)]
             if n_params else [])
    dense = 2 * itemsize * n_params
    msg = sum(encoded_message_bytes(b, method, k_max) for b in sizes)
    compressed = max(1, n_slices - 1) * msg
    byte_rate = dcn_gbps * 1e9
    return {
        "method": method,
        "n_slices": n_slices,
        "n_buckets": len(sizes),
        "message_bytes_per_rank": msg,
        "dense_wire_bytes_per_step": dense,
        "compressed_wire_bytes_per_step": compressed,
        "wire_ratio": (dense / compressed) if compressed else float("inf"),
        "dense_exchange_ms": dense / byte_rate * 1e3,
        "compressed_exchange_ms": compressed / byte_rate * 1e3,
    }
