"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain PyTorch versions on the same card tensors, and the port's
entry points on the card against the same port on the CPU.

Every test takes the ``cuda_dev`` fixture, which skips where there is no
card.  This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1, K2, K3 f32 2e-5 and bf16 / f16 2e-2 max abs (sums in
another order; bf16 and f16 round p and ds before their products; the same
at head widths 129-256), K2 and K3 also 1e-5
(f32) and 1e-2 (bf16, f16) in norm relative to the plain version's, the bf16
K1 1e-2 too (on the rows that see a live key) and its LSE 2e-5, and a
second launch bitwise the first (no atomics); the bf16 K1/K2/K3's wgmma
fragment layer (one tile through ``dl4j_wgmma_tile_check``) 1e-3 of
``torch.matmul`` in f32 (the same bf16 products summed in another order);
D1 2e-5, and a
query row bitwise the same in every launch shape and batch (d 64 and 256); K4 bitwise
(the same rounded ops in the same order); K5a/K5b f32 2e-6 (the same
rounded ops; only expf/tanhf may differ in the last bit; K5a as one
step of the sequence with h0 = 0 and b = 0) and, in bf16 and f16, each element
within one spacing of the dtype (2^-7 or 2^-10 of its size, plus 1e-6) of the plain
version evaluated in f32 on the same bf16 inputs (the kernel rounds each
result once); K5a over a sequence against the plain loop in f32 2e-5
abs and 1e-5 norm-relative in f32 (h·RW sums in another order, and the
error carries over the steps), in bf16 1e-2 norm-relative and 2e-2 abs
or one bf16 spacing where that is larger (z reaches 5-6, where a bf16
spacing is 0.031), a second launch bitwise the first, and the
sequence's gradients on the card 1e-5 from the CPU's; whole-model probabilities and training
losses 1e-5; decode logits bitwise the re-encode logits; a recurrent
``fit_batch`` on the card against the CPU 1e-4; K6 bitwise its plain
version (integer output); a compressed trainer step on the card against
the CPU 1e-5; the fused decode horizon replayed as a CUDA graph bitwise
the eager ``step_multi`` on the live slots' rows, with device memory flat
over 100 replays, and the decode engine's fused, chunked, prefix-cache and
temperature-0 speculative paths bitwise its plain path (int8 pages: greedy
tokens within the 80% envelope of the f32 re-encode's argmax); the
predict engine's graph replays bitwise the eager forward of the same
padded bucket and within 1e-5 of ``output()`` on the rows alone, also
under concurrent load and while another replica's graphs are captured
afresh, and a request of another per-example shape served eagerly,
never through a graph, within 1e-5 of ``output()``; a float32-param / bfloat16-compute char-RNN's losses on the card
within 2^-6 of the CPU's (bfloat16 sums in another order); ``fit_batches``
as one CUDA graph bitwise k ``fit_batch`` calls (an MLP, a TransformerLM
with K4), a dropout graph repeating from a seed bitwise, a nan-guarded
skip bitwise; ``SelfAttention`` / ``LearnedSelfAttention`` through K1-K3
against ``kernel="xla"`` within 2e-5 (gradients plus 1e-5 of their size);
a float64 LSTM on the card (the plain loop, no K5 launch) against the
CPU: loss and gradients 1e-12, parameters after updates 1e-7 (the
updaters compute in float32).  The heads of nn/layers/special.py,
objdetect.py and variational.py on the card against the CPU: YOLOv2's
score, input gradient and decoded predictions 1e-5, a center-loss step
(loss, parameters, centres) 1e-5, the VAE's ELBO and IWAE estimate fed
one noise stream 1e-5, a frozen layer's parameters bitwise unchanged;
TinyYOLO's ``fit_batches(2)`` with dict labels as one CUDA graph bitwise
two ``fit_batch`` calls under deterministic cuDNN.  ``ShardedTransformerLM``
on one rank: three f32 steps on the card against the CPU 1e-5 (losses,
parameters), ``fit_batches(2)`` in bf16 with bf16 Adam moments bitwise
its eager steps, and decode one-way and over two head shards bitwise
each program's own re-encode.  The elastic runtime: a snapshot of card
tensors is a host copy (dtype and bits kept) that later steps do not
move, and a ``fit_batches`` graph captured before a restore replays on
the restored weights, bitwise an eager run from the checkpoint.  Int8
serving: ``Int8Weight``'s padded ``torch._int_mm`` on the card (M below
17, K and N not multiples of 8, and GPT-2's head shape cut to 64 rows)
bitwise the CPU's int32 accumulator and output, inside a CUDA graph too;
an int8 predict engine's rows bitwise the eager quantized bucket, and a
replica born by the autoscaler serving from graphs captured before it
was routable.  Disaggregated decode: a prefill host's handoff continued
by a decode host on the card gives the unified engine's tokens and
bitwise its echoed logits (f32 and int8 pages), a page round trip
through ``pack_transfer`` is bitwise, and a swap on a fused-horizon
engine replays its captured graph on the new weights, bitwise a fresh
engine's, with ``compile_cache_size`` flat; so does a replay after the
``params`` setter or a swap under the same tag, and a warm bundle names
the captured graph.  The input pipeline: a batch of the prefetch ring read
right after ``next()`` equals its host source while the compute stream is
busy, a slow consumer's queued reads of a dropped batch still see it
(``record_stream``), a ``fit_batches`` capture beside a live producer
completes bitwise two ``fit_batch`` calls, and a canary's p99 reads the
replays' device time, so a host pause inside the candidate's forward does
not veto it.  The learning libraries: the negative sampler's draws on the
card bitwise the CPU's; the ordered row scatter deterministic (and, for
rows of 128 or 300, bitwise the CPU's serial ``index_add_``); Word2Vec
(SG, CBOW, SG-HS) and PV-DBOW/DM fits stacking 16 batches bitwise
one-batch, repeat and eager (no CUDA graph) fits, and within rtol 1e-4,
atol 1e-5 of the CPU's, as GloVe is; kNN tie order the CPU's; and the
chunked t-SNE's peak memory at 100,000 points under 1/10 of a dense
[N, N] f32 buffer.  The training UI: the StatsListener's statistics of
card tensors against numpy's (histogram counts and edges equal, also for
values on every computed edge; min and max bitwise; the moments 1e-6),
its records on the card the CPU's (with the allocator's memory), and a
Keras import on the card the CPU's network (parameters bitwise, outputs
1e-5).
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import compression as tcomp
from deeplearning4j_tpu_torch.ops import kv_cache as tkv
from deeplearning4j_tpu_torch.ops import lstm_kernel as tlk
from deeplearning4j_tpu_torch.ops import sampling as ts
from deeplearning4j_tpu_torch.ops import update_kernel as tuk

pytestmark = pytest.mark.cuda

SIZE = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=4, max_len=64)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, t, s, d, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                 for shape in ((b, h, t, d), (b, h, s, d), (b, h, s, d)))


def _kmask(b, s, seed, dev):
    km = (np.random.default_rng(seed).random((b, s)) >= 0.3).astype(np.int32)
    km[:, 0] = 1
    return torch.from_numpy(km).to(dev)


# (B, H, T, S, D, causal, kmask, dtype): ragged lengths, cross lengths,
# every head width up to 128, bf16
_CASES = [
    (2, 3, 64, 64, 64, True, False, torch.float32),
    (1, 2, 100, 100, 64, True, True, torch.float32),
    (2, 2, 77, 130, 32, False, True, torch.float32),
    (1, 3, 129, 129, 80, True, False, torch.float32),
    (1, 2, 65, 65, 128, False, False, torch.float32),
    (2, 2, 200, 200, 16, True, True, torch.float32),
    (2, 4, 256, 256, 64, True, False, torch.bfloat16),
    (1, 2, 90, 90, 128, True, True, torch.bfloat16),
    # the train phase's shape, and a ragged length with a key mask
    (8, 12, 1024, 1024, 64, True, False, torch.float32),
    (8, 12, 1024, 1024, 64, True, False, torch.bfloat16),
    (2, 12, 1000, 1000, 64, True, True, torch.float32),
    (2, 12, 1000, 1000, 64, True, True, torch.bfloat16),
    # the edges of the backward kernels' tiles (64 rows a block, streamed
    # tiles of 32 rows): one query row, 31/33 and 63/65 rows, causal with
    # S > T and S < T, D 128 with a key mask
    (2, 3, 1, 70, 64, False, True, torch.float32),
    (2, 3, 31, 31, 64, True, False, torch.float32),
    (2, 3, 33, 33, 64, True, True, torch.float32),
    (2, 3, 63, 63, 64, True, True, torch.float32),
    (1, 2, 33, 97, 64, True, False, torch.float32),
    (1, 2, 97, 31, 64, True, True, torch.float32),
    (1, 2, 65, 130, 128, True, True, torch.float32),
    # the bf16 tensor-core kernels (K1, K2, K3; 64 rows a block; K1's key
    # tiles 64, K2's query and K3's key tiles 64 at D <= 64 and 32 at D
    # 128): every head width class, lengths that are not multiples of 64
    # both ways, three query rows against a 1024-key cache, non-causal with
    # and without a key mask
    (2, 3, 100, 100, 32, False, True, torch.bfloat16),
    (2, 3, 100, 100, 32, True, False, torch.bfloat16),
    (1, 2, 77, 130, 80, True, False, torch.bfloat16),
    (1, 2, 130, 77, 80, False, True, torch.bfloat16),
    (1, 2, 65, 130, 128, True, True, torch.bfloat16),
    (1, 2, 97, 31, 128, False, False, torch.bfloat16),
    (2, 3, 3, 1024, 64, False, False, torch.bfloat16),
    (2, 3, 3, 1024, 64, True, True, torch.bfloat16),
    (2, 3, 1, 70, 64, False, True, torch.bfloat16),
    (2, 2, 200, 200, 16, True, True, torch.bfloat16),
    (1, 3, 129, 129, 80, True, False, torch.bfloat16),
    (2, 4, 256, 256, 64, False, False, torch.bfloat16),
    # a head width that is not a multiple of 8: plain loads, not cp.async
    (1, 2, 50, 70, 36, True, True, torch.bfloat16),
    # float16 on the tensor-core kernels at every head width class and the
    # tile edges, a head width off the multiples of 8 (plain stores)
    (2, 3, 100, 100, 32, True, True, torch.float16),
    (8, 12, 1024, 1024, 64, True, False, torch.float16),
    (1, 2, 77, 130, 80, True, False, torch.float16),
    (1, 2, 65, 130, 128, True, True, torch.float16),
    (2, 3, 3, 1024, 64, False, False, torch.float16),
    (1, 2, 50, 70, 36, True, True, torch.float16),
    # head widths 129-256 (the DP 256 instances) in every dtype: a ragged
    # width and length with a key mask, 256 causal, T != S both ways, one
    # query row, a width off the multiples of 8 (plain loads and stores)
    (2, 4, 300, 300, 160, True, True, torch.float32),
    (2, 4, 300, 300, 160, True, True, torch.bfloat16),
    (2, 4, 300, 300, 160, True, True, torch.float16),
    (2, 3, 256, 256, 256, True, False, torch.float32),
    (2, 3, 256, 256, 256, True, False, torch.bfloat16),
    (2, 3, 256, 256, 256, True, False, torch.float16),
    (1, 2, 77, 130, 256, False, True, torch.float32),
    (1, 2, 130, 77, 256, True, True, torch.bfloat16),
    (1, 2, 130, 77, 192, False, False, torch.float16),
    (2, 2, 1, 70, 256, False, True, torch.bfloat16),
    (1, 2, 90, 90, 250, True, True, torch.float32),
    (1, 2, 90, 90, 250, True, True, torch.bfloat16),
    (1, 2, 90, 90, 250, True, True, torch.float16),
]


@pytest.mark.parametrize("case", _CASES, ids=[
    f"{b}x{h}x{t}x{s}x{d}{'_causal' if c else ''}{'_kmask' if m else ''}_{str(dt)[6:]}"
    for b, h, t, s, d, c, m, dt in _CASES])
def test_flash_kernel_matches_plain(cuda_dev, case):
    b, h, t, s, d, causal, masked, dtype = case
    q, k, v = _qkv(b, h, t, s, d, t + d, cuda_dev, dtype)
    km = _kmask(b, s, s, cuda_dev) if masked else None
    before = tatt.flash_forward_cuda.launches, tatt.flash_forward_tc_cuda.launches
    o, lse = tatt.flash_forward(q, k, v, km, causal)
    torch.cuda.synchronize()
    # bf16 and f16 run the tensor-core kernel, f32 the SIMT one
    assert (tatt.flash_forward_cuda.launches, tatt.flash_forward_tc_cuda.launches) == (
        before[0] + 1, before[1] + (dtype != torch.float32))
    o_ref, lse_ref = tatt.flash_forward_plain(q, k, v, km, causal, 1.0 / math.sqrt(d))
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert float((o.float() - o_ref.float()).abs().max()) <= tol
    assert float((lse - lse_ref).abs().max()) <= 2e-5


def test_flash_tc_kernel_fully_masked_rows_bf16(cuda_dev):
    # the tensor-core K1: rows with no live key take the LSE sentinel and a
    # finite O (which keys such a row averages is left to the kernel: it
    # never loads the tiles above the diagonal); every other row matches
    q, k, v = _qkv(1, 2, 96, 96, 64, 7, cuda_dev, torch.bfloat16)
    km = torch.ones(1, 96, dtype=torch.int32, device=cuda_dev)
    km[:, :3] = 0                       # causal rows 0..2 see no live key
    o, lse = tatt.flash_forward(q, k, v, km, True)
    assert bool((lse[..., :3] == tatt.LSE_EMPTY).all())
    assert bool(torch.isfinite(o.float()).all())
    o_ref, lse_ref = tatt.flash_forward_plain(q, k, v, km, True, 1.0 / 8)
    assert float((lse[..., 3:] - lse_ref[..., 3:]).abs().max()) <= 2e-5
    assert float((o[..., 3:, :].float() - o_ref[..., 3:, :].float()).abs().max()) <= 2e-2


def _qkv_at(b, h, t, s, d, seed, dev, offset):
    """``_qkv``'s bf16 q, k, v, each starting ``offset`` elements into a
    buffer of its own (an offset of 2 puts the base 4 bytes past a 16-byte
    boundary, where TMA cannot address it)."""
    out = []
    for x in _qkv(b, h, t, s, d, seed, dev, torch.bfloat16):
        buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=dev)
        buf[offset:].copy_(x.reshape(-1))
        out.append(buf[offset:].view(x.shape))
    return out


# (B, H, T, S, D, causal, key mask, base offset in elements): D 64 and 128
# on TMA; D 40 and 96 on TMA with zero-filled columns and, from a base 2
# elements past a 16-byte boundary, on plain stores; D 36 (rows not a
# multiple of 16 bytes) on plain stores; T = S = 90, three query rows
# against 1024 keys, T 1024 against S 512, T 130 against S 77; batches whose
# keys are all masked, and causal rows 0..2 without a live key; bench config
# 7's [8, 12, 1024, 64] and [4, 12, 1024, 128]
_FWD_TC_CASES = [
    (2, 3, 90, 90, 64, True, None, 0), (2, 3, 90, 90, 128, False, "random", 0),
    (2, 3, 3, 1024, 64, True, "random", 0), (2, 3, 3, 1024, 128, False, None, 0),
    (1, 2, 1024, 512, 64, True, None, 0), (1, 2, 1024, 512, 128, False, "random", 0),
    (2, 3, 90, 90, 40, True, "random", 0), (2, 3, 90, 90, 96, False, None, 0),
    (2, 3, 90, 90, 40, False, None, 2), (2, 3, 90, 90, 96, True, "random", 2),
    (2, 3, 77, 130, 36, True, "random", 0), (1, 2, 130, 77, 64, False, None, 2),
    (2, 2, 90, 90, 64, False, "dead_batch", 0), (2, 2, 90, 90, 128, True, "dead_batch", 0),
    (1, 2, 96, 96, 64, True, "dead_prefix", 0), (1, 2, 96, 96, 128, True, "dead_prefix", 2),
    (8, 12, 1024, 1024, 64, True, None, 0), (4, 12, 1024, 1024, 128, True, None, 0),
]


@pytest.mark.parametrize("case", _FWD_TC_CASES, ids=[
    f"{b}x{h}x{t}x{s}x{d}{'_causal' if c else ''}{'_' + m if m else ''}{'_off' if o else ''}"
    for b, h, t, s, d, c, m, o in _FWD_TC_CASES])
def test_flash_fwd_wgmma_kernel_matches_plain(cuda_dev, case):
    # the bf16 K1 (wgmma, csrc/flash_fwd_tc.cu) against its plain version:
    # O 2e-2 abs and 1e-2 norm-relative on every row that sees a live key
    # (bf16 p, f32 sums in another order), the LSE 2e-5 on every row (the
    # sentinel exactly where no key is live); the O of a row without a live
    # key is finite
    b, h, t, s, d, causal, kind, off = case
    q, k, v = _qkv_at(b, h, t, s, d, 21, cuda_dev, off)
    km = _tc_kmask(kind, b, s, cuda_dev)
    scale = 1.0 / math.sqrt(d)
    tc0 = tatt.flash_forward_tc_cuda.launches
    o, lse = tatt.flash_forward_tc_cuda(q, k, v, km, causal, scale)
    torch.cuda.synchronize()
    assert tatt.flash_forward_tc_cuda.launches == tc0 + 1
    o_ref, lse_ref = tatt.flash_forward_plain(q, k, v, km, causal, scale)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and lse.shape == lse_ref.shape
    assert float((lse - lse_ref).abs().max()) <= 2e-5
    live = lse_ref < tatt.LSE_EMPTY
    assert bool(torch.isfinite(o.float()).all())
    if kind in ("dead_batch", "dead_prefix"):
        assert not bool(live.all())
    diff = (o.float() - o_ref.float())[live]
    assert float(diff.abs().max()) <= 2e-2
    assert float(diff.norm()) <= 1e-2 * float(o_ref.float()[live].norm())


@pytest.mark.parametrize("case", [(8, 12, 1024, 1024, 64, True, None, 0),
                                  (2, 3, 90, 90, 128, False, "random", 0),
                                  (2, 3, 77, 130, 36, True, "random", 2)],
                         ids=["config7_tma", "d128_kmask_tma", "d36_plain_stores"])
def test_flash_fwd_wgmma_kernel_is_deterministic(cuda_dev, case):
    # no atomics: a second launch on the same inputs gives the same bits
    b, h, t, s, d, causal, kind, off = case
    q, k, v = _qkv_at(b, h, t, s, d, 22, cuda_dev, off)
    km = _tc_kmask(kind, b, s, cuda_dev)
    o1, lse1 = tatt.flash_forward_tc_cuda(q, k, v, km, causal, 1.0 / math.sqrt(d))
    o2, lse2 = tatt.flash_forward_tc_cuda(q, k, v, km, causal, 1.0 / math.sqrt(d))
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_kernel_fully_masked_rows(cuda_dev):
    q, k, v = _qkv(1, 2, 96, 96, 64, 7, cuda_dev)
    km = torch.ones(1, 96, dtype=torch.int32, device=cuda_dev)
    km[:, :3] = 0                       # causal rows 0..2 see no live key
    o, lse = tatt.flash_forward(q, k, v, km, True)
    assert bool((lse[..., :3] == tatt.LSE_EMPTY).all())
    assert bool(torch.isfinite(o).all())
    _, lse_ref = tatt.flash_forward_plain(q, k, v, km, True, 1.0 / 8)
    assert float((lse[..., 3:] - lse_ref[..., 3:]).abs().max()) <= 2e-5


def test_flash_kernel_raises_for_what_it_does_not_take(cuda_dev):
    # a head past 256, float64, mixed dtypes and another device; head
    # widths 129-256 and float16 are taken (test_flash_kernel_matches_plain)
    q, k, v = _qkv(1, 1, 16, 16, 264, 8, cuda_dev)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_forward(q, k, v)
    g, lse = q.clone(), torch.zeros(1, 1, 16, device=cuda_dev)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_bwd_dkdv_cuda(q, k, v, g, lse, lse, None, True, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_bwd_dq_cuda(q, k, v, g, lse, lse, None, True, 0.1)
    q, k, v = _qkv(1, 1, 16, 16, 64, 8, cuda_dev)
    with pytest.raises(ValueError):
        tatt.flash_forward(q, k.cpu(), v.cpu())
    with pytest.raises(TypeError):
        tatt.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        tatt.flash_forward(q.half(), k.half(), v)
    with pytest.raises(TypeError):
        tatt.flash_forward_tc_cuda(q, k, v, None, True, 0.1)


def test_gumbel_on_card_is_bitwise_the_cpu_noise(cuda_dev):
    seeds = torch.tensor([0, 1, 12345, 2**32 - 1])
    steps = torch.tensor([0, 5, 77, 2**31 - 1])
    cpu = ts.gumbel(seeds, steps, 50304)
    card = ts.gumbel(seeds.to(cuda_dev), steps.to(cuda_dev), 50304)
    assert torch.equal(card.cpu(), cpu)


def _small_lm(device):
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(**SIZE, seed=5, device=device)


def test_output_on_card_matches_cpu_and_launches_k1(cuda_dev):
    cpu_net, card_net = _small_lm("cpu"), _small_lm(cuda_dev)
    x = np.random.default_rng(2).integers(0, SIZE["vocab_size"], (2, 64))
    before = tatt.flash_forward_cuda.launches
    y = card_net.output(x)
    torch.cuda.synchronize()
    assert tatt.flash_forward_cuda.launches == before + SIZE["n_layers"]
    assert float((y.cpu() - cpu_net.output(x)).abs().max()) <= 1e-5


def test_decode_engine_on_card(cuda_dev):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(TransformerDecodeAdapter(_small_lm(cuda_dev)), max_slots=3,
                       page_size=8, device=cuda_dev).load()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, SIZE["vocab_size"], n).tolist() for n in (5, 17, 30)]
    specs = [dict(), dict(temperature=0.8, top_k=10, seed=4), dict()]
    try:
        res = [f.result(timeout=120) for f in
               [eng.generate_async(p, max_new_tokens=10, echo_logits=True, **kw)
                for p, kw in zip(prompts, specs)]]
        assert eng.metrics_snapshot()["pages_in_use"] == 0
    finally:
        eng.shutdown()
    for p, r, kw in zip(prompts, res, specs):
        assert len(r.tokens) == 10
        with torch.inference_mode():
            ref = eng.program.reencode(eng.params, torch.tensor([p + r.tokens[:-1]],
                                                                device=cuda_dev))
        ref = ref[0, len(p) - 1:].cpu().numpy()
        np.testing.assert_array_equal(r.logits, ref)
        if not kw:
            assert ref.argmax(-1).tolist() == r.tokens


def _small_program_with_slots(cuda_dev, lens, page=8, kv_dtype=None, pools=1):
    """The small LM's decode program on the card, with ``pools`` pools of
    identical contents: slot s holds a prefilled prompt of ``lens[s]``
    random tokens."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    adapter = TransformerDecodeAdapter(_small_lm(cuda_dev))
    prog = adapter.decode_program(page_size=page)
    pps = prog.pages_per_slot
    table = torch.arange(1, 1 + len(lens) * pps, device=cuda_dev).reshape(len(lens), pps)
    rng = np.random.default_rng(21)
    caches = [tkv.alloc_cache(prog.n_layers, 1 + len(lens) * pps, page, prog.n_heads,
                              prog.d_head, device=cuda_dev, kv_dtype=kv_dtype)
              for _ in range(pools)]
    with torch.inference_mode():
        for s, n in enumerate(lens):
            toks = torch.zeros(32, dtype=torch.long, device=cuda_dev)
            toks[:n] = torch.from_numpy(rng.integers(0, SIZE["vocab_size"], n)).to(cuda_dev)
            for kp, vp in caches:
                prog.prefill(adapter.params, kp, vp, table[s], toks, n)
    return prog, adapter.params, table, caches


def _fused_inputs(rng, table, positions, steps, n_slots):
    return {"page_table": table.cpu().numpy(),
            "tokens": rng.integers(0, SIZE["vocab_size"], n_slots),
            "positions": np.asarray(positions), "active": np.array([1, 1, 1, 0], bool)[:n_slots],
            "temps": np.array([0.0, 0.8, 1.1, 0.0], np.float32)[:n_slots],
            "top_ks": np.array([0, 8, 0, 0])[:n_slots],
            "top_ps": np.array([1.0, 1.0, 0.9, 1.0], np.float32)[:n_slots],
            "seeds": np.array([1, 2, 3, 4])[:n_slots], "steps": np.asarray(steps),
            "budgets": np.array([9, 3, 6, 1])[:n_slots], "eos": np.asarray(-1)}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_step_multi_graph_replays_are_bitwise_the_eager_step_multi(cuda_dev, kv_dtype):
    from deeplearning4j_tpu_torch.serving.cuda_graphs import INPUTS, StepMultiGraph
    prog, params, table, (graph_cache, eager_cache) = _small_program_with_slots(
        cuda_dev, (5, 12, 20, 3), kv_dtype=kv_dtype, pools=2)
    H = 4
    graph = StepMultiGraph(prog, params, graph_cache, 4, H, cuda_dev)
    assert graph.launches["det_attention"] == H * SIZE["n_layers"]
    rng = np.random.default_rng(22)
    positions, steps = np.array([5, 12, 20, 0]), np.array([1, 1, 1, 0])
    for rnd in range(4):                       # inputs change every replay
        a = _fused_inputs(rng, table, positions, steps, 4)
        before = tkv.det_attention_cuda.launches
        toks, fins, lgs = (t.clone() for t in graph(**a))
        assert tkv.det_attention_cuda.launches == before + H * SIZE["n_layers"]
        d = {k: torch.from_numpy(np.asarray(v)).to(cuda_dev) for k, v in a.items()}
        with torch.inference_mode():
            _, _, et, ef, el = prog.step_multi(params, *eager_cache,
                                               *(d[k] for k, _ in INPUTS), H)
        # the rows of live slots (a stopped slot reads the scratch page,
        # whose rows two stopped slots may write in either order)
        live, alive = [], torch.from_numpy(a["active"]).to(cuda_dev)
        budgets = torch.from_numpy(a["budgets"]).to(cuda_dev)
        for j in range(H):
            live.append(alive)
            alive = alive & ef[j] & (j + 1 < budgets)
        live = torch.stack(live)
        assert live[0, :3].all() and live.sum() > 3
        assert torch.equal(toks[live], et[live]) and torch.equal(fins[live], ef[live]), rnd
        assert torch.equal(lgs[live], el[live]), rnd
        for g, e in zip(graph_cache, eager_cache):
            for x, y in zip(tkv._leaves(g), tkv._leaves(e)):
                assert torch.equal(x[:, 1:], y[:, 1:]), rnd     # the scratch page aside
        positions, steps = positions + H, steps + H
    assert graph.replays == 4


def test_step_multi_graph_memory_is_flat_over_replays(cuda_dev):
    from deeplearning4j_tpu_torch.serving.cuda_graphs import StepMultiGraph
    prog, params, table, (cache,) = _small_program_with_slots(cuda_dev, (5, 9, 14, 2))
    graph = StepMultiGraph(prog, params, cache, 4, 8, cuda_dev)
    rng = np.random.default_rng(23)
    a = _fused_inputs(rng, table, [5, 9, 14, 0], [1, 1, 1, 0], 4)
    graph(**a)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_dev)
    for _ in range(100):
        graph(**a)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_dev) == before and graph.replays == 101


@pytest.mark.parametrize("kw", [dict(decode_horizon=4), dict(prefill_chunk=12),
                                dict(prefix_cache=True), dict(draft_model="self", speculate_k=3)],
                         ids=["fused", "chunked", "prefix", "spec_temp0"])
def test_decode_features_on_card_are_bitwise_the_plain_engine(cuda_dev, kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    adapter = TransformerDecodeAdapter(_small_lm(cuda_dev))
    kw = {k: adapter if v == "self" else v for k, v in kw.items()}
    rng = np.random.default_rng(24)
    shared = rng.integers(0, SIZE["vocab_size"], 16).tolist()
    prompts = [shared + rng.integers(0, SIZE["vocab_size"], n).tolist() for n in (1, 7, 20)]
    sampled = "draft_model" not in kw
    specs = [dict(), dict(temperature=0.8, top_k=10, seed=4) if sampled else dict(), dict()]

    def serve(**extra):
        eng = DecodeEngine(adapter, max_slots=3, page_size=8, device=cuda_dev, **extra).load()
        try:
            first = eng.generate(prompts[0], max_new_tokens=10, echo_logits=True)
            rest = [f.result(timeout=120) for f in
                    [eng.generate_async(p, max_new_tokens=10, echo_logits=True, **s)
                     for p, s in zip(prompts[1:], specs[1:])]]
            return [first] + rest, eng.metrics_snapshot()
        finally:
            eng.shutdown()

    base, _ = serve()
    got, snap = serve(**kw)
    for b, g in zip(base, got):
        assert g.tokens == b.tokens
        np.testing.assert_array_equal(g.logits, b.logits)
    c = snap["counters"]
    assert snap["pages_in_use"] == snap["shared_pages"]     # only the trie holds pages
    if "decode_horizon" in kw:
        assert c["fused_dispatches"] > 0
    if kw.get("prefix_cache"):
        assert c["prefix_hits"] == 2
    if "draft_model" in kw:
        assert c["spec_accepted"] == c["spec_proposed"] > 0


def test_int8_engine_on_card_inside_the_envelope(cuda_dev):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    adapter = TransformerDecodeAdapter(_small_lm(cuda_dev))
    eng = DecodeEngine(adapter, max_slots=3, page_size=8, kv_dtype="int8",
                       device=cuda_dev).load()
    rng = np.random.default_rng(25)
    agree = total = 0
    try:
        for n in (3, 12, 30):
            p = rng.integers(0, SIZE["vocab_size"], n).tolist()
            r = eng.generate(p, max_new_tokens=10)
            with torch.inference_mode():
                ref = eng.program.reencode(eng.params, torch.tensor(
                    [p + r.tokens[:-1]], device=cuda_dev))[0, n - 1:].argmax(-1).tolist()
            agree += sum(a == b for a, b in zip(ref, r.tokens))
            total += len(r.tokens)
    finally:
        eng.shutdown()
    assert agree / total >= 0.80
    assert isinstance(eng._cache.k_pages, tkv.QuantPages)


def test_kernel_library_builds_once(cuda_dev):
    from deeplearning4j_tpu_torch.utils import cuda_build
    built = cuda_build.build(cuda_build.sources())
    assert sorted(built) == ["det_attention", "flash_bwd", "flash_bwd_tc", "flash_fwd",
                             "flash_fwd_tc", "fused_update", "lstm_cell", "threshold_encode"]
    assert all(p.exists() for p in built.values())
    assert cuda_build.load("flash_fwd") is cuda_build.load("flash_fwd")


@pytest.mark.parametrize("case", _CASES, ids=[
    f"{b}x{h}x{t}x{s}x{d}{'_causal' if c else ''}{'_kmask' if m else ''}_{str(dt)[6:]}"
    for b, h, t, s, d, c, m, dt in _CASES])
def test_flash_backward_kernels_match_plain(cuda_dev, case):
    b, h, t, s, d, causal, masked, dtype = case
    q, k, v = _qkv(b, h, t, s, d, t + d, cuda_dev, dtype)
    g = _qkv(b, h, t, t, d, t + d + 1, cuda_dev, dtype)[0]
    km = _kmask(b, s, s, cuda_dev) if masked else None
    scale = 1.0 / math.sqrt(d)
    o, lse = tatt.flash_forward(q, k, v, km, causal, scale)
    counters = (tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dq_cuda,
                tatt.flash_bwd_dkdv_tc_cuda, tatt.flash_bwd_dq_tc_cuda)
    before = [c.launches for c in counters]
    dq, dk, dv = tatt.flash_backward(q, k, v, km, o, lse, g, causal, scale)
    torch.cuda.synchronize()
    # bf16 and f16 dK/dV and dQ run the tensor-core kernels, f32 the SIMT ones
    tc = int(dtype != torch.float32)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, tc, tc]
    ref = tatt.flash_backward_plain(q, k, v, g, lse, tatt.flash_delta(o, g), km,
                                    causal, scale)
    tol, rel_tol = (2e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    for a, r in zip((dq, dk, dv), ref):
        assert a.dtype == dtype and a.shape == r.shape
        diff = a.float() - r.float()
        assert float(diff.abs().max()) <= tol
        # norm-relative: a wrong scale or mask moves every element, not only the largest
        assert float(diff.norm()) <= rel_tol * float(r.float().norm())


@pytest.mark.parametrize("shape,masked", [((8, 12, 1024, 64), False),
                                          ((2, 12, 1000, 64), True)],
                         ids=["train_shape", "kmask"])
def test_flash_backward_kernels_are_deterministic(cuda_dev, shape, masked):
    # no atomics: a second launch on the same inputs gives the same bits
    b, h, t, d = shape
    q, k, v = _qkv(b, h, t, t, d, 11, cuda_dev)
    g = _qkv(b, h, t, t, d, 12, cuda_dev)[0]
    km = _kmask(b, t, t, cuda_dev) if masked else None
    o, lse = tatt.flash_forward(q, k, v, km, True)
    first = tatt.flash_backward(q, k, v, km, o, lse, g, True, 1.0 / math.sqrt(d))
    second = tatt.flash_backward(q, k, v, km, o, lse, g, True, 1.0 / math.sqrt(d))
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)


@pytest.mark.parametrize("shape,masked", [((8, 12, 1024, 64), False),
                                          ((2, 12, 1000, 64), True),
                                          ((2, 3, 200, 128), True)],
                         ids=["train_shape", "kmask", "d128"])
def test_flash_dkdv_tc_kernel_is_deterministic(cuda_dev, shape, masked):
    # the bf16 tensor-core K2: no atomics, a second launch gives the same bits
    b, h, t, d = shape
    q, k, v = _qkv(b, h, t, t, d, 13, cuda_dev, torch.bfloat16)
    g = _qkv(b, h, t, t, d, 14, cuda_dev, torch.bfloat16)[0]
    km = _kmask(b, t, t, cuda_dev) if masked else None
    scale = 1.0 / math.sqrt(d)
    o, lse = tatt.flash_forward(q, k, v, km, True, scale)
    delta = tatt.flash_delta(o, g)
    first = tatt.flash_bwd_dkdv_tc_cuda(q, k, v, g, lse, delta, km, True, scale)
    second = tatt.flash_bwd_dkdv_tc_cuda(q, k, v, g, lse, delta, km, True, scale)
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)


@pytest.mark.parametrize("shape,masked", [((8, 12, 1024, 64), False),
                                          ((2, 12, 1000, 64), True),
                                          ((2, 3, 200, 128), True)],
                         ids=["train_shape", "kmask", "d128"])
def test_flash_dq_tc_kernel_is_deterministic(cuda_dev, shape, masked):
    # the bf16 tensor-core K3: no atomics, a second launch gives the same bits
    b, h, t, d = shape
    q, k, v = _qkv(b, h, t, t, d, 15, cuda_dev, torch.bfloat16)
    g = _qkv(b, h, t, t, d, 16, cuda_dev, torch.bfloat16)[0]
    km = _kmask(b, t, t, cuda_dev) if masked else None
    scale = 1.0 / math.sqrt(d)
    o, lse = tatt.flash_forward(q, k, v, km, True, scale)
    delta = tatt.flash_delta(o, g)
    first = tatt.flash_bwd_dq_tc_cuda(q, k, v, g, lse, delta, km, True, scale)
    second = tatt.flash_bwd_dq_tc_cuda(q, k, v, g, lse, delta, km, True, scale)
    assert torch.equal(first, second)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_dq_tc_kernel_rows_with_the_lse_sentinel_get_zero(cuda_dev, d):
    # non-causal, every key live: the rows whose LSE is the sentinel still
    # take p = 0 and so dq = 0 exactly; the other rows match the plain K3
    q, k, v = _qkv(2, 3, 100, 130, d, 17, cuda_dev, torch.bfloat16)
    g = _qkv(2, 3, 100, 100, d, 18, cuda_dev, torch.bfloat16)[0]
    scale = 1.0 / math.sqrt(d)
    o, lse = tatt.flash_forward(q, k, v, None, False, scale)
    dead = torch.zeros(100, dtype=torch.bool, device=cuda_dev)
    dead[[0, 15, 16, 63, 64, 99]] = True
    lse = torch.where(dead, torch.full_like(lse, tatt.LSE_EMPTY), lse)
    delta = tatt.flash_delta(o, g)
    dq = tatt.flash_bwd_dq_tc_cuda(q, k, v, g, lse, delta, None, False, scale)
    assert not bool(dq[:, :, dead].any())
    ref = tatt.flash_bwd_dq_plain(q, k, v, g, lse, delta, None, False, scale)
    diff = dq.float() - ref.float()
    assert float(diff.abs().max()) <= 2e-2
    assert float(diff.norm()) <= 1e-2 * float(ref.float().norm())


@pytest.mark.parametrize("tma", [1, 0], ids=["tma", "plain_stores"])
@pytest.mark.parametrize("dp,n", [(64, 64), (64, 32), (128, 64), (128, 32)])
def test_wgmma_fragment_layer_matches_matmul(cuda_dev, dp, n, tma):
    # one warpgroup, one tile each way (csrc/wgmma.cuh through
    # dl4j_wgmma_tile_check): c1 = a.b^T with both operands K-major from
    # 128-byte-swizzled shared memory, then c2 = bf16(c1).g with c1's
    # accumulators repacked as the register A and g MN-major; the tiles
    # written by TMA or by plain stores.  f32 sums in another order: 1e-3
    import ctypes

    from deeplearning4j_tpu_torch.utils import cuda_build

    fn = cuda_build.load("flash_bwd_tc").dl4j_wgmma_tile_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rng = np.random.default_rng(dp + n + tma)
    a, b, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(cuda_dev, torch.bfloat16) for shape in ((64, dp), (n, dp), (n, dp)))
    c1 = torch.full((64, n), float("nan"), device=cuda_dev)
    c2 = torch.full((64, dp), float("nan"), device=cuda_dev)
    rc = fn(a.data_ptr(), b.data_ptr(), g.data_ptr(), c1.data_ptr(), c2.data_ptr(), dp, n, tma,
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert float((c1 - a.float() @ b.float().T).abs().max()) <= 1e-3
    assert float((c2 - c1.to(torch.bfloat16).float() @ g.float()).abs().max()) <= 1e-3


def _tc_kmask(kind, b, s, dev):
    """A key mask: none, random (30% masked, key 0 live), every key of batch
    entry 1 masked, or keys 0..2 masked (causal rows 0..2 see none)."""
    if kind is None:
        return None
    km = (np.random.default_rng(s).random((b, s)) >= 0.3).astype(np.int32)
    km[:, 0] = 1
    if kind == "dead_batch":
        km[1] = 0
    elif kind == "dead_prefix":
        km[:] = 1
        km[:, :3] = 0
    return torch.from_numpy(km).to(dev)


# (B, H, T, S, D, causal, key mask): D 64 and 128 on TMA, D 40 and 96 on
# TMA with zero-filled columns, D 36 (rows not a multiple of 16 bytes) on
# plain stores; ragged T and S both ways; fully masked rows; B*H up to 256
# (1024 blocks a kernel: several waves)
_TC_CASES = [
    (2, 3, 256, 256, 64, True, None), (2, 3, 200, 200, 128, True, "random"),
    (2, 3, 100, 130, 64, False, "random"), (1, 2, 97, 31, 64, True, "random"),
    (1, 2, 33, 97, 128, True, None), (2, 3, 77, 77, 36, True, None),
    (2, 3, 129, 129, 40, True, "random"), (2, 3, 65, 97, 96, False, None),
    (2, 2, 90, 90, 64, False, "dead_batch"), (1, 2, 96, 96, 128, True, "dead_prefix"),
    (16, 16, 256, 256, 64, True, None), (16, 16, 256, 256, 128, False, "random"),
]


@pytest.mark.parametrize("case", _TC_CASES, ids=[
    f"{b}x{h}x{t}x{s}x{d}{'_causal' if c else ''}{'_' + m if m else ''}"
    for b, h, t, s, d, c, m in _TC_CASES])
def test_flash_bwd_wgmma_kernels_match_plain(cuda_dev, case):
    # the bf16 K2 and K3 (wgmma, csrc/flash_bwd_tc.cu) against their plain
    # versions: 2e-2 abs and 1e-2 norm-relative (bf16 p and ds, f32 sums in
    # another order); a second launch bitwise the first (no atomics); rows
    # that see no live key exactly 0
    b, h, t, s, d, causal, kind = case
    q, k, v = _qkv(b, h, t, s, d, 19, cuda_dev, torch.bfloat16)
    g = _qkv(b, h, t, t, d, 20, cuda_dev, torch.bfloat16)[0]
    km = _tc_kmask(kind, b, s, cuda_dev)
    scale = 1.0 / math.sqrt(d)
    o, lse = tatt.flash_forward(q, k, v, km, causal, scale)
    delta = tatt.flash_delta(o, g)
    args = (q, k, v, g, lse, delta, km, causal, scale)
    tc0 = tatt.flash_bwd_dkdv_tc_cuda.launches, tatt.flash_bwd_dq_tc_cuda.launches
    dk, dv = tatt.flash_bwd_dkdv_tc_cuda(*args)
    dq = tatt.flash_bwd_dq_tc_cuda(*args)
    torch.cuda.synchronize()
    assert (tatt.flash_bwd_dkdv_tc_cuda.launches - tc0[0],
            tatt.flash_bwd_dq_tc_cuda.launches - tc0[1]) == (1, 1)
    rk, rv = tatt.flash_bwd_dkdv_plain(*args)
    rq = tatt.flash_bwd_dq_plain(*args)
    for a, r in ((dq, rq), (dk, rk), (dv, rv)):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        diff = a.float() - r.float()
        assert float(diff.abs().max()) <= 2e-2
        assert float(diff.norm()) <= 1e-2 * float(r.float().norm())
    dk2, dv2 = tatt.flash_bwd_dkdv_tc_cuda(*args)
    dq2 = tatt.flash_bwd_dq_tc_cuda(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)
    if kind == "dead_batch":
        assert not bool(dq[1].any()) and not bool(dk[1].any()) and not bool(dv[1].any())
    if kind == "dead_prefix":
        assert not bool(dq[:, :, :3].any())
        assert not bool(dk[:, :, :3].any()) and not bool(dv[:, :, :3].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [64, 160, 256])
def test_wide_and_f16_flash_kernels_repeat_bitwise_and_count_their_instance(cuda_dev, d, dtype):
    # no atomics at any width: a second launch of K1, K2 and K3 gives the
    # same bits; each wrapper counts the launch under its dtype and width
    q, k, v = _qkv(2, 4, 300, 300, d, 23, cuda_dev, dtype)
    g = _qkv(2, 4, 300, 300, d, 24, cuda_dev, dtype)[0]
    km = _kmask(2, 300, 300, cuda_dev)
    scale = 1.0 / math.sqrt(d)
    key = f"{str(dtype)[6:]}_d{64 if d <= 64 else 256}"
    before = [w.instances[key] for w in (tatt.flash_forward_cuda, tatt.flash_bwd_dkdv_cuda,
                                         tatt.flash_bwd_dq_cuda)]
    o, lse = tatt.flash_forward_cuda(q, k, v, km, True, scale)
    o2, lse2 = tatt.flash_forward_cuda(q, k, v, km, True, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    first = tatt.flash_backward(q, k, v, km, o, lse, g, True, scale)
    second = tatt.flash_backward(q, k, v, km, o, lse, g, True, scale)
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)
    after = [w.instances[key] for w in (tatt.flash_forward_cuda, tatt.flash_bwd_dkdv_cuda,
                                        tatt.flash_bwd_dq_cuda)]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]


def test_flash_backward_rows_without_a_live_key_bf16(cuda_dev):
    # through the tensor-core K2 and K3: rows with no live key feed exactly
    # zero gradients
    q, k, v = _qkv(1, 2, 96, 96, 64, 9, cuda_dev, torch.bfloat16)
    km = torch.ones(1, 96, dtype=torch.int32, device=cuda_dev)
    km[:, :3] = 0                       # causal rows 0..2 see no live key
    qr, kr, vr = (t.requires_grad_() for t in (q, k, v))
    tc0 = tatt.flash_bwd_dq_tc_cuda.launches
    tatt.flash_mha(qr, kr, vr, True, kmask=km).float().sum().backward()
    assert tatt.flash_bwd_dq_tc_cuda.launches == tc0 + 1
    assert not bool(qr.grad[:, :, :3].any())
    assert not bool(kr.grad[:, :, :3].any()) and not bool(vr.grad[:, :, :3].any())


def test_flash_backward_rows_without_a_live_key(cuda_dev):
    q, k, v = _qkv(1, 2, 96, 96, 64, 9, cuda_dev)
    km = torch.ones(1, 96, dtype=torch.int32, device=cuda_dev)
    km[:, :3] = 0                       # causal rows 0..2 see no live key
    qr, kr, vr = (t.requires_grad_() for t in (q, k, v))
    tatt.flash_mha(qr, kr, vr, True, kmask=km).sum().backward()
    assert not bool(qr.grad[:, :, :3].any())
    assert not bool(kr.grad[:, :, :3].any()) and not bool(vr.grad[:, :, :3].any())


@pytest.mark.parametrize("kind", ["adam", "nadam"])
def test_fused_update_kernel_is_bitwise_its_plain_version(cuda_dev, kind):
    gen = torch.Generator(device=cuda_dev).manual_seed(3)
    p, g, m = (torch.randn(100_003, device=cuda_dev, generator=gen) for _ in range(3))
    v = torch.randn(100_003, device=cuda_dev, generator=gen).abs()
    sc = torch.tensor([3e-4, 1 - 0.9 ** 4, 1 - 0.999 ** 4], device=cuda_dev)
    before = tuk.fused_update_cuda.launches
    got = tuk.fused_update(kind, p, g, m, v, sc, 0.9, 0.999, 1e-8)
    assert tuk.fused_update_cuda.launches == before + 1
    want = tuk.fused_update_plain(kind, p, g, m, v, sc, 0.9, 0.999, 1e-8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_update_kernel_raises_for_what_it_does_not_take(cuda_dev):
    p = torch.ones(8, device=cuda_dev)
    sc = torch.ones(3, device=cuda_dev)
    with pytest.raises(TypeError):
        tuk.fused_update("adam", p.double(), p.double(), p.double(), p.double(),
                         sc.double(), 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError):
        tuk.fused_update("adam", p, p[:4], p, p, sc, 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("shape", [(4, 12, 1, 256), (1, 4, 100, 128), (2, 3, 37, 37)],
                         ids=["step", "prefill", "reencode"])
def test_det_attention_kernel_matches_plain_and_ignores_masked_keys(cuda_dev, shape):
    b, h, tq, L = shape
    rng = np.random.default_rng(L)
    q = torch.from_numpy(rng.standard_normal((b, h, tq, 64), dtype=np.float32)).to(cuda_dev)
    k, v = (torch.from_numpy(rng.standard_normal((b, h, L, 64), dtype=np.float32))
            .to(cuda_dev) for _ in range(2))
    pos = torch.arange(tq, device=cuda_dev) + (L - tq) // 2
    bias = torch.where(torch.arange(L, device=cuda_dev) <= pos[:, None], 0.0,
                       tkv.NEG_INF).float()[None, None]
    before = tkv.det_attention_cuda.launches
    out = tkv.det_attention(q, k, v, bias)
    assert tkv.det_attention_cuda.launches == before + 1
    assert float((out - tkv.det_attention_plain(q, k, v, bias)).abs().max()) <= 2e-5
    n = int(pos.max()) + 1              # keys past the last visible one add exact zeros
    cut = tkv.det_attention(q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous(),
                            bias[..., :n].contiguous())
    assert torch.equal(out, cut)


@pytest.mark.parametrize("tq", [1, 24], ids=["step", "prefill"])
def test_det_attention_kernel_on_the_decode_programs_layouts(cuda_dev, tq):
    # K/V as the decode program hands them over: pages gathered through a
    # shuffled table, [S, L, H, d] seen as [S, H, L, d] (key stride H·d);
    # the step's bias [S, 1, 1, L], the prefill's [1, 1, Tq, L]
    s, h, d, page, pps = 3 if tq == 1 else 1, 4, 64, 8, 6
    L = page * pps
    rng = np.random.default_rng(tq)
    pool = lambda: torch.from_numpy(rng.standard_normal(
        (2, 1 + s * pps, page, h, d), dtype=np.float32)).to(cuda_dev)
    table = torch.from_numpy(1 + rng.permutation(s * pps).reshape(s, pps)).to(cuda_dev)
    k, v = (tkv.gather_layer(pool(), 1, table).transpose(1, 2) for _ in range(2))
    assert k.stride(2) == h * d
    q = torch.from_numpy(rng.standard_normal((s, h, tq, d), dtype=np.float32)).to(cuda_dev)
    keys = torch.arange(L, device=cuda_dev)
    if tq == 1:
        pos = torch.tensor([3, 20, L - 1], device=cuda_dev)
        bias = torch.where(keys <= pos[:, None], 0.0, tkv.NEG_INF).float()[:, None, None, :]
    else:
        pos = torch.arange(tq, device=cuda_dev) + 10
        bias = torch.where(keys <= pos[:, None], 0.0, tkv.NEG_INF).float()[None, None]
    before = tkv.det_attention_cuda.launches
    out = tkv.det_attention(q, k, v, bias)
    assert tkv.det_attention_cuda.launches == before + 1
    want = tkv.det_attention_plain(q, k.contiguous(), v.contiguous(), bias)
    assert float((out - want).abs().max()) <= 2e-5
    # the same rows laid out contiguously give the same bits
    assert torch.equal(out, tkv.det_attention(q, k.contiguous(), v.contiguous(),
                                              bias.expand(s, h, tq, L).contiguous()))


def test_det_attention_rows_are_bitwise_the_same_in_every_launch(cuda_dev):
    """D1's contract at the main path's widths (H 12, d 64, L 1024): one
    sequence's query rows give the same bits in a re-encode of 1024
    tokens (tiled), a 512-row prefill into L 1024 whose keys past the
    prompt hold other values (tiled), a re-encode of 544 tokens (L = t)
    at B 2, one-row steps among 4 and 2 slots whose keys past each
    position hold other values (split-key), and the 32/33-row calls on
    either side of the split/tiled threshold."""
    _det_rows_bitwise(cuda_dev, 12, 64)


def test_det_attention_rows_are_bitwise_the_same_in_every_launch_at_d256(cuda_dev):
    """The same contract at GPT-J's head width (H 16, d 256: D1's DP 256
    instance, whose tiled launch stages one key chunk at a time)."""
    before = tkv.det_attention_cuda.instances["d256"]
    _det_rows_bitwise(cuda_dev, 16, 256)
    assert tkv.det_attention_cuda.instances["d256"] == before + 11


def _det_rows_bitwise(cuda_dev, h, d):
    L = 1024
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda_dev)
    q, k, v = t(1, h, L, d), t(1, h, L, d), t(1, h, L, d)
    keys = torch.arange(L, device=cuda_dev)

    def causal(rows, n_keys):            # [len(rows), n_keys] bias: key j visible iff j <= row
        rows = torch.as_tensor(rows, device=cuda_dev)
        return torch.where(keys[:n_keys] <= rows[:, None], 0.0, tkv.NEG_INF).float()

    def with_junk(x, pos):                # keys past pos replaced by other values
        junk = t(*x.shape)
        return torch.where(keys[None, None, :, None] <= pos, x, junk)

    before = tkv.det_attention_cuda.launches
    full = tkv.det_attention(q, k, v, causal(range(L), L)[None, None])
    assert float((full - tkv.det_attention_plain(q, k, v, causal(range(L), L)[None, None]))
                 .abs().max()) <= 2e-5
    pre = tkv.det_attention(q[:, :, :512], with_junk(k, 511), with_junk(v, 511),
                            causal(range(512), L)[None, None])
    assert torch.equal(pre, full[:, :, :512])
    q2, k2, v2 = (torch.cat([x[:, :, :544], t(1, h, 544, d)]) for x in (q, k, v))
    re = tkv.det_attention(q2, k2, v2, causal(range(544), 544)[None, None])
    assert torch.equal(re[:1], full[:, :, :544])
    assert tkv.SPLIT_ROWS == 32
    for lo, hi in ((0, 32), (480, 512), (0, 33), (479, 512)):   # split, split, tiled, tiled
        part = tkv.det_attention(q[:, :, lo:hi], k, v, causal(range(lo, hi), L)[None, None])
        assert torch.equal(part, full[:, :, lo:hi]), (lo, hi)
    for pos in ([15, 300, 511, 1023], [300, 700]):
        n = len(pos)
        ks = torch.cat([with_junk(k, p) for p in pos])
        vs = torch.cat([with_junk(v, p) for p in pos])
        qs = torch.cat([q[:, :, p:p + 1] for p in pos])
        step = tkv.det_attention(qs, ks, vs, causal(pos, L)[:, None, None, :])
        assert step.shape == (n, h, 1, d)
        for i, p in enumerate(pos):
            assert torch.equal(step[i, :, 0], full[0, :, p]), p
    assert tkv.det_attention_cuda.launches == before + 9
    # a row that sees no key keeps the plain version's answer, in both launches
    for rows in (1, 40):
        bias = causal(range(rows), L)[None, None].clone()
        bias[..., 0, :] = tkv.NEG_INF
        got = tkv.det_attention(q[:, :, :rows], k, v, bias)
        want = tkv.det_attention_plain(q[:, :, :rows], k, v, bias)
        assert float((got - want).abs().max()) <= 2e-5
        assert torch.equal(got[:, :, 1:], full[:, :, 1:rows])


@pytest.mark.parametrize("case", ["spec_verify", "chunk_at_offset"])
def test_det_attention_kernel_at_the_spec_and_chunk_shapes(cuda_dev, case):
    """D1 at the shapes speculative verify and chunked prefill give it (H
    12, d 64, L 1024, paged K/V): 4 slots x 5 rows at scattered positions
    (split-key), and 128 rows at positions 256..383 (tiled); within 2e-5
    of the plain version, and every row bitwise the same row launched
    alone."""
    h, d, L, page = 12, 64, 1024, 16
    if case == "spec_verify":
        pos = [[p + i for i in range(5)] for p in (15, 300, 700, L - 5)]
    else:
        pos = [list(range(256, 384))]
    B, tq = len(pos), len(pos[0])
    rng = np.random.default_rng(26)
    pps = L // page
    table = torch.from_numpy(1 + rng.permutation(B * pps).reshape(B, pps)).to(cuda_dev)
    k, v = (tkv.gather_layer(torch.from_numpy(rng.standard_normal(
        (1, 1 + B * pps, page, h, d), dtype=np.float32)).to(cuda_dev), 0, table).transpose(1, 2)
        for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, h, tq, d), dtype=np.float32)).to(cuda_dev)
    keys = torch.arange(L, device=cuda_dev)
    bias = torch.where(keys <= torch.tensor(pos, device=cuda_dev)[..., None], 0.0,
                       tkv.NEG_INF).float()[:, None]
    out = tkv.det_attention(q, k, v, bias)
    want = tkv.det_attention_plain(q, k.contiguous(), v.contiguous(), bias)
    assert float((out - want).abs().max()) <= 2e-5
    for r in range(0, tq, 1 if tq <= 5 else 17):
        alone = tkv.det_attention(q[:, :, r:r + 1], k, v, bias[:, :, r:r + 1])
        assert torch.equal(alone[:, :, 0], out[:, :, r]), r


@pytest.mark.parametrize("fused", ["0", "1"], ids=["per_leaf", "fused"])
def test_fit_batch_on_card_matches_cpu_and_launches_k1_to_k4(cuda_dev, monkeypatch, fused):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.utils.params import params_to_numpy

    monkeypatch.setenv(tuk.ENV_SWITCH, fused)
    cpu_net, card_net = _small_lm("cpu"), _small_lm(cuda_dev)
    start = params_to_numpy(cpu_net.params)
    x = np.random.default_rng(4).integers(0, SIZE["vocab_size"], (2, 65))
    ds = DataSet(x[:, :-1], x[:, 1:])
    counters = (tatt.flash_forward_cuda, tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dq_cuda,
                tuk.fused_update_cuda)
    before = [c.launches for c in counters]
    for _ in range(3):
        lc, lg = cpu_net.fit_batch(ds), card_net.fit_batch(ds)
        assert abs(float(lc) - float(lg)) <= 1e-5
    torch.cuda.synchronize()
    n = SIZE["n_layers"]
    want = [3 * n, 3 * n, 3 * n, 3 * (n + 3) if fused == "1" else 0]
    assert [c.launches - b for c, b in zip(counters, before)] == want
    # Adam divides each gradient by its running RMS, so an element whose
    # gradient is near zero can move by up to a step (lr) differently on
    # the two devices; the update as a whole agrees to 1%
    lr = card_net.conf.updater.lr
    for p0, pc, pg in zip(start, params_to_numpy(cpu_net.params),
                          params_to_numpy(card_net.params)):
        for key in pc:
            assert np.abs(pc[key] - pg[key]).max() <= lr
            assert np.linalg.norm(pc[key] - pg[key]) <= 1e-2 * np.linalg.norm(pc[key] - p0[key])


def _cell_inputs(mb, n, seed, dev, dtype):
    """z ~ N(0, 1), c ~ N(0, 0.25), cotangents ~ N(0, 0.01): a trained
    cell's ranges."""
    rng = np.random.default_rng(seed)
    t = lambda shape, s: torch.from_numpy(s * rng.standard_normal(shape, dtype=np.float32))
    return tuple(x.to(dev, dtype) for x in (t((mb, 4 * n), 1.0), t((mb, n), 0.5),
                                            t((mb, n), 0.1), t((mb, n), 0.1)))


def _check_cell_kernels(mb, n, dtype, dev):
    """K5a through one step of the sequence (T = 1, h0 = 0, b = 0, so
    z = zx exactly) and K5b, against the plain cell and its backward."""
    z, c, dh, dcn = _cell_inputs(mb, n, mb * n, dev, dtype)
    rw = torch.randn(n, 4 * n, generator=torch.Generator().manual_seed(n)).to(dev, dtype)
    zeros = torch.zeros(mb, n, device=dev, dtype=dtype)
    before = (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches)
    hs, _, _, _, c_new = tlk.lstm_seq_fwd(z[:, None].contiguous(), rw,
                                          torch.zeros(4 * n, device=dev, dtype=dtype),
                                          zeros, c)
    got = (hs[:, 0], c_new) + tlk.lstm_cell_bwd(z, c, dh, dcn)
    torch.cuda.synchronize()
    assert (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    f = lambda *ts: [t.float() for t in ts]
    want = (tlk.lstm_cell_plain(*f(z, c)) + tlk.lstm_cell_bwd_plain(*f(z, c, dh, dcn)))
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        err = (a.float() - w).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 2e-6
        else:
            # the kernel rounds the f32 result once: within one spacing of
            # the dtype (bf16 2^-7, f16 2^-10 relative) of the plain
            # version in f32
            assert bool((err <= _SPACING[dtype] * w.abs() + 1e-6).all())


#: the relative spacing of the 2-byte dtypes (2^-mantissa bits)
_SPACING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [32, 256, 512])
@pytest.mark.parametrize("mb", [1, 7, 64])
def test_lstm_cell_kernels_match_plain(cuda_dev, mb, n, dtype):
    _check_cell_kernels(mb, n, dtype, cuda_dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mb,n", [(64, 255), (3, 3), (4096, 256)])
def test_lstm_cell_kernels_match_plain_at_more_shapes(cuda_dev, mb, n, dtype):
    """n % 4 != 0 ([64, 255], [3, 3]: a partial block of K5b's units), and
    many waves of K5b's blocks ([4096, 256])."""
    _check_cell_kernels(mb, n, dtype, cuda_dev)


def test_lstm_cell_kernels_raise_for_what_they_do_not_take(cuda_dev):
    z, c, dh, dcn = _cell_inputs(4, 8, 1, cuda_dev, torch.float32)
    zx, rw, b, h0, c0, _ = _seq_inputs(4, 3, 8, 1, cuda_dev, torch.float32)
    # float64 and mixed dtypes are refused (float16 is taken:
    # test_lstm_seq_kernel_matches_plain)
    with pytest.raises(TypeError):
        tlk.lstm_seq_fwd_cuda(zx.double(), rw.double(), b.double(), h0.double(), c0.double())
    with pytest.raises(TypeError):
        tlk.lstm_seq_fwd(zx.half(), rw.half(), b.half(), h0.half(), c0)
    with pytest.raises(TypeError):
        tlk.lstm_seq_fwd(zx, rw, b, h0, c0.bfloat16())
    with pytest.raises(ValueError, match="zx \\[mb, T, 4n\\]"):
        tlk.lstm_seq_fwd(zx[..., :-1].contiguous(), rw, b, h0, c0)
    with pytest.raises(ValueError, match="contiguous"):
        tlk.lstm_seq_fwd(zx.transpose(0, 1).contiguous().transpose(0, 1), rw, b, h0, c0)
    with pytest.raises(ValueError, match="CUDA device"):
        tlk.lstm_seq_fwd(zx, rw, b, h0.cpu(), c0)
    with pytest.raises(ValueError, match="z \\[mb, 4n\\]"):
        tlk.lstm_cell_bwd(z[:, :-1].contiguous(), c, dh, dcn)
    with pytest.raises(ValueError, match="contiguous"):
        tlk.lstm_cell_bwd(z, c, dh.t().contiguous().t(), dcn)
    with pytest.raises(ValueError, match="CUDA device"):
        tlk.lstm_cell_bwd(z, c.cpu(), dh, dcn)


def _seq_inputs(mb, t_len, n, seed, dev, dtype):
    """zx ~ N(0, 1), RW ~ N(0, 1/n), b ~ N(0, 0.01), h0 and c0 ~ N(0, 0.25)
    and a 0/1 mask (first step kept), the same draws for every dtype."""
    rng = np.random.default_rng(seed)
    t = lambda shape, sd: torch.from_numpy(sd * rng.standard_normal(shape, dtype=np.float32))
    ins = (t((mb, t_len, 4 * n), 1.0), t((n, 4 * n), 1.0 / math.sqrt(n)), t((4 * n,), 0.1),
           t((mb, n), 0.5), t((mb, n), 0.5))
    mask = (rng.random((mb, t_len)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return tuple(x.to(dev, dtype) for x in ins) + (torch.from_numpy(mask).to(dev),)


# (mb, T, n, dtype, masked, reverse): the char-RNN's chunk, a wider layer,
# ragged rows, the stream's step, n % 4 != 0 and n < 8 (partial unit
# tiles), more tiles than the card holds at once (streamed RW), n past one
# chunk of k, masks, reverse, bf16
_SEQ_CASES = [
    (64, 50, 256, torch.float32, False, False),
    (64, 100, 512, torch.float32, False, False),
    (7, 13, 256, torch.float32, False, False),
    (1, 1, 256, torch.float32, False, False),
    (5, 9, 255, torch.float32, False, False),
    (3, 4, 3, torch.float32, True, False),
    (64, 50, 256, torch.float32, True, False),
    (64, 50, 256, torch.float32, False, True),
    (7, 13, 256, torch.float32, True, True),
    (2048, 3, 256, torch.float32, False, False),
    (64, 5, 1200, torch.float32, True, False),
    (64, 50, 256, torch.bfloat16, False, False),
    (7, 13, 255, torch.bfloat16, True, True),
    (1, 1, 256, torch.bfloat16, False, False),
    (64, 50, 256, torch.float16, False, False),
    (7, 13, 255, torch.float16, True, True),
    (1, 1, 256, torch.float16, False, False),
]


@pytest.mark.parametrize("case", _SEQ_CASES, ids=[
    f"{mb}x{t}x{n}_{str(dt)[6:]}{'_masked' if m else ''}{'_reverse' if r else ''}"
    for mb, t, n, dt, m, r in _SEQ_CASES])
def test_lstm_seq_kernel_matches_plain(cuda_dev, case):
    """K5a against the plain per-step loop evaluated in f32 on the same
    inputs: f32 2e-5 abs and 1e-5 norm-relative, bf16 and f16 1e-2
    norm-relative and 2e-2 abs, or one spacing of the dtype (2^-7 of the
    value in bf16, 2^-10 in f16) where that is larger: z reaches 5-6 here,
    where bf16's own spacing is 0.031 and the plain version in bf16 misses
    2e-2 by as much; a second launch bitwise the first."""
    mb, t_len, n, dtype, masked, reverse = case
    *ins, mask = _seq_inputs(mb, t_len, n, mb + t_len + n, cuda_dev, dtype)
    mask = mask if masked else None
    before = tlk.lstm_seq_fwd_cuda.launches
    got = tlk.lstm_seq_fwd(*ins, mask, reverse)
    again = tlk.lstm_seq_fwd(*ins, mask, reverse)
    torch.cuda.synchronize()
    assert tlk.lstm_seq_fwd_cuda.launches == before + 2
    want = tlk.lstm_seq_fwd_plain(*(x.float() for x in ins), mask, reverse)
    atol, rel = (2e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        d = a.float() - w
        if dtype == torch.float32:
            assert float(d.abs().max()) <= atol
        else:
            assert bool((d.abs() <= torch.clamp(_SPACING[dtype] * w.abs(), min=atol)).all())
        assert float(d.norm()) <= rel * float(w.norm())


def test_lstm_seq_kernel_keeps_rw_resident_on_the_char_rnn_shape(cuda_dev):
    ins = _seq_inputs(64, 50, 256, 1, cuda_dev, torch.float32)[:5]
    tlk.lstm_seq_fwd(*ins)
    assert tlk.lstm_seq_fwd_cuda.plan == (128, True)
    tlk.lstm_seq_fwd(*_seq_inputs(1, 1, 256, 1, cuda_dev, torch.float32)[:5])
    assert tlk.lstm_seq_fwd_cuda.plan == (32, True)
    tlk.lstm_seq_fwd(*_seq_inputs(2048, 2, 256, 1, cuda_dev, torch.float32)[:5])
    assert tlk.lstm_seq_fwd_cuda.plan[1] is False


@pytest.mark.parametrize("masked,reverse", [(False, False), (True, True)],
                         ids=["unmasked", "masked_reverse"])
def test_lstm_sequence_gradients_on_card_match_cpu(cuda_dev, masked, reverse):
    """LSTMSequence on the card (K5a, K5b per step) against autograd of the
    plain loop on the CPU: 1e-5 on every gradient."""
    *ins, mask = _seq_inputs(6, 12, 40, 7, "cpu", torch.float32)
    mask = mask if masked else None
    w = torch.randn(6, 12, 40, generator=torch.Generator().manual_seed(1))

    def grads(dev):
        xs = [x.to(dev).requires_grad_() for x in ins]
        hs, (h, c) = tlk.lstm_sequence(*xs, None if mask is None else mask.to(dev), reverse)
        ((hs * w.to(dev)).sum() + h.sum() + 2 * c.sum()).backward()
        return [x.grad.cpu() for x in xs]

    before = (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches)
    card = grads(cuda_dev)
    assert (tlk.lstm_seq_fwd_cuda.launches - before[0],
            tlk.lstm_cell_bwd_cuda.launches - before[1]) == (1, 12)
    for a, b in zip(card, grads("cpu")):
        assert float((a - b).abs().max()) <= 1e-5


def _small_rnn(device):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(lr=1e-3))
            .gradient_normalization("clip_elementwise_absolute_value", 1.0)
            .layer(LSTM(n_out=64)).layer(LSTM(n_out=64))
            .layer(RnnOutputLayer(n_out=20, activation="softmax", loss="mcxent"))
            .tbptt(10).set_input_type(InputType.recurrent(20)).build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


@pytest.mark.parametrize("fused", ["0", "1"], ids=["plain_cell", "fused_cell"])
def test_recurrent_fit_batch_on_card_matches_cpu_and_counts_k5(cuda_dev, monkeypatch, fused):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.utils.params import params_to_numpy

    from deeplearning4j_tpu_torch.nn.layers import recurrent

    if fused == "0":                    # the plain loop on the card, for the A/B
        monkeypatch.setattr(recurrent, "lstm_sequence", tlk.lstm_sequence_plain)
    cpu_net, card_net = _small_rnn("cpu"), _small_rnn(cuda_dev)
    x = np.random.default_rng(5).integers(0, 20, (4, 31)).astype(np.int32)
    ds = DataSet(x[:, :-1], x[:, 1:])
    before = (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches)
    for _ in range(2):
        lc, lg = cpu_net.fit_batch(ds), card_net.fit_batch(ds)
        assert abs(float(lc) - float(lg)) <= 1e-4
    torch.cuda.synchronize()
    # K5a once per call x layer x TBPTT chunk of 10, K5b once per time step
    want = (2 * 2 * 3, 2 * 2 * 30) if fused == "1" else (0, 0)
    assert (tlk.lstm_seq_fwd_cuda.launches - before[0],
            tlk.lstm_cell_bwd_cuda.launches - before[1]) == want
    assert cpu_net.iteration == card_net.iteration == 6
    for pc, pg in zip(params_to_numpy(cpu_net.params), params_to_numpy(card_net.params)):
        for key in pc:
            assert np.linalg.norm(pc[key] - pg[key]) <= 1e-4 * np.linalg.norm(pc[key])
    # streaming on the card: the same distributions as output()
    card_net.rnn_clear_previous_state()
    full = card_net.output(x[:, :5])
    for t in range(5):
        step = card_net.rnn_time_step(x[:, t])
        assert float((step - full[:, t]).abs().max()) <= 1e-5


def _hot_grad(n, seed, frac=0.02, t=1e-3):
    """~frac of the elements clear t (the JAX package's test_fused_encode generator)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=n).astype(np.float32) * (t / 10)
    hot = rng.choice(n, max(1, int(n * frac)), replace=False)
    g[hot] = rng.normal(size=hot.size).astype(np.float32) * 10 * t
    return g


def _encode_input(n, kind, t=1e-3):
    """The kernel phase's cases: the 2%-hot gradient, none selected, or
    exactly k = n/16 selected."""
    if kind == "hot":
        return _hot_grad(n, n)
    if kind == "none":
        return _hot_grad(n, n) * 1e-3
    rng = np.random.default_rng(n + 1)
    g = rng.uniform(-0.5, 0.5, size=n).astype(np.float32) * t
    hot = rng.choice(n, tcomp.default_k_max(n), replace=False)
    g[hot] = (np.where(rng.random(hot.size) < 0.5, -1, 1) * t * (1 + rng.random(hot.size)))
    return g


_ENC_CASES = [(n, kind) for n in (1024, 4096, 1 << 20, (1 << 20) + 333)
              for kind in ("hot", "none", "exact_k")]


@pytest.mark.parametrize("n,kind", _ENC_CASES, ids=[f"{n}_{k}" for n, k in _ENC_CASES])
def test_threshold_encode_kernel_is_bitwise_its_plain_version(cuda_dev, n, kind):
    g = torch.from_numpy(_encode_input(n, kind)).to(cuda_dev)
    k = tcomp.default_k_max(n)
    got, got_count = tcomp.threshold_encode_cuda(g, k, 1e-3)
    want = tcomp._streaming_pack(g, g.abs(), k, 1e-3, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tcomp._streaming_pack(g.cpu(), g.abs().cpu(), k, 1e-3, n))
    count = int((g.abs() >= 1e-3).sum())
    assert int(got_count) == count
    assert int((got != 0).sum()) == min(count, k)
    if kind == "exact_k":
        assert count == k


def test_threshold_encode_kernel_raises_for_what_it_does_not_take(cuda_dev):
    g = torch.ones(64, device=cuda_dev)
    for bad, err in ((g.cpu(), ValueError), (g.double(), TypeError), (g.reshape(8, 8), ValueError),
                     (g[::2], ValueError), (g[:0], ValueError)):
        with pytest.raises(err):
            tcomp.threshold_encode_cuda(bad, 4, 0.5)
    with pytest.raises(ValueError):
        tcomp.threshold_encode_cuda(g, 0, 0.5)
    with pytest.raises(ValueError):
        tcomp.threshold_encode_cuda(g, 4, 0.0)


def test_threshold_encode_on_card_counts_then_routes(cuda_dev):
    """One K6 launch encodes and counts every bucket; the buckets whose
    count exceeds k are encoded again by the top-k pack; every message
    and count is the CPU's, entry for entry."""
    n = 1 << 16
    grads = [_hot_grad(n, 1), _hot_grad(n, 2, frac=0.2), _hot_grad(n, 3), _hot_grad(77, 4, 0.3)]
    fits = [int((np.abs(g) >= 1e-3).sum()) <= tcomp.default_k_max(g.size) for g in grads]
    assert fits == [True, False, True, False]
    before = (tcomp.threshold_encode_buckets_cuda.launches, tcomp.threshold_encode_cuda.launches)
    card, card_counts = tcomp.threshold_encode_buckets(
        [torch.from_numpy(g).to(cuda_dev) for g in grads], threshold=1e-3)
    torch.cuda.synchronize()
    assert (tcomp.threshold_encode_buckets_cuda.launches - before[0],
            tcomp.threshold_encode_cuda.launches - before[1]) == (1, 0)
    cpu, cpu_counts = tcomp.threshold_encode_buckets([torch.from_numpy(g) for g in grads],
                                                     threshold=1e-3)
    assert card_counts == cpu_counts
    assert [c <= k for c, k in card_counts] == fits
    for (ec, sc), (eg, sg) in zip(cpu, card):
        assert torch.equal(ec, eg.cpu()) and sc.item() == sg.item()


@pytest.mark.parametrize("method,t", [("threshold", 0.05), ("threshold", None), ("bitmap", None)])
def test_compressed_trainer_on_card_matches_cpu(cuda_dev, method, t):
    """One rank, one slice: the compressed step on the card (K6 on every
    fixed-threshold bucket) against the same step on the CPU, losses
    within 1e-5."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 12)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    losses = []
    for dev in ("cpu", cuda_dev):
        conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr=0.05))
                .layer(Dense(n_out=16, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(12)).build())
        net = MultiLayerNetwork(conf, device=dev)
        net.init()
        trainer = ShardedTrainer(net, build_two_tier_mesh(1), grad_compression=method,
                                 compression_threshold=t)
        before = tcomp.threshold_encode_buckets_cuda.launches
        losses.append([float(trainer.fit_batch(DataSet(xs, ys))) for _ in range(4)])
        launched = tcomp.threshold_encode_buckets_cuda.launches - before
    # a fixed threshold launches K6 once a step (at t = 0.05 one of the
    # four steps fits k; the others go on to the top-k pack)
    assert launched == (4 if t == 0.05 else 0)
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=0)
    assert losses[1][-1] < losses[1][0]


def test_compressed_step_launches_k6_once_over_every_bucket(cuda_dev):
    """One rank, one slice, 64-element buckets: each step of the
    fixed-threshold exchange launches K6 once for all its buckets, and
    never the one-bucket launch; losses within 1e-5 of the CPU's."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 12)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    losses, counts = [], []
    for dev in ("cpu", cuda_dev):
        conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr=0.05))
                .layer(Dense(n_out=16, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(12)).build())
        net = MultiLayerNetwork(conf, device=dev)
        net.init()
        trainer = ShardedTrainer(net, build_two_tier_mesh(1), grad_compression="threshold",
                                 compression_threshold=0.05,
                                 compression_bucket_mb=256 / (1 << 20))
        before = (tcomp.threshold_encode_buckets_cuda.launches,
                  tcomp.threshold_encode_cuda.launches)
        losses.append([float(trainer.fit_batch(DataSet(xs, ys))) for _ in range(3)])
        counts.append(trainer.last_bucket_counts)
    assert trainer.bucketer.n_buckets == 5 and len(counts[1]) == 5
    assert (tcomp.threshold_encode_buckets_cuda.launches - before[0],
            tcomp.threshold_encode_cuda.launches - before[1]) == (3, 0)
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=0)


def _smoke():
    """The repository's ``chip_smoke.py`` as a module: the compressed
    phase's bucket layout (``DP_BUCKET_SIZES``) and its gradient generator
    (``step_gradient``) are defined there once."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()


def _step_case(name, dev):
    """(g, bucket sizes, {bucket: count it must have}) of one layout."""
    if name == "full":
        return cs.step_gradient(cs.DP_BUCKET_SIZES, seed=1), cs.DP_BUCKET_SIZES, {}
    if name == "misaligned":                  # 1,000,003-element buckets, from g[1]:
        sizes = [1_000_003] * 40 + [77]       # scalar loads, multi-tile segments
        return cs.step_gradient([1] + sizes, seed=2)[1:], sizes, {}
    if name == "tile_edges":                  # below a tile, tile multiples +- 1
        sizes = [1, 1000, 4095, 4096, 4097, 8191, 8192, 8193, 3 * 4096]
        return cs.step_gradient(sizes, seed=3, frac=0.05), sizes, {}
    n = 1 << 16                               # none, exactly k and k + 1 selected
    k = tcomp.default_k_max(n)
    parts = [_encode_input(n, "none"), _encode_input(n, "exact_k")]
    over = _encode_input(n, "none")
    over[np.random.default_rng(9).choice(n, k + 1, replace=False)] = 2e-3
    return torch.from_numpy(np.concatenate(parts + [over])).to(dev), [n] * 3, \
        {0: 0, 1: k, 2: k + 1}


@pytest.mark.parametrize("name", ["full", "misaligned", "tile_edges", "counts"])
def test_threshold_encode_step_is_bitwise_its_plain_version(cuda_dev, name):
    """One K6 launch over every bucket: each message bitwise
    ``threshold_encode_buckets_plain``'s and the counts exact, at the
    compressed phase's 156-bucket layout, with misaligned bucket starts,
    buckets under a tile and at tile multiples +- 1, and counts of 0, k
    and k + 1."""
    g, sizes, want = _step_case(name, cuda_dev)
    ks = [tcomp.default_k_max(n) for n in sizes]
    before = tcomp.threshold_encode_buckets_cuda.launches
    out, counts = tcomp.threshold_encode_buckets_cuda(g, sizes, ks, 1e-3)
    torch.cuda.synchronize()
    assert tcomp.threshold_encode_buckets_cuda.launches - before == 1
    want_out, want_counts = tcomp.threshold_encode_buckets_plain(g, sizes, ks, 1e-3)
    assert torch.equal(out, want_out)
    exact = [int((b.abs() >= 1e-3).sum()) for b in g[:sum(sizes)].split(sizes)]
    assert counts.tolist() == want_counts.tolist() == exact
    assert all(exact[b] == c for b, c in want.items())


def test_threshold_encode_step_is_deterministic(cuda_dev):
    """50 launches over the full layout give the same bits: the slots do
    not depend on the order the blocks run in (a missing fence in the
    look-back would show only now and then)."""
    g = cs.step_gradient(cs.DP_BUCKET_SIZES, seed=4)
    ks = [tcomp.default_k_max(n) for n in cs.DP_BUCKET_SIZES]
    first, first_counts = tcomp.threshold_encode_buckets_cuda(g, cs.DP_BUCKET_SIZES, ks, 1e-3)
    same = [torch.equal(out, first) and torch.equal(counts, first_counts)
            for out, counts in (tcomp.threshold_encode_buckets_cuda(g, cs.DP_BUCKET_SIZES, ks, 1e-3)
                                for _ in range(49))]
    assert all(same)
    assert torch.equal(first, tcomp.threshold_encode_buckets_plain(g, cs.DP_BUCKET_SIZES, ks, 1e-3)[0])


# -- the predict engine's CUDA graphs and mixed dtypes on the card ----------------------------


def _eager_bucket(net, x, bucket):
    """The eager forward of ``x`` zero-padded to ``bucket`` rows, the
    rows of ``x`` on the host."""
    pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)
    xp = torch.from_numpy(np.concatenate([x, pad])).to(net.device)
    with torch.inference_mode():
        y = net._apply_layers(net.params, net.state, xp, None, train=False)[0]
    return y[:x.shape[0]].cpu().numpy()


def _engine_lm(cuda_dev, replicas=2):
    from deeplearning4j_tpu_torch.serving import Engine
    net = _small_lm(cuda_dev)
    eng = Engine(net, max_batch=4, replicas=replicas, slo_ms=60_000,
                 device=cuda_dev).load(input_shape=(SIZE["max_len"],))
    return net, eng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_graph_rows_through_its_pinned_buffer_are_the_pageable_rows(cuda_dev, dtype):
    # a graph's rows reach the host through its page-locked buffer (a DMA
    # and an event), bitwise what a pageable copy of the same output gives,
    # at buckets 1, 2, 4 and every row count; the rows handed back are a
    # copy that the next replay does not touch
    from deeplearning4j_tpu_torch.serving import cuda_graphs as cg
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(64, 300, generator=gen, device=cuda_dev).to(dtype)

    def fwd(x):
        return torch.tanh(x.to(dtype) @ w) * 1e3
    for bucket in (1, 2, 4):
        g = cg.ForwardGraph(fwd, (bucket, 64), torch.float32, cuda_dev)
        assert g.host.is_pinned() and g.host.shape == g.output.shape
        assert g.host.dtype == torch.float32
        rng = np.random.default_rng(bucket)
        for rows in range(1, bucket + 1):
            x = rng.standard_normal((bucket, 64)).astype(np.float32)
            out, finite = g(x, rows)
            ref, ref_finite = cg.rows_to_host(g.output, rows)   # pageable
            assert finite and ref_finite and out.shape == ref.shape == (rows, 300)
            assert out.dtype == ref.dtype == np.float32 and out.tobytes() == ref.tobytes()
            kept = out.copy()
            g(rng.standard_normal((bucket, 64)).astype(np.float32), rows)
            assert out.tobytes() == kept.tobytes()
        g.release()


def test_engine_graph_replay_is_bitwise_eager_at_each_bucket(cuda_dev):
    """Every (bucket, replica) graph replays bitwise the eager forward of
    the same padded bucket, within 1e-5 of ``output()`` on the rows
    alone; K1 launches n_layers per replay; nothing is captured or run
    unwarmed while serving."""
    net, eng = _engine_lm(cuda_dev)
    try:
        assert eng.compile_cache_size() == 3 * 2
        rng = np.random.default_rng(30)
        for rows, bucket in ((1, 1), (2, 2), (3, 4), (4, 4)):
            x = rng.integers(0, SIZE["vocab_size"], (rows, SIZE["max_len"])).astype(np.float32)
            for idx in range(2):
                before = tatt.flash_forward_cuda.launches
                g = eng._current.programs[(idx, bucket, "float32")]
                out, finite = g(np.concatenate(
                    [x, np.zeros((bucket - rows, SIZE["max_len"]), np.float32)]), rows)
                assert finite and tatt.flash_forward_cuda.launches - before == SIZE["n_layers"]
                np.testing.assert_array_equal(out, _eager_bucket(net, x, bucket))
            served = eng.output(x)
            np.testing.assert_array_equal(served, _eager_bucket(net, x, bucket))
            assert float(np.abs(served - net.output(x).cpu().numpy()).max()) <= 1e-5
        assert eng.compile_cache_size() == 3 * 2
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
    finally:
        eng.shutdown()


def test_engine_replicas_keep_their_own_buffers_under_concurrent_load(cuda_dev):
    import threading

    net, eng = _engine_lm(cuda_dev)
    try:
        ptrs = {g.input.data_ptr() for g in eng._current.programs.values()}
        assert len(ptrs) == 6                      # no two graphs share an input
        rng = np.random.default_rng(31)
        xs = [rng.integers(0, SIZE["vocab_size"], (1 + i % 3, SIZE["max_len"]))
              .astype(np.float32) for i in range(40)]
        outs = [None] * len(xs)

        def client(k):
            for i in range(k, len(xs), 4):
                outs[i] = eng.output(xs[i])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for x, out in zip(xs, outs):
            assert float(np.abs(out - net.output(x).cpu().numpy()).max()) <= 1e-5
        assert all(r.processed > 0 for r in eng._replicas)
        assert eng.compile_cache_size() == 6
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
    finally:
        eng.shutdown()


def test_engine_rewarm_captures_while_another_replica_serves(cuda_dev):
    """Replica 1's graphs are captured afresh (thread-local capture mode)
    while traffic flows; every result stays right and the program count
    does not change."""
    import threading

    net, eng = _engine_lm(cuda_dev)
    try:
        old = {k: g for k, g in eng._current.programs.items() if k[0] == 1}
        rng = np.random.default_rng(32)
        xs = [rng.integers(0, SIZE["vocab_size"], (1 + i % 3, SIZE["max_len"]))
              .astype(np.float32) for i in range(24)]
        outs, stop = [], threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                x = xs[i % len(xs)]
                outs.append((x, eng.output(x)))
                i += 1

        t = threading.Thread(target=traffic)
        t.start()
        for _ in range(3):
            eng._rewarm_replica(1)
        stop.set()
        t.join(timeout=300)
        new = {k: g for k, g in eng._current.programs.items() if k[0] == 1}
        assert set(new) == set(old) and all(new[k] is not old[k] for k in old)
        assert eng.compile_cache_size() == 6 and len(outs) > 0
        for x, out in outs:
            assert float(np.abs(out - net.output(x).cpu().numpy()).max()) <= 1e-5
    finally:
        eng.shutdown()


def test_engine_other_feature_shape_never_replays_a_graph(cuda_dev):
    """A request whose per-example shape is not the warmed one runs
    eagerly, never broadcast into a graph's input: an Iris [2, 1] fails
    (no 200 on /predict), and a TransformerLM row of 32 ids, warmed at
    64, is ``output()``'s within 1e-5, counted as unwarmed."""
    import json
    import os
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.serving import Engine
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    iris = load_model(os.path.join(os.path.dirname(__file__), "..", "deeplearning4j_tpu",
                                   "models", "weights", "iris_mlp_iris.zip"), device=cuda_dev)
    eng = Engine(iris, max_batch=4, replicas=2, slo_ms=60_000, device=cuda_dev).load()
    server = UIServer(port=0, host="127.0.0.1").attach_engine(eng).start()
    try:
        with pytest.raises(Exception):
            eng.output(np.ones((2, 1), np.float32))
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict",
                                     data=json.dumps({"inputs": [[1.0], [2.0]]}).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        assert code != 200
    finally:
        server.stop()
        eng.shutdown()

    net, eng = _engine_lm(cuda_dev, replicas=1)
    try:
        x = np.random.default_rng(33).integers(0, SIZE["vocab_size"], (2, 32)).astype(np.float32)
        replays = sum(g.replays for g in eng._current.programs.values())
        out = eng.output(x)
        assert out.shape == (2, 32, SIZE["vocab_size"])
        assert float(np.abs(out - net.output(x).cpu().numpy()).max()) <= 1e-5
        assert sum(g.replays for g in eng._current.programs.values()) == replays
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 1
    finally:
        eng.shutdown()


def test_mixed_dtype_char_rnn_on_card_matches_cpu(cuda_dev):
    """float32 parameters computed in bfloat16: the index-input LSTM runs
    K5a/K5b in bfloat16 on the card; three TBPTT ``fit_batch`` calls
    agree with the CPU within 2^-6 in the loss and keep float32
    parameters."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork

    base = _small_rnn("cpu")
    d = base.conf.to_dict()
    d["compute_dtype"] = "bfloat16"
    nets = []
    for dev in ("cpu", cuda_dev):
        n = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d), device=dev)
        n.params = [{k: v.to(dev) for k, v in p.items()} for p in base.params]
        n.state = [{} for _ in base.params]
        n.opt_state = n.init_opt_state(n.params)
        nets.append(n)
    x = np.random.default_rng(33).integers(0, 20, (4, 21)).astype(np.int32)
    ds = DataSet(x[:, :-1], x[:, 1:])
    before = tlk.lstm_seq_fwd_cuda.launches
    for _ in range(3):
        lc, lg = (float(n.fit_batch(ds)) for n in nets)
        assert abs(lc - lg) <= 2.0 ** -6
    assert tlk.lstm_seq_fwd_cuda.launches - before == 3 * 2 * 2
    assert all(t.dtype == torch.float32 for p in nets[1].params for t in p.values())
    y = nets[1].output(x)
    assert y.dtype == torch.bfloat16


# -- the MLP fit path: fit_batches as one CUDA graph, dropout, attention layers, f64 --


def _mlp(device, dropout=0.0, noise=None, dtype="float32", seed=3):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Nesterovs(lr=0.1, momentum=0.9))
            .layer(Dense(n_out=32, activation="relu", dropout=dropout))
            .layer(Dense(n_out=16, activation="relu", dropout=dropout, weight_noise=noise))
            .layer(OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).dtype(dtype, dtype).build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


def _mlp_batches(k, seed=0, mb=16):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(seed)
    return [DataSet(rng.standard_normal((mb, 12), dtype=np.float32),
                    np.eye(5, dtype=np.float32)[rng.integers(0, 5, mb)]) for _ in range(k)]


def _differing(a_params, b_params):
    """[(layer, name, max abs difference)] of the leaves that differ."""
    return [(i, k, float((p[k] - q[k]).abs().max()))
            for i, (p, q) in enumerate(zip(a_params, b_params)) for k in p
            if not torch.equal(p[k], q[k])]


def _bitwise(a_params, b_params):
    return not _differing(a_params, b_params)


def test_fit_batches_graph_is_bitwise_eager_on_an_mlp(cuda_dev):
    batches = _mlp_batches(4)
    eager, graphed = _mlp(cuda_dev), _mlp(cuda_dev)
    le = [float(eager.fit_batch(ds)) for ds in batches]
    lg = [float(x) for x in graphed.fit_batches(batches)]
    assert le == lg and _bitwise(eager.params, graphed.params)
    assert graphed.fit_graph_count == 1 and graphed.iteration == 4
    # again from the graph's state, after an eager step in between
    more = _mlp_batches(4, seed=1)
    eager.fit_batch(more[0])
    graphed.fit_batch(more[0])
    le = [float(eager.fit_batch(ds)) for ds in more]
    lg = [float(x) for x in graphed.fit_batches(more)]
    assert le == lg and _bitwise(eager.params, graphed.params)
    assert _bitwise([o["v"] for o in eager.opt_state if o],
                    [o["v"] for o in graphed.opt_state if o])
    assert graphed.fit_graph_count == 1 and graphed.iteration == eager.iteration == 9


def test_fit_batches_graph_is_bitwise_eager_on_a_transformer_with_k4(cuda_dev, monkeypatch):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    monkeypatch.setenv(tuk.ENV_SWITCH, "1")
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, SIZE["vocab_size"], (4, SIZE["max_len"] + 1)) for _ in range(2)]
    batches = [DataSet(s[:, :-1], s[:, 1:]) for s in seqs]
    eager, graphed = TransformerLM(**SIZE, device=cuda_dev), TransformerLM(**SIZE, device=cuda_dev)
    le = [float(eager.fit_batch(ds)) for ds in batches]
    lg = [float(x) for x in graphed.fit_batches(batches)]
    assert le == lg and _differing(eager.params, graphed.params) == []
    # a replay adds the captured launches: one K4 per layer with parameters
    # and step, K1-K3 one per block and step
    before = [c.launches for c in (tuk.fused_update_cuda, tatt.flash_forward_cuda,
                                   tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dq_cuda)]
    le = [float(eager.fit_batch(ds)) for ds in batches]
    n_eager = [c.launches for c in (tuk.fused_update_cuda, tatt.flash_forward_cuda,
                                    tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dq_cuda)]
    lg = [float(x) for x in graphed.fit_batches(batches)]
    after = [c.launches for c in (tuk.fused_update_cuda, tatt.flash_forward_cuda,
                                  tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dq_cuda)]
    assert le == lg and _bitwise(eager.params, graphed.params)
    n_layers = sum(1 for p in graphed.params if p)
    want = [2 * n_layers] + [2 * SIZE["n_layers"]] * 3
    assert [b - a for a, b in zip(before, n_eager)] == want
    assert [b - a for a, b in zip(n_eager, after)] == want
    assert graphed.fit_graph_count == 1


def test_fit_batches_graph_with_dropout_repeats_from_a_seed(cuda_dev):
    from deeplearning4j_tpu_torch.nn.conf.regularizers import DropConnect

    batches = _mlp_batches(4, seed=2)
    runs = []
    for _ in range(2):
        net = _mlp(cuda_dev, dropout=0.5, noise=DropConnect(0.9))
        losses = [float(x) for x in net.fit_batches(batches)]
        losses += [float(x) for x in net.fit_batches(batches)]
        runs.append((losses, net.params))
    assert runs[0][0] == runs[1][0] and _bitwise(runs[0][1], runs[1][1])
    # each replay draws fresh numbers: the same batches give other losses
    assert runs[0][0][:4] != runs[0][0][4:]


def test_nan_guard_on_card_skips_bitwise(cuda_dev):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import DivergenceError

    net = _mlp(cuda_dev)
    net.set_nan_guard(2)
    good = _mlp_batches(1)[0]
    bad = DataSet(good.features.copy(), good.labels)
    bad.features[0, 0] = np.nan
    net.fit_batch(good)
    snap = [{k: v.clone() for k, v in p.items()} for p in net.params]
    opt = [{k: {n: t.clone() for n, t in d.items()} for k, d in o.items()} for o in net.opt_state]
    net.fit_batch(bad)
    assert _bitwise(snap, net.params)
    assert all(torch.equal(a, b) for o1, o2 in zip(opt, net.opt_state) for k in o1
               for a, b in zip(o1[k].values(), o2[k].values()))
    net.fit_batch(bad)
    with pytest.raises(DivergenceError):
        net.fit_batch(bad)


@pytest.mark.parametrize("causal,masked,t", [(True, True, 64), (False, True, 37),
                                             (True, False, 40)])
def test_self_attention_layer_runs_k1_k3_and_matches_plain(cuda_dev, causal, masked, t):
    from deeplearning4j_tpu_torch.nn.layers import SelfAttention

    layer = SelfAttention(n_in=32, n_out=32, n_heads=4, causal=causal)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(cuda_dev).requires_grad_(True)
              for k, v in layer.init_params(gen, None).items()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, t, 32), dtype=np.float32)).to(cuda_dev)
    mask = None
    if masked:
        m = (rng.random((3, t)) > 0.25).astype(np.float32)
        m[2] = 0.0                     # a fully masked row
        mask = torch.from_numpy(m).to(cuda_dev)
    outs, grads = [], []
    for kernel in ("flash", "xla"):
        layer.kernel = kernel
        before = [c.launches for c in (tatt.flash_forward_cuda, tatt.flash_bwd_dkdv_cuda,
                                        tatt.flash_bwd_dq_cuda)]
        y = layer.forward(params, {}, x, mask=mask).y
        g = torch.autograd.grad((y * y).sum(), list(params.values()))
        after = [c.launches for c in (tatt.flash_forward_cuda, tatt.flash_bwd_dkdv_cuda,
                                      tatt.flash_bwd_dq_cuda)]
        launched = [a - b for a, b in zip(after, before)]
        assert launched == ([1, 1, 1] if kernel == "flash" else [0, 0, 0])
        outs.append(y.detach())
        grads.append(g)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)


def test_learned_self_attention_runs_k1_with_three_queries(cuda_dev):
    from deeplearning4j_tpu_torch.nn.layers import LearnedSelfAttention

    layer = LearnedSelfAttention(n_in=48, n_out=48, n_heads=4, n_queries=3)
    params = {k: v.to(cuda_dev).requires_grad_(True)
              for k, v in layer.init_params(torch.Generator().manual_seed(2), None).items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 70, 48), dtype=np.float32)).to(cuda_dev)
    outs, grads = [], []
    for kernel in ("flash", "xla"):
        layer.kernel = kernel
        before = tatt.flash_forward_cuda.launches
        y = layer.forward(params, {}, x).y
        assert tatt.flash_forward_cuda.launches - before == (kernel == "flash")
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y.sum(), list(params.values())))
    assert outs[0].shape == (2, 3, 48)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_float64_lstm_on_card_takes_the_plain_loop(cuda_dev):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration

    conf = (NeuralNetConfiguration.builder().seed(4)
            .layer(LSTM(n_out=16)).layer(RnnOutputLayer(n_out=6, activation="softmax"))
            .set_input_type(InputType.recurrent(6)).dtype("float64", "float64").build())
    rng = np.random.default_rng(6)
    ds = DataSet(rng.standard_normal((4, 9, 6)), np.eye(6)[rng.integers(0, 6, (4, 9))])
    nets = []
    for dev in (cuda_dev, "cpu"):
        net = MultiLayerNetwork(conf, device=dev)
        net.init()
        nets.append(net)
    before = (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches)
    # the float64 loss and gradients: 1e-12
    (l0, g0, _), (l1, g1, _) = (n._loss_and_grads(ds) for n in nets)
    assert abs(float(l0) - float(l1)) <= 1e-12
    for a, b in zip(g0, g1):
        for k in a:
            np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(), rtol=0, atol=1e-12)
    # after updates, one float32 spacing: the updaters compute in float32
    # (as the reference's do), so a last-bit difference of a float64
    # gradient can round a parameter to the next float32
    losses = [[float(n.fit_batch(ds)) for _ in range(3)] for n in nets]
    assert (tlk.lstm_seq_fwd_cuda.launches, tlk.lstm_cell_bwd_cuda.launches) == before
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=1e-7)
    for p, q in zip(*(n.params for n in nets)):
        for k in p:
            assert p[k].dtype == torch.float64
            np.testing.assert_allclose(p[k].cpu().numpy(), q[k].numpy(), rtol=0, atol=1e-7)


# -- the conv path ----------------------------------------------------------------

_CONV_CASES = [
    ("Convolution2D", dict(n_out=8, kernel=(7, 7), stride=(2, 2), convolution_mode="same",
                           has_bias=False), (4, 20, 20, 3)),
    ("Convolution2D", dict(n_out=6, kernel=(3, 3), dilation=(2, 2)), (2, 11, 12, 4)),
    ("Convolution1D", dict(n_out=5, kernel=4, stride=2), (2, 13, 3)),
    ("Deconvolution2D", dict(n_out=3, kernel=(3, 3), stride=(2, 2), convolution_mode="same"),
     (2, 5, 6, 4)),
    ("SeparableConvolution2D", dict(n_out=6, kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same", depth_multiplier=2), (2, 9, 9, 3)),
    ("Subsampling2D", dict(pooling="max", kernel=(3, 3), stride=(2, 2),
                           convolution_mode="same"), (4, 16, 16, 8)),
    ("Subsampling2D", dict(pooling="avg", kernel=(2, 2), stride=(2, 2),
                           convolution_mode="same"), (2, 7, 7, 3)),
    ("Subsampling2D", dict(pooling="pnorm", kernel=(2, 2), stride=(1, 1)), (2, 6, 6, 3)),
    ("GlobalPooling", dict(pooling="avg"), (4, 7, 7, 16)),
    ("LocalResponseNormalization", dict(), (2, 5, 5, 9)),
    ("Upsampling2D", dict(size=(2, 2)), (2, 3, 4, 5)),
]


def _conv_layer(name, kw, shape):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn import layers as L
    layer = getattr(L, name)(**kw)
    it = (InputType.recurrent(shape[-1], shape[1]) if len(shape) == 3
          else InputType.convolutional(*shape[1:]))
    layer.infer_nin(it)
    return layer, layer.init_params(torch.Generator().manual_seed(3), it)


@pytest.mark.parametrize("name,kw,shape", _CONV_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_CONV_CASES)])
def test_conv_path_layer_on_card_matches_cpu(cuda_dev, name, kw, shape):
    """Forward, input and weight gradients of a conv-path layer on the card
    (cuDNN, channels-last views of NHWC) against the CPU: 1e-5 forward,
    1e-4 gradients (cuDNN sums in other orders)."""
    layer, params = _conv_layer(name, kw, shape)
    x = np.random.default_rng(4).standard_normal(shape, dtype=np.float32)
    outs = []
    for dev in (cuda_dev, torch.device("cpu")):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = layer.forward(p, {}, xt).y
        w = torch.from_numpy(np.random.default_rng(5).standard_normal(
            tuple(y.shape), dtype=np.float32)).to(dev)
        grads = torch.autograd.grad((y * w).sum(), [xt] + [p[k] for k in sorted(p)])
        outs.append((y.detach().cpu(), [g.cpu() for g in grads]))
    (yc, gc), (yh, gh) = outs
    torch.testing.assert_close(yc, yh, rtol=0, atol=1e-5)
    for a, b in zip(gc, gh):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_batchnorm_on_card_matches_cpu_with_its_running_state(cuda_dev, compute):
    """BatchNorm training forward and 3 steps of running statistics on the
    card against the CPU: f32 1e-5; bf16 within one bfloat16 spacing of
    the normalized value's magnitude (the sums of E[x²] and E[x] in f32
    run in other orders)."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization
    layer = BatchNormalization(activation="relu")
    layer.infer_nin(InputType.convolutional(6, 6, 16))
    params = layer.init_params(None, None)
    dt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    rng = np.random.default_rng(7)
    xs = [(2 * rng.standard_normal((8, 6, 6, 16), dtype=np.float32) + 0.5) for _ in range(3)]
    runs = []
    for dev in (cuda_dev, torch.device("cpu")):
        state = {k: v.to(dev) for k, v in layer.init_state(None).items()}
        ys = []
        for x in xs:
            out = layer.forward({k: v.to(dev) for k, v in params.items()}, state,
                                torch.from_numpy(x).to(dev, dt), train=True)
            state = out.state
            ys.append(out.y.float().cpu())
        runs.append((ys, {k: v.cpu() for k, v in state.items()}))
    (yc, sc), (yh, sh) = runs
    tol = 1e-5 if compute == "float32" else 2.0 ** -7 * 4
    for a, b in zip(yc, yh):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    for k in sc:
        torch.testing.assert_close(sc[k], sh[k], rtol=1e-5 if compute == "float32" else 2 ** -7,
                                   atol=1e-6)


def test_resnet_block_train_step_on_card_matches_cpu(cuda_dev):
    """A ResNet-50 at 32x32 (every block kind) takes one Nesterovs step on
    the card and on the CPU from the same weights: loss, output, every
    parameter and BatchNorm statistic within 1e-4 (batch 8, where the step
    is well conditioned; cuDNN and the CPU sum in other orders)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    nets = [ResNet50(32, 32, 3, 10, updater=Nesterovs(lr=0.1, momentum=0.9), device=d)
            for d in (cuda_dev, "cpu")]
    nets[0].conf.param_dtype = nets[0].conf.compute_dtype = "float64"
    nets[1].conf.param_dtype = nets[1].conf.compute_dtype = "float64"
    for n in nets:
        n.init()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 32, 32, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    losses = [float(n.fit_batch(DataSet(x, y))) for n in nets]
    assert abs(losses[0] - losses[1]) < 1e-4
    torch.testing.assert_close(nets[0].output(x)[0].cpu(), nets[1].output(x)[0],
                               rtol=0, atol=1e-4)
    for tree in ("params", "state", "opt_state"):
        a, b = getattr(nets[0], tree), getattr(nets[1], tree)
        for v in a:
            for k, t in (a[v].items()):
                u = b[v][k]
                if isinstance(t, dict):
                    for kk in t:
                        torch.testing.assert_close(t[kk].cpu(), u[kk], rtol=0, atol=1e-4)
                else:
                    torch.testing.assert_close(t.cpu(), u, rtol=0, atol=1e-4)


def test_fit_batches_graph_is_bitwise_eager_on_a_bn_cnn(cuda_dev):
    """A CNN with BatchNorm (LeNet-shaped, BN after each conv):
    fit_batches(2) as one CUDA graph against 2 fit_batch calls under
    deterministic cuDNN: losses, parameters, momenta and running
    statistics bitwise."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import SimpleCNN
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _bitwise_bn_cnn(cuda_dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _bitwise_bn_cnn(cuda_dev):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import SimpleCNN
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    rng = np.random.default_rng(9)
    batches = [DataSet(rng.standard_normal((16, 16, 16, 3), dtype=np.float32),
                       np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]) for _ in range(2)]
    runs = []
    for graphed in (False, True):
        net = SimpleCNN(16, 16, 3, 5, updater=Nesterovs(lr=0.05, momentum=0.9), device=cuda_dev)
        for layer in net.conf.layers:      # no dropout: the draws would differ
            layer.dropout = 0.0
        losses = ([float(s) for s in net.fit_batches(batches)] if graphed
                  else [float(net.fit_batch(b)) for b in batches])
        runs.append((losses, net.clone_params(), net.clone_state(), net.opt_state))
    (l0, p0, s0, o0), (l1, p1, s1, o1) = runs
    assert l0 == l1
    for a, b in ((p0, p1), (s0, s1), (o0, o1)):
        for u, v in zip(a, b):
            for k in u:
                if isinstance(u[k], dict):
                    assert all(torch.equal(u[k][kk], v[k][kk]) for kk in u[k])
                else:
                    assert torch.equal(u[k], v[k])


# -- the heads of this slice: YOLOv2, center loss, VAE, FrozenLayer -------------------------


def _yolo_batch(n, grid, seed, boxes=5, classes=20):
    rng = np.random.default_rng(seed)
    b = (rng.standard_normal((n, grid, grid, boxes, 4)) * 0.3).astype(np.float32)
    b[..., :2] = rng.random((n, grid, grid, boxes, 2))
    obj = np.zeros((n, grid, grid, boxes), np.float32)
    cls = np.zeros((n, grid, grid, classes), np.float32)
    for i in range(n):
        for _ in range(3):
            r, c, k = rng.integers(0, grid, 2).tolist() + [int(rng.integers(0, boxes))]
            obj[i, r, c, k] = 1
            cls[i, r, c] = 0
            cls[i, r, c, rng.integers(0, classes)] = 1
    return {"boxes": b, "obj": obj, "cls": cls}


def test_yolo_head_on_card_matches_cpu(cuda_dev):
    from deeplearning4j_tpu_torch.nn.layers import Yolo2OutputLayer

    layer = Yolo2OutputLayer(anchors=[[1.08, 1.19], [3.42, 4.41], [6.63, 11.38],
                                      [9.42, 5.11], [16.62, 10.52]], n_classes=20)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 13, 13, 125), dtype=np.float32)
    y = _yolo_batch(4, 13, 4)
    out = {}
    for dev in ("cpu", cuda_dev):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        loss = layer.score({}, {}, xt, {k: torch.from_numpy(v).to(dev) for k, v in y.items()})
        (g,) = torch.autograd.grad(loss, xt)
        dec = layer.decode_predictions(xt.detach())
        out[str(dev)] = (float(loss), g.cpu(), {k: v.cpu() for k, v in dec.items()})
    (l0, g0, d0), (l1, g1, d1) = out.values()
    assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l0))
    assert float((g0 - g1).abs().max()) <= 1e-5
    for k in d0:
        assert torch.allclose(d0[k].double(), d1[k].double(), rtol=0, atol=1e-5), k


def test_center_loss_step_on_card_matches_cpu(cuda_dev):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import CenterLossOutputLayer, Dense, FrozenLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 12), dtype=np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 32)]
    nets = []
    for dev in ("cpu", cuda_dev):
        conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(lr=1e-2))
                .layer(FrozenLayer(layer=Dense(n_out=10, activation="tanh")))
                .layer(Dense(n_out=8, activation="tanh"))
                .layer(CenterLossOutputLayer(n_out=6, activation="softmax", lambda_=0.1,
                                             alpha=0.2))
                .set_input_type(InputType.feed_forward(12)).build())
        net = MultiLayerNetwork(conf, device=dev)
        net.init()
        frozen = {k: v.clone() for k, v in net.params[0].items()}
        losses = [float(net.fit_batch(DataSet(x, y))) for _ in range(3)]
        assert all(torch.equal(net.params[0][k], v) for k, v in frozen.items())
        nets.append((losses, net))
    (l0, n0), (l1, n1) = nets
    assert np.allclose(l0, l1, rtol=0, atol=1e-5)
    assert float((n0.state[2]["centers"] - n1.state[2]["centers"].cpu()).abs().max()) <= 1e-5
    assert torch.count_nonzero(n1.state[2]["centers"]) > 0
    for p, q in zip(n0.params, n1.params):
        for k in p:
            assert float((p[k] - q[k].cpu()).abs().max()) <= 1e-5


def test_vae_on_card_matches_cpu_with_one_noise_stream(cuda_dev, monkeypatch):
    from deeplearning4j_tpu_torch.nn.conf import regularizers
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoder
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy

    for kind in ("bernoulli", "gaussian"):
        layer = VariationalAutoencoder(n_in=784, n_out=32, encoder_layer_sizes=[256, 256],
                                       decoder_layer_sizes=[256, 256], reconstruction=kind,
                                       num_samples=2)
        p = params_to_numpy(layer.init_params(torch.Generator().manual_seed(1), None))
        rng = np.random.default_rng(2)
        x = (rng.random((64, 784)) < 0.3).astype(np.float32)
        res = []
        for dev in ("cpu", cuda_dev):
            stream = np.random.default_rng(7)
            monkeypatch.setattr(regularizers, "normal", lambda gen, shape, d=dev: torch.from_numpy(
                stream.standard_normal(tuple(shape)).astype(np.float32)).to(d))
            pt = params_from_numpy(p, device=dev)
            xt = torch.from_numpy(x).to(dev)
            gen = torch.Generator(device=dev)       # unused: the stream stands in for it
            elbo = float(layer.elbo_score(pt, xt, generator=gen))
            lp = layer.reconstruction_log_probability(pt, xt, generator=gen, num_samples=5)
            res.append((elbo, lp.cpu()))
        assert abs(res[0][0] - res[1][0]) <= 1e-5 * max(1.0, abs(res[0][0]))
        assert torch.allclose(res[0][1], res[1][1], rtol=1e-6, atol=1e-4)


def test_tinyyolo_fit_batches_graph_with_dict_labels_is_bitwise_eager(cuda_dev):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import TinyYOLO

    rng = np.random.default_rng(11)
    batches = [DataSet(rng.standard_normal((8, 64, 64, 3), dtype=np.float32),
                       _yolo_batch(8, 2, 20 + i)) for i in range(2)]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = []
        for graphed in (False, True):
            # a fresh network each time: in the graphed run the anchors are
            # first made in the eager warm-up before the capture, which
            # would refuse their copy from the host
            net = TinyYOLO(64, 64, 3, 20, device=cuda_dev)
            losses = ([float(s) for s in net.fit_batches(batches)] if graphed
                      else [float(net.fit_batch(b)) for b in batches])
            runs.append((losses, net.clone_params(), net.clone_state()))
        net.fit_batches(batches)            # a repeat call captures nothing new
        assert net.fit_graph_count == 1
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    for a, b in ((p0, p1), (s0, s1)):
        for u, v in zip(a, b):
            assert all(torch.equal(u[k], v[k]) for k in u)


# -- ShardedTransformerLM on one rank ---------------------------------------------

_LM = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=4, max_len=64)


def _sharded_lm(dev, **kw):
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh

    return ShardedTransformerLM(**_LM, mesh=kw.pop("mesh", build_mesh({"data": 1})),
                                seed=5, device=dev, **kw)


def _lm_batch(seed=3, b=4, t=64):
    tok = np.random.default_rng(seed).integers(0, _LM["vocab_size"], (b, t))
    return tok, np.roll(tok, -1, axis=1)


def test_sharded_lm_step_on_card_matches_cpu(cuda_dev):
    """Three f32 SGD steps (K1-K3 on the card, their plain versions on the
    CPU): losses and parameters within 1e-5."""
    from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves

    tok, tgt = _lm_batch()
    runs = []
    for dev in (cuda_dev, "cpu"):
        lm = _sharded_lm(dev, updater=Sgd(lr=0.1))
        losses = [float(lm.fit_batch(tok, tgt)) for _ in range(3)]
        runs.append((losses, [np.asarray(a) for a in tree_leaves(lm.params_numpy())]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_sharded_lm_fit_batches_graph_is_bitwise_eager_in_bf16(cuda_dev):
    """``fit_batches(2)`` as one CUDA graph against two ``fit_batch`` calls
    from the same start, bf16 compute and bf16 Adam moments: losses,
    parameters and moments bitwise; one graph after a repeat call."""
    from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_leaves

    batches = [_lm_batch(seed) for seed in (7, 8)]
    runs = []
    for graphed in (False, True):
        lm = _sharded_lm(cuda_dev, compute_dtype="bfloat16",
                         updater=Adam(lr=3e-4, moment_dtype="bfloat16"))
        if graphed:
            losses = [float(s) for s in lm.fit_batches(np.stack([b[0] for b in batches]),
                                                       np.stack([b[1] for b in batches]))]
        else:
            losses = [float(lm.fit_batch(*b)) for b in batches]
        runs.append((losses, [t.clone() for t in tree_leaves((lm.params, lm.opt_state))]))
    lm.fit_batches(np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]))
    assert len(lm._fit_graphs) == 1
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_lm_decode_on_card_is_bitwise_its_reencode(cuda_dev, tp):
    """One-way and two head shards on the card: every echoed logit bitwise
    the program's own re-encode; the tensor-parallel pool is two shards."""
    from deeplearning4j_tpu_torch.parallel import build_mesh
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    lm = _sharded_lm(cuda_dev, mesh=build_mesh({"data": tp}, world_size=tp))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, _LM["vocab_size"], n).tolist() for n in (5, 17, 40)]
    eng = DecodeEngine(lm, max_slots=4, page_size=16, device=cuda_dev).load()
    try:
        futs = [eng.generate_async(p, max_new_tokens=8, echo_logits=True, temperature=0.0)
                for p in prompts]
        results = [f.result(timeout=120) for f in futs]
        assert eng.metrics_snapshot()["tp"] == tp
        if tp > 1:
            assert all(len(pool) == tp for pool in eng._cache)
        for p, r in zip(prompts, results):
            with torch.inference_mode():
                ref = eng.program.reencode(eng.params, torch.tensor([p + r.tokens[:-1]],
                                                                    device=cuda_dev))
            np.testing.assert_array_equal(r.logits, ref[0, len(p) - 1:].cpu().numpy())
    finally:
        eng.shutdown()


# -- the elastic runtime on the card ---------------------------------------------------------


def _card_mlp(dev, seed=3):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr=0.01))
            .layer(Dense(n_out=32, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    net = MultiLayerNetwork(conf, device=dev)
    net.init()
    return net


def _card_batches(dev, k=4, seed=5):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(seed)
    return [DataSet(torch.from_numpy(rng.standard_normal((64, 16), dtype=np.float32)).to(dev),
                    torch.from_numpy(np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]).to(dev))
            for _ in range(k)]


def test_elastic_snapshot_of_card_tensors_is_a_host_copy(cuda_dev, tmp_path):
    """The snapshot's tensors live in host memory and keep their dtype
    (a bf16 leaf bit for bit); the async write lands the values of the
    step it was taken at, not of the steps after it."""
    from deeplearning4j_tpu_torch.parallel import CheckpointManager
    from deeplearning4j_tpu_torch.parallel.elastic import _HostSnapshot
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    net = _card_mlp(cuda_dev)
    bs = _card_batches(cuda_dev)
    net.fit_batch(bs[0])
    net.params[0]["b"] = net.params[0]["b"].to(torch.bfloat16)
    snap = _HostSnapshot(net)
    leaves = [t for layer in snap.params for t in layer.values()]
    assert all(t.device.type == "cpu" for t in leaves)
    assert snap.params[0]["b"].dtype == torch.bfloat16
    assert torch.equal(snap.params[0]["b"], net.params[0]["b"].cpu())
    net.params[0]["b"] = net.params[0]["b"].float()
    want = [{k: v.cpu().clone() for k, v in layer.items()} for layer in net.params]

    class Src:
        def __init__(self, n):
            self.net = n
    fut = CheckpointManager(str(tmp_path)).save_async(Src(net), 1)
    for b in bs:
        net.fit_batch(b)
    back = load_model(fut.result(), device="cpu")
    for a, w in zip(back.params, want):
        for k in w:
            assert torch.equal(a[k], w[k])


def test_restore_then_fit_batches_graph_replays_on_the_restored_weights(cuda_dev, tmp_path):
    """A ``fit_batches`` CUDA graph captured before a restore replays on
    the restored weights: its losses after the restore are bitwise those
    of a fresh network that loads the checkpoint and runs eagerly."""
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    bs = _card_batches(cuda_dev)
    net = _card_mlp(cuda_dev)

    class Plain:
        def __init__(self, n):
            self.net = n

        def fit_batch(self, ds):
            return self.net.fit_batch(ds)
    et = ElasticTrainer(Plain(net), str(tmp_path), checkpoint_every=2)
    net.fit_batches(bs[:2])                        # captures the graph
    assert net.fit_graph_count == 1
    et.global_step = 2
    path = et.ckpt.save(Plain(net), 2)
    net.fit_batches(bs[2:])                        # replays: moves on
    et._restore()                                  # rebinds net.params
    got = [float(l) for l in net.fit_batches(bs[2:])]
    assert net.fit_graph_count == 1
    fresh = load_model(path, device=cuda_dev)
    want = [float(fresh.fit_batch(b)) for b in bs[2:]]
    assert got == want
    for a, b in zip(net.params, fresh.params):
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("m,k,n", [(1, 4, 3), (5, 12, 10), (64, 768, 50304)])
def test_int8_product_on_the_card_is_the_cpus(cuda_dev, m, k, n):
    from deeplearning4j_tpu_torch.ops.quantize import quantize_weight
    gen = torch.Generator().manual_seed(m + k + n)
    w, x = torch.randn(k, n, generator=gen), 2 * torch.randn(m, k, generator=gen)
    qc = quantize_weight(w, 3.0)
    qd = quantize_weight(w.to(cuda_dev), 3.0)
    assert torch.equal(qd.padded.cpu(), qc.padded)
    assert torch.equal(qd.scales.cpu(), qc.scales)
    xd = x.to(cuda_dev)
    assert torch.equal(qd.int_mm(qd.quantize_input(xd)).cpu(), qc.int_mm(qc.quantize_input(x)))
    y = (xd @ qd).cpu()
    assert torch.equal(y, x @ qc)
    stream, xs = torch.cuda.Stream(), xd.clone()
    with torch.cuda.stream(stream):
        for _ in range(2):
            xs @ qd
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        yg = xs @ qd
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg.cpu(), y)


def test_int8_engine_and_an_autoscaled_replica_serve_captured_graphs(cuda_dev):
    import time

    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import Engine

    net = TransformerLM(**SIZE, seed=3, device=cuda_dev)
    rng = np.random.default_rng(0)
    x = rng.integers(0, SIZE["vocab_size"], (4, SIZE["max_len"])).astype(np.float32)
    eng = Engine(net, max_batch=4, replicas=1, slo_ms=60_000, device=cuda_dev).load(
        input_shape=(SIZE["max_len"],), quantize="int8", calibration_inputs=x)
    try:
        qm = eng._current.model
        for rows in (1, 3):
            got = eng.output(x[:rows])
            pad = np.concatenate([x[:rows], np.zeros((4 - rows, SIZE["max_len"]), np.float32)])
            want = qm.output(pad)[:rows].cpu().numpy()
            assert np.array_equal(got, want)
        eng.enable_autoscale(min_replicas=1, max_replicas=2, up_load=2.0, down_load=0.5,
                             up_ticks=1, down_ticks=1000, cooldown_s=0.0, interval_s=0.01)
        futs = [eng.output_async(x[:1 + i % 3]) for i in range(64)]
        for f in futs:
            f.result(timeout=120)
        deadline = time.monotonic() + 30
        while len(eng._replicas) < 2 and time.monotonic() < deadline:
            eng.output(x[:2])
        assert len(eng._replicas) == 2 and eng.compile_cache_size() == 6
        assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
        assert all(g is not None for g in eng._current.programs.values())
    finally:
        eng.shutdown()


def _decode_trio(cuda_dev, **kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    adapter = TransformerDecodeAdapter(_small_lm(cuda_dev))
    return [DecodeEngine(adapter, max_slots=3, page_size=8, role=role, device=cuda_dev,
                         **kw).load() for role in ("unified", "prefill", "decode")]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disaggregated_handoff_on_card_is_bitwise_unified(cuda_dev, kv_dtype):
    uni, pre, dec = _decode_trio(cuda_dev, kv_dtype=kv_dtype)
    rng = np.random.default_rng(5)
    try:
        for n, kw in ((5, dict()), (17, dict(temperature=0.8, top_k=10, seed=4)),
                      (40, dict(temperature=1.0, top_p=0.9, seed=9))):
            prompt = rng.integers(0, SIZE["vocab_size"], n).tolist()
            ref = uni.generate(prompt, max_new_tokens=12, echo_logits=True, **kw)
            h = pre.generate(prompt, max_new_tokens=12, echo_logits=True, **kw)
            got = dec.continue_async(h).result(timeout=120)
            assert got.tokens == ref.tokens
            np.testing.assert_array_equal(got.logits, ref.logits)
        for e in (uni, pre, dec):
            assert e.metrics_snapshot()["pages_in_use"] == 0
    finally:
        for e in (uni, pre, dec):
            e.shutdown()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_page_round_trip_through_the_wire_is_bitwise(cuda_dev, kv_dtype):
    src, _ = tkv.alloc_cache(2, 9, 8, 4, 16, device=cuda_dev, kv_dtype=kv_dtype)
    dst, _ = tkv.alloc_cache(2, 9, 8, 4, 16, device=cuda_dev, kv_dtype=kv_dtype)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    for leaf in (src if isinstance(src, tuple) else (src,)):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=cuda_dev))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda_dev))
    ids = torch.tensor([4, 2, 7], device=cuda_dev)

    def host(p):
        return (tkv.QuantPages(p.q.cpu().numpy(), p.scale.cpu().numpy())
                if isinstance(p, tkv.QuantPages) else p.cpu().numpy())

    payload = host(tkv.gather_pages(src, ids))
    t = tkv.unpack_transfer(tkv.pack_transfer(tkv.PageTransfer(3, payload, payload)))
    back = (tkv.QuantPages(*(torch.from_numpy(a.copy()).to(cuda_dev) for a in t.k))
            if kv_dtype else torch.from_numpy(t.k.copy()).to(cuda_dev))
    to = torch.tensor([1, 8, 3], device=cuda_dev)
    tkv.set_pages(dst, to, back)
    for a, b in zip(src if kv_dtype else (src,), dst if kv_dtype else (dst,)):
        assert torch.equal(a[:, ids], b[:, to])


def test_swap_replays_the_captured_horizon_on_the_new_weights(cuda_dev):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    a = TransformerDecodeAdapter(_small_lm(cuda_dev))
    b = TransformerDecodeAdapter(_seeded_lm(cuda_dev, 8))
    eng = DecodeEngine(a, max_slots=3, page_size=8, decode_horizon=4, device=cuda_dev).load()
    fresh = DecodeEngine(b, max_slots=3, page_size=8, decode_horizon=4,
                         device=cuda_dev).load()
    prompt = list(range(3, 20))
    try:
        n = eng.compile_cache_size()
        before = eng.generate(prompt, max_new_tokens=12, echo_logits=True)
        eng.swap_model(b, "v1")
        after = eng.generate(prompt, max_new_tokens=12, echo_logits=True)
        want = fresh.generate(prompt, max_new_tokens=12, echo_logits=True)
        assert after.model_tag == "v1" and after.tokens == want.tokens
        np.testing.assert_array_equal(after.logits, want.logits)
        assert not np.array_equal(after.logits, before.logits)
        eng.swap_model(a, "v0")
        again = eng.generate(prompt, max_new_tokens=12, echo_logits=True)
        np.testing.assert_array_equal(again.logits, before.logits)
        assert eng.compile_cache_size() == n and eng.step_multi_graph.replays > 0
    finally:
        eng.shutdown()
        fresh.shutdown()


def test_params_setter_and_same_tag_swap_reach_the_captured_horizon(cuda_dev, tmp_path):
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    a = TransformerDecodeAdapter(_small_lm(cuda_dev))
    b = TransformerDecodeAdapter(_seeded_lm(cuda_dev, 8))
    c = TransformerDecodeAdapter(_seeded_lm(cuda_dev, 9))
    kw = dict(max_slots=3, page_size=8, decode_horizon=4, device=cuda_dev)
    eng = DecodeEngine(a, **kw).load()
    fresh = {n: DecodeEngine(m, **kw).load() for n, m in (("b", b), ("c", c))}
    prompt = list(range(3, 20))
    gen = lambda e: e.generate(prompt, max_new_tokens=12, echo_logits=True)
    try:
        assert eng.compile_cache_size() == 1
        bundle = eng.save_warmup_bundle(str(tmp_path / "fused.warm"))
        before = gen(eng)
        with eng._lock:
            eng.params = b.params
        after = gen(eng)
        want = gen(fresh["b"])
        assert after.model_tag == before.model_tag and after.tokens == want.tokens
        np.testing.assert_array_equal(after.logits, want.logits)
        eng.swap_model(c, after.model_tag)
        again = gen(eng)
        np.testing.assert_array_equal(again.logits, gen(fresh["c"]).logits)
        assert eng.compile_cache_size() == 1 and eng.step_multi_graph.replays > 0
    finally:
        eng.shutdown()
        for e in fresh.values():
            e.shutdown()
    warm = DecodeEngine(a, **kw).load(warm_bundle=bundle)
    try:
        assert warm.metrics.counter_value("bundle_hits") == 1
        assert warm.metrics.counter_value("bundle_misses") == 0
        np.testing.assert_array_equal(gen(warm).logits, before.logits)
    finally:
        warm.shutdown()


def _seeded_lm(device, seed):
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(**SIZE, seed=seed, device=device)


# -- the input pipeline: datasets/device_prefetch.py on the card ------------------


def _pixel_batches(n, rows, hw, seed):
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    return [DataSet(rng.integers(0, 256, (rows, hw, hw, 3), dtype=np.uint8),
                    np.eye(4, dtype=np.float32)[rng.integers(0, 4, rows)])
            for _ in range(n)]


def test_prefetch_ring_orders_each_batch_before_its_first_read(cuda_dev):
    """A batch read on the consumer's stream right after ``next()`` equals
    its host source, while the compute stream is busy and the producer
    copies the next batches on its own stream."""
    from deeplearning4j_tpu_torch.datasets import DevicePrefetchIterator, ListDataSetIterator

    host = _pixel_batches(12, 64, 64, 0)
    it = DevicePrefetchIterator(ListDataSetIterator(host), depth=2, device=cuda_dev)
    for d in host:
        torch.cuda._sleep(2_000_000)        # keep the compute stream busy
        got = it.next()
        assert got.features.device.type == "cuda" and got.features.dtype == torch.uint8
        np.testing.assert_array_equal(got.features.cpu().numpy(), d.features)
        np.testing.assert_array_equal(got.labels.cpu().numpy(), d.labels)
    assert not it.has_next()
    it.close()


def test_prefetch_ring_memory_is_not_reused_under_a_slow_consumer(cuda_dev):
    """Each handed-over batch is ``record_stream``-ed on the consumer's
    stream: a slow consumer's queued reads of a batch it already dropped
    its reference to still see that batch, while the producer runs ahead
    allocating and copying the next ones."""
    from deeplearning4j_tpu_torch.datasets import (DevicePrefetchIterator,
                                                    ImagePreProcessingScaler,
                                                    ListDataSetIterator)

    host = _pixel_batches(16, 32, 64, 1)
    scaler = ImagePreProcessingScaler()
    it = DevicePrefetchIterator(ListDataSetIterator(host), depth=3, device=cuda_dev,
                                transform=scaler)
    sums = []
    for _ in host:
        torch.cuda._sleep(5_000_000)        # the consumer's stream lags the producer's
        x = it.next().features
        sums.append(x.double().sum())       # queued behind the sleep
        del x                               # the batch's memory returns to the allocator
    want = [float(scaler.transform(d.features).astype(np.float64).sum()) for d in host]
    got = [float(s) for s in sums]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    it.close()


def test_fit_batches_captures_with_a_live_producer(cuda_dev):
    """A ``fit_batches(2)`` graph captured while a prefetch producer is
    alive (paused across the capture) neither breaks nor hangs; its losses
    are bitwise two ``fit_batch`` calls on the same batches from the same
    start, and the producer goes on to deliver every batch."""
    import threading

    from deeplearning4j_tpu_torch.datasets import (DataSet, DevicePrefetchIterator,
                                                    ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    rng = np.random.default_rng(3)
    host = [DataSet(rng.standard_normal((32, 32, 32, 3), dtype=np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]) for _ in range(8)]
    torch.backends.cudnn.deterministic = True
    try:
        net = LeNet(32, 32, 3, 10, updater=Sgd(lr=0.01), device=cuda_dev)
        ref = LeNet(32, 32, 3, 10, updater=Sgd(lr=0.01), device=cuda_dev)
        ref.params = net.clone_params()
        it = DevicePrefetchIterator(ListDataSetIterator(host), depth=2, device=cuda_dev)
        out = {}

        def capture():
            out["losses"] = [float(v) for v in net.fit_batches([it.next(), it.next()])]
        th = threading.Thread(target=capture, daemon=True)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive(), "fit_batches capture hung beside a live producer"
        assert net.fit_graph_count == 1
        want = [float(ref.fit_batch(DataSet(torch.as_tensor(d.features).to(cuda_dev),
                                             torch.as_tensor(d.labels).to(cuda_dev))))
                for d in host[:2]]
        assert out["losses"] == want
        rest = []
        while it.has_next():
            rest.append(it.next())
        assert len(rest) == 6
        for d, r in zip(host[2:], rest):
            np.testing.assert_array_equal(r.features.cpu().numpy(), d.features)
        it.close()
    finally:
        torch.backends.cudnn.deterministic = False


def test_canary_latency_verdict_reads_the_replays_device_time(cuda_dev, monkeypatch):
    """A pause of the host inside the candidate's forward (20 ms, after its
    replay) does not veto it: the canary's p99 compares the replays' device
    times, where a wall clock would read 3x the incumbent's and roll back."""
    import threading
    import time

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.serving import Engine
    from deeplearning4j_tpu_torch.serving import cuda_graphs as cg

    eng = Engine(LeNet(32, 32, 3, 10, device=cuda_dev), max_batch=4, replicas=1,
                 device=cuda_dev).load()
    candidate = LeNet(32, 32, 3, 10, seed=7, device=cuda_dev)
    real_init, real_call, created = cg.ForwardGraph.__init__, cg.ForwardGraph.__call__, []

    def init(g, *a, **kw):
        real_init(g, *a, **kw)
        created.append(g)

    def call(g, *a, **kw):
        out = real_call(g, *a, **kw)
        if any(g is c for c in created):
            time.sleep(0.02)
        return out
    monkeypatch.setattr(cg.ForwardGraph, "__init__", init)
    monkeypatch.setattr(cg.ForwardGraph, "__call__", call)
    stop = threading.Event()
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3), dtype=np.float32)

    def traffic():
        while not stop.is_set():
            eng.output(x)
    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        decision = eng.run_canary(candidate, "v2", frac=1.0, window=4, timeout_s=60)
    finally:
        stop.set()
        th.join(timeout=30)
        eng.shutdown()
    assert created and decision["mirrored_batches"] == 4
    assert decision["promote"], decision
    assert decision["canary_p99_ms"] < 10.0


# -- the learning libraries (nlp/, clustering/, plot/) ---------------------------


def _zipf_sentences(n, vocab, length, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    return [" ".join(f"w{i}" for i in rng.choice(vocab, size=length, p=p / p.sum()))
            for _ in range(n)]


def test_negatives_on_the_card_are_the_cpus_bitwise(cuda_dev):
    """The threefry sampler's draws on the card are the CPU's (which the
    CPU tests hold bitwise to ``jax.random``), at several seeds, counters
    and vocabulary sizes."""
    from deeplearning4j_tpu_torch.nlp.sequencevectors import _build_alias_table, _device_negs

    counters = torch.tensor([0, 1, 15, 16, 4095, 2**31 + 3])
    for vocab in (16, 2000, 100_000):
        p = 1.0 / np.arange(1, vocab + 1) ** 1.1
        prob, alias = _build_alias_table(p ** 0.75 / np.sum(p ** 0.75))
        cpu_t = (torch.from_numpy(prob.astype(np.float32)), torch.from_numpy(alias))
        dev_t = tuple(t.to(cuda_dev) for t in cpu_t)
        for seed in (0, 3_482_212_781, 2**32 - 1):
            key = ts.prng_key(torch.tensor(seed))
            want = _device_negs(key, counters, cpu_t, 5, 4096)
            got = _device_negs(tuple(w.to(cuda_dev) for w in key), counters.to(cuda_dev),
                               dev_t, 5, 4096)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", [128, 300, 1])
def test_ordered_scatter_on_the_card(cuda_dev, width):
    """``add_rows`` on the card (``index_put_(accumulate=True)``, CUDA's
    sort-based path) sums repeated rows deterministically: a second call is
    bitwise the first; rows of width 128 and 300 are bitwise the CPU's
    serial ``index_add_`` (each row's duplicates added in index order).  A
    1-D table (GloVe's biases and AdaGrad sums) takes CUDA's stride-1
    kernel, which adds an entry's duplicates in another fixed order: it is
    held to the float64 sum within 16 x 2^-24 x sqrt(sum of s_k^2), s_k the
    entry's partial sums in index order (the spread of f32 rounding over
    the entry's additions), and every term is at least 0.5 in magnitude,
    above every entry's bound, so a dropped or doubled term fails."""
    from deeplearning4j_tpu_torch.ops.scatter import add_rows

    rng = np.random.default_rng(width)
    shape = (1000,) if width == 1 else (1000, width)
    table = rng.standard_normal(shape, dtype=np.float32)
    idx = (rng.zipf(1.3, 50_000) % 1000).astype(np.int64)       # heavy repeats
    rows = (rng.choice([-1.0, 1.0], (50_000,) + shape[1:])
            * rng.uniform(0.5, 1.5, (50_000,) + shape[1:])).astype(np.float32)
    want = add_rows(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                    torch.from_numpy(rows))
    dev = [add_rows(torch.from_numpy(table.copy()).to(cuda_dev), torch.from_numpy(idx).to(cuda_dev),
                    torch.from_numpy(rows).to(cuda_dev)).cpu() for _ in range(2)]
    assert torch.equal(dev[0], dev[1])
    if width == 1:
        order = np.argsort(idx, kind="stable")
        starts = np.searchsorted(idx[order], np.arange(1000))
        terms = np.insert(rows[order].astype(np.float64), starts, table.astype(np.float64))
        owner = np.insert(idx[order], starts, np.arange(1000))
        cum = np.cumsum(terms)
        partial = cum - np.repeat(np.r_[0.0, cum][starts + np.arange(1000)],
                                  np.bincount(owner, minlength=1000))
        exact = np.bincount(owner, weights=terms, minlength=1000)
        bound = 16 * 2.0 ** -24 * np.sqrt(np.bincount(owner, weights=partial ** 2,
                                                      minlength=1000))
        assert bound.max() < 0.5
        err = np.abs(dev[0].numpy() - exact)
        assert (err <= bound).all(), f"worst error/bound {np.max(err / bound)}"
    else:
        assert torch.equal(dev[0], want)


@pytest.mark.parametrize("mode", ["sg", "cbow", "sg_hs", "dbow", "dm"])
def test_word2vec_on_the_card_stacks_bitwise_and_matches_the_cpu(cuda_dev, mode):
    """A fit stacking 16 batches a dispatch is bitwise a one-batch fit, a
    repeat fit and an eager fit (no CUDA graph replays) on the card; the
    card's tables are within rtol 1e-4, atol 1e-5 of the port's on the CPU
    from the same seed.  ParagraphVectors' inferences (the first eager, the
    second captured, the third replayed) are bitwise eager ones."""
    from deeplearning4j_tpu_torch.nlp import ParagraphVectors, Word2Vec

    sents = _zipf_sentences(400, 300, 12, 0)

    def fit(device, k, graphs=True):
        if mode in ("dbow", "dm"):
            m = ParagraphVectors(dm=mode == "dm", layer_size=32, window=3, epochs=2,
                                 batch_size=256, seed=2, device=device)
        else:
            m = Word2Vec(layer_size=32, window=4, min_word_frequency=1, epochs=2,
                         batch_size=256, seed=2, subsampling=0, cbow=mode == "cbow",
                         hierarchic_softmax=mode == "sg_hs", device=device)
        m._device_batches = k
        m._graphs = graphs
        m.fit(sents)
        return m
    model = fit(cuda_dev, 16)
    card = model.syn0, model.syn1
    one, again = fit(cuda_dev, 1), fit(cuda_dev, 16)
    eager, cpu = fit(cuda_dev, 16, graphs=False), fit("cpu", 16)
    if mode in ("dbow", "dm"):
        docs = [s.split() for s in sents[:3]]
        replayed = [model.infer_vector(d, seed=i) for i, d in enumerate(docs)]
        model._graphs = False
        for i, d in enumerate(docs):
            np.testing.assert_array_equal(replayed[i], model.infer_vector(d, seed=i))
    one, again, eager, cpu = ((m.syn0, m.syn1) for m in (one, again, eager, cpu))
    for a, b, c, e, d in zip(card, one, again, eager, cpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, e)
        np.testing.assert_allclose(a, d, rtol=1e-4, atol=1e-5)


def test_glove_on_the_card_repeats_and_matches_the_cpu(cuda_dev):
    from deeplearning4j_tpu_torch.nlp import Glove

    sents = _zipf_sentences(300, 200, 15, 1)
    kw = dict(layer_size=32, window=5, epochs=4, batch_size=512, seed=3)
    a = Glove(device=cuda_dev, **kw).fit(sents)
    b = Glove(device=cuda_dev, **kw).fit(sents)
    c = Glove(device="cpu", **kw).fit(sents)
    np.testing.assert_array_equal(a.syn0, b.syn0)
    np.testing.assert_allclose(a.syn0, c.syn0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.losses, c.losses, rtol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
@pytest.mark.parametrize("col_block", [1 << 17, 7])
def test_knn_tie_order_on_the_card(cuda_dev, metric, col_block, monkeypatch):
    """Integer points with exact duplicates: the card's neighbours and their
    order among ties are the CPU port's (the lower index first, held to
    ``jax.lax.top_k`` by the CPU tests), across column tiles too."""
    from deeplearning4j_tpu_torch.clustering import NearestNeighbors
    from deeplearning4j_tpu_torch.clustering import knn as tknn

    monkeypatch.setattr(tknn, "COLUMN_BLOCK", col_block)
    rng = np.random.default_rng(0)
    base = rng.integers(-2, 3, (12, 4)).astype(np.float32)
    pts = base[rng.integers(0, 12, 90)]
    q = np.concatenate([base[:5], rng.integers(-2, 3, (9, 4)).astype(np.float32)])
    for k in (1, 4, 11, 90):
        d, i = NearestNeighbors(pts, metric=metric, query_block=5, device=cuda_dev).knn(q, k)
        cd, ci = NearestNeighbors(pts, metric=metric, device="cpu").knn(q, k)
        np.testing.assert_array_equal(i, ci)
        np.testing.assert_allclose(d, cd, rtol=1e-6, atol=1e-6)


def test_chunked_tsne_peak_memory_is_block_bounded(cuda_dev):
    """100,000 points through the chunked t-SNE (kNN, bisection,
    symmetrization and 2 gradient iterations): the peak device memory
    above the start stays under 1/10 of one dense [N, N] f32 buffer (4
    GB), and the embedding is finite."""
    from deeplearning4j_tpu_torch.plot import Tsne

    rng = np.random.default_rng(0)
    n = 100_000
    c = rng.normal(0, 4.0, (10, 16))
    x = (c[rng.integers(0, 10, n)] + rng.normal(0, 0.5, (n, 16))).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = Tsne(method="chunked", perplexity=30.0, max_iter=2, block_size=1024,
             device=cuda_dev).fit_transform(x)
    peak = torch.cuda.max_memory_allocated() - base
    assert np.isfinite(y).all() and y.shape == (n, 2)
    assert peak < 4 * n * n / 10, f"peak {peak} bytes"


def _numpy_leaf_stats(a, bins):
    """The reference's per-leaf record, in numpy (float32)."""
    a = np.asarray(a, np.float32).ravel()
    hist, edges = np.histogram(a, bins=bins)
    return {"mean": float(a.mean()), "std": float(a.std()), "min": float(a.min()),
            "max": float(a.max()), "mean_magnitude": float(np.abs(a).mean()),
            "histogram": hist.tolist(), "histogram_edges": [float(edges[0]), float(edges[-1])]}


def _stats_leaves(n=1 << 16):
    rng = np.random.default_rng(11)
    base = rng.standard_normal(n).astype(np.float32)
    edges = np.histogram_bin_edges(base, 20).astype(np.float32)
    return [base, np.zeros(9, np.float32), np.full(5, -2.5, np.float32),
            np.array([1.0, np.nextafter(np.float32(1), np.float32(2))], np.float32),
            np.concatenate([np.repeat(edges, 3), base[:1000]]),
            (base * 1e15).astype(np.float32), (base * 1e-30).astype(np.float32),
            np.linspace(-1, 1, 101, dtype=np.float32), np.array([3.0], np.float32),
            (rng.standard_normal((768, 3072)) * 0.02).astype(np.float32)]


@pytest.mark.parametrize("bins", [20, 3, 64])
def test_stats_histograms_on_the_card_count_as_numpy(cuda_dev, bins):
    """The StatsListener's device statistics (``ui.stats.leaf_stats``) of
    leaves on the card against numpy's on the host: histogram counts and
    edges equal (values placed on every computed edge, constant, one-
    spacing, huge and tiny ranges, a GPT-2 MLP-sized leaf), min and max
    bitwise, std and mean magnitude 1e-6 relative, the mean within 1e-6 of
    the mean magnitude; bf16 leaves read as float32."""
    from deeplearning4j_tpu_torch.ui.stats import leaf_stats

    leaves = _stats_leaves()
    tensors = [torch.from_numpy(a).to(cuda_dev) for a in leaves]
    tensors.append(tensors[0][:5000].to(torch.bfloat16))
    leaves.append(tensors[-1].float().cpu().numpy())
    kept = []
    for t, a in zip(tensors, leaves):
        try:
            kept.append((t, _numpy_leaf_stats(a, bins)))
        except ValueError as e:
            # numpy >= 2.1 refuses bins narrower than a float32 spacing:
            # so does the device route, with numpy's message
            with pytest.raises(ValueError) as got:
                leaf_stats([t], bins)
            assert str(got.value) == str(e)
    assert len(kept) >= len(leaves) - 1
    for i, (got, (_, want)) in enumerate(zip(leaf_stats([t for t, _ in kept], bins), kept)):
        assert got["histogram"] == want["histogram"], i
        assert got["histogram_edges"] == want["histogram_edges"], i
        assert (got["min"], got["max"]) == (want["min"], want["max"]), i
        for k in ("std", "mean_magnitude"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=f"{i} {k}")
        assert abs(got["mean"] - want["mean"]) <= 1e-6 * max(want["mean_magnitude"], 1e-30), i


def test_stats_listener_records_on_the_card_are_the_cpu_records(cuda_dev):
    """The same parameter sequence as card tensors and as CPU tensors: the
    same records (histograms equal, moments 1e-6), and on the card a
    ``memory`` entry with the allocator's bytes."""
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener

    rng = np.random.default_rng(12)
    tree = [{"W": rng.standard_normal((64, 32)).astype(np.float32),
             "b": np.zeros(32, np.float32)}, {"g": np.ones(7, np.float32)}]
    recs = {}
    for dev in ("cpu", cuda_dev):
        storage = InMemoryStatsStorage()
        clock = iter(range(100))
        lst = StatsListener(storage, session_id="s", clock=lambda: float(next(clock)),
                            collect_input_stats=False)
        model = type("M", (), {})()
        model.conf = type("C", (), {"layers": [None, None]})()
        for t in range(4):
            model.params = [{k: torch.from_numpy(v + np.float32(0.01 * t)).to(dev)
                             for k, v in p.items()} for p in tree]
            lst.iteration_done(model, t, 1.0 / (t + 1))
        recs[str(dev)] = storage.get_updates("s")
    for c, g in zip(recs["cpu"], recs["cuda"]):
        assert "memory" not in c and g["memory"]["bytes_in_use"] > 0
        assert g["memory"]["peak_bytes_in_use"] >= g["memory"]["bytes_in_use"]
        for section in ("parameters", "updates"):
            for pid, st in c.get(section, {}).items():
                mine = g[section][pid]
                assert mine["histogram"] == st["histogram"]
                assert (mine["min"], mine["max"]) == (st["min"], st["max"])
                for k in ("mean", "std", "mean_magnitude"):
                    np.testing.assert_allclose(mine[k], st[k], rtol=1e-6, atol=1e-12)


def test_keras_import_on_the_card_is_the_cpu_network(cuda_dev):
    """A ResNet50-shaped functional Keras model at narrow widths, imported
    through the in-memory archive on the card and on the CPU: parameters
    bitwise, ``output()`` within 1e-5."""
    from deeplearning4j_tpu_torch.modelimport import keras as tkeras

    kf = cs.keras_resnet50(5, hw=32, classes=10, stem=8, stages=((4, 2, 1), (8, 1, 2)))
    card, cpu = tkeras._import_archive(kf, device=cuda_dev), tkeras._import_archive(kf, device="cpu")
    for name, p in cpu.params.items():
        for k, v in p.items():
            assert torch.equal(card.params[name][k].cpu(), v), (name, k)
    x = np.random.default_rng(6).standard_normal((4, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(card.output(x)[0].cpu().numpy(), cpu.output(x)[0].numpy(),
                               rtol=1e-5, atol=1e-5)
