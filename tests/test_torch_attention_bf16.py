"""bf16 parity of the port's flash attention with the JAX package's, and
the routing of bf16 and f32 calls to their CUDA kernels.

On the CPU the port's K1, K2 and K3 run their plain PyTorch versions
(``flash_forward_plain``, ``flash_bwd_dkdv_plain``, ``flash_bwd_dq_plain``);
the JAX ``flash_mha`` runs its Pallas kernels in interpret mode, as the
JAX package's own tests run them (every length here tiles by 8).  Inputs
come from a numpy seed, are rounded to bf16 once and go to both packages.

Tolerance (bf16): 2e-2 absolute and 1e-2 relative to the reference's norm
for O and every gradient: both sides take bf16 operands into f32 sums, and
round p, ds and the outputs to bf16 at the same places, but sum in another
order, so a value may land one bf16 step (2^-8 of its size) away.  The
LSE is f32 on both sides: 2e-5.

The CUDA kernels are held against the plain versions on the card in
``test_torch_cuda.py``.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu_torch.ops import attention as tatt

ATOL, NORM_RTOL, LSE_ATOL = 2e-2, 1e-2, 2e-5

# (T, S, D): T = S at a tiling and a ragged-looking length, T != S both
# ways, and a head width that is not a power of two
SHAPES = [(64, 64, 64), (200, 200, 64), (64, 136, 80), (200, 64, 80)]


def _bf16_inputs(t, s, d, seed, b=1, h=2):
    """q, g [b, h, t, d] and k, v [b, h, s, d] as bf16 torch tensors and as
    jax arrays of the same bf16 values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, t, d), (b, h, s, d), (b, h, s, d), (b, h, t, d))]
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
                      for x in (tq, tk, tv, tg))
    return (tq, tk, tv, tg), (jq, jk, jv, jg)


def _kmask(b, s, seed):
    km = (np.random.default_rng(seed).random((b, s)) >= 0.3).astype(np.int32)
    km[:, 0] = 1          # every query row keeps a live key
    return km


def _close(got, want, what):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    diff = got - want
    assert float(np.abs(diff).max()) <= ATOL, f"{what}: max abs {np.abs(diff).max()}"
    assert float(np.linalg.norm(diff)) <= NORM_RTOL * float(np.linalg.norm(want)), (
        f"{what}: norm-relative {np.linalg.norm(diff) / np.linalg.norm(want)}")


def _f32(x):
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


CASES = [(t, s, d, causal, masked) for (t, s, d) in SHAPES
         for causal in (False, True) for masked in (False, True)]
IDS = [f"{t}x{s}x{d}{'_causal' if c else ''}{'_kmask' if m else ''}"
       for t, s, d, c, m in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_forward_bf16_matches_jax_kernel(case):
    t, s, d, causal, masked = case
    (tq, tk, tv, _), (jq, jk, jv, _) = _bf16_inputs(t, s, d, seed=t + s + d)
    km = _kmask(1, s, seed=s) if masked else None
    scale = 1.0 / math.sqrt(d)
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, None if km is None else jnp.asarray(km),
                                     causal, scale)
    assert lse_j is not None, "every length here tiles: the JAX kernel must run"
    o, lse = tatt.flash_forward(tq, tk, tv, None if km is None else torch.from_numpy(km),
                                causal, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(o.float().numpy(), _f32(o_j), "O")
    lse_j = np.asarray(lse_j).reshape(lse.shape)
    assert float(np.abs(lse.numpy() - lse_j).max()) <= LSE_ATOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_backward_bf16_matches_jax_grad(case):
    t, s, d, causal, masked = case
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _bf16_inputs(t, s, d, seed=3 * t + s + d)
    km = _kmask(1, s, seed=s + 1) if masked else None
    jkm = None if km is None else jnp.asarray(km)

    def f(q_, k_, v_):
        o = jatt.flash_mha(q_, k_, v_, causal, kmask=jkm)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    qr, kr, vr = (x.clone().requires_grad_() for x in (tq, tk, tv))
    o = tatt.flash_mha(qr, kr, vr, causal, kmask=None if km is None else torch.from_numpy(km))
    o.backward(tg)
    for name, got, w in zip(("dq", "dk", "dv"), (qr.grad, kr.grad, vr.grad), want):
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), _f32(w), name)


def test_flash_backward_bf16_plain_kernels_match_jax_kernels():
    """K2 and K3's plain versions, called as the card's wrappers are, against
    the JAX package's two backward kernels on the same O and LSE."""
    t, d = 128, 64
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _bf16_inputs(t, t, d, seed=5)
    km = _kmask(1, t, seed=6)
    scale = 1.0 / math.sqrt(d)
    jkm = jnp.asarray(km)
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, jkm, True, scale)
    want = jatt._flash_backward(jq, jk, jv, jkm, o_j, lse_j, jg, True, scale)
    tkm = torch.from_numpy(km)
    o, lse = tatt.flash_forward(tq, tk, tv, tkm, True, scale)
    delta = tatt.flash_delta(o, tg)
    dk, dv = tatt.flash_bwd_dkdv_plain(tq, tk, tv, tg, lse, delta, tkm, True, scale)
    dq = tatt.flash_bwd_dq_plain(tq, tk, tv, tg, lse, delta, tkm, True, scale)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close(got.float().numpy(), _f32(w), name)


# -- routing: which entry a CUDA call reaches, and no fallback ----------------------


class _Stub:
    """``cuda_build.load`` stand-in: records the libraries asked for, the
    entries fetched from them and the entries called, and hands back an
    object whose every entry returns 0 (or raises for a build that
    fails)."""

    def __init__(self, fail=False):
        self.fail, self.asked, self.entries, self.called = fail, [], [], []

    def __call__(self, name):
        self.asked.append(name)
        if self.fail:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu")
        return self

    def __getattr__(self, entry):
        if not entry.startswith("dl4j_"):
            raise AttributeError(entry)
        self.entries.append(entry)

        def fn(*a):
            self.called.append(entry)
            return 0
        return fn


@pytest.fixture
def stub_load(monkeypatch):
    from deeplearning4j_tpu_torch.utils import cuda_build

    caches = (tatt._flash_fn, tatt._flash_tc_fn, tatt._bwd_fns, tatt._bwd_tc_fns)

    def install(fail=False):
        stub = _Stub(fail)
        monkeypatch.setattr(cuda_build, "load", stub)
        for c in caches:
            c.cache_clear()
        return stub

    yield install
    for c in caches:
        c.cache_clear()


def _args(dtype, t=16, d=8):
    g = torch.Generator().manual_seed(0)
    q, k, v, gr = (torch.randn(1, 1, t, d, generator=g).to(dtype) for _ in range(4))
    lse = torch.zeros(1, 1, t)
    return q, k, v, gr, lse, torch.zeros(1, 1, t)


@pytest.mark.parametrize("dtype,fwd_lib,bwd_lib", [
    (torch.bfloat16, "flash_fwd_tc", "flash_bwd_tc"),
    (torch.float32, "flash_fwd", "flash_bwd")], ids=["bf16", "f32"])
def test_a_cuda_call_reaches_the_entry_of_its_dtype(stub_load, dtype, fwd_lib, bwd_lib):
    # CPU tensors stop at the device check, after the entry was fetched:
    # what the stub was asked for is the entry the call would launch
    stub = stub_load()
    q, k, v, g, lse, delta = _args(dtype)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_forward_cuda(q, k, v, None, True, 0.5)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_bwd_dq_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    # one library serves both backward kernels of a dtype
    assert stub.asked == [fwd_lib, bwd_lib]
    tc = "_tc" if dtype == torch.bfloat16 else ""
    assert stub.entries == ["dl4j_flash_fwd" + tc, "dl4j_flash_bwd_dkdv" + tc,
                            "dl4j_flash_bwd_dq" + tc]
    assert stub.called == []


@pytest.mark.parametrize("dtype,lib,entry", [
    (torch.bfloat16, "flash_bwd_tc", "dl4j_flash_bwd_dq_tc"),
    (torch.float32, "flash_bwd", "dl4j_flash_bwd_dq")], ids=["bf16", "f32"])
def test_dq_launches_the_entry_of_its_dtype_and_counts_it(stub_load, monkeypatch, dtype,
                                                           lib, entry):
    # past the device check (a CPU tensor stops there): the launch helper
    # calls the entry it was handed and returns a dq of q's shape
    stub = stub_load()
    monkeypatch.setattr(tatt, "_launch_dq", lambda fn, q, *rest: (fn(), torch.empty_like(q))[1])
    q, k, v, g, lse, delta = _args(dtype)
    counters = (tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dq_tc_cuda)
    before = [c.launches for c in counters]
    dq = tatt.flash_bwd_dq_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    assert dq.shape == q.shape and dq.dtype == dtype
    assert stub.asked == [lib] and stub.called == [entry]
    # flash_bwd_dq counts both dtypes, flash_bwd_dq_tc the bf16 launches
    assert [c.launches - b for c, b in zip(counters, before)] == [1, int(dtype == torch.bfloat16)]
    # both dQ entries take the same C signature: no dtype flag
    fns = tatt._bwd_tc_fns() if dtype == torch.bfloat16 else tatt._bwd_fns()
    assert fns[1].argtypes == ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def test_a_failed_build_raises_and_nothing_falls_back(stub_load):
    stub = stub_load(fail=True)
    q, k, v, g, lse, delta = _args(torch.bfloat16)
    counters = (tatt.flash_forward_cuda, tatt.flash_forward_tc_cuda,
                tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dkdv_tc_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.flash_forward_cuda(q, k, v, None, True, 0.5)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    # neither the SIMT library nor a plain version was reached, nothing counted
    assert stub.asked == ["flash_fwd_tc", "flash_bwd_tc"]
    assert [c.launches for c in counters] == before


def test_a_failed_tc_build_fails_dq_and_nothing_falls_back(stub_load):
    stub = stub_load(fail=True)
    q, k, v, g, lse, delta = _args(torch.bfloat16)
    counters = (tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dq_tc_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.flash_bwd_dq_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    # the SIMT library was not asked for, no entry was called, nothing counted
    assert stub.asked == ["flash_bwd_tc"] and stub.called == []
    assert [c.launches for c in counters] == before


def test_train_graph_replays_count_the_tensor_core_dq():
    from deeplearning4j_tpu_torch.nn.train_graph import TRAIN_COUNTERS

    assert TRAIN_COUNTERS["flash_bwd_dq_tc"] is tatt.flash_bwd_dq_tc_cuda
    assert TRAIN_COUNTERS["flash_bwd_dq"] is tatt.flash_bwd_dq_cuda


def test_the_tensor_core_entries_take_only_bf16(stub_load):
    stub = stub_load()
    q, k, v, g, lse, delta = _args(torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        tatt.flash_forward_tc_cuda(q, k, v, None, True, 0.5)
    with pytest.raises(TypeError, match="bfloat16"):
        tatt.flash_bwd_dkdv_tc_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    with pytest.raises(TypeError, match="bfloat16"):
        tatt.flash_bwd_dq_tc_cuda(q, k, v, g, lse, delta, None, True, 0.5)
    assert stub.asked == []


def test_both_bf16_backward_entries_keep_their_c_signature(stub_load):
    # the wgmma kernels took over the entries of the mma.sync ones, argument
    # for argument: q, k, v, g, lse, delta, kmask, the outputs; B, H, T, S,
    # D; scale, causal, the stream; an int back
    stub_load()
    dkdv, dq = tatt._bwd_tc_fns()
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert dkdv.argtypes == [ctypes.c_void_p] * 9 + tail
    assert dq.argtypes == [ctypes.c_void_p] * 8 + tail
    assert dkdv.restype is ctypes.c_int and dq.restype is ctypes.c_int


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_both_forward_entries_keep_their_c_signature(stub_load, dtype):
    # the wgmma K1 took over the entry of the mma.sync one, argument for
    # argument, and shares its C signature with the SIMT entry: q, k, v,
    # kmask, o, lse; B, H, T, S, D; scale, causal, the stream; an int back
    stub_load()
    fn = tatt._flash_tc_fn() if dtype == torch.bfloat16 else tatt._flash_fn()
    assert fn.argtypes == ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


def test_bf16_on_cpu_takes_the_plain_versions():
    (tq, tk, tv, tg), _ = _bf16_inputs(16, 16, 8, seed=9)
    counters = (tatt.flash_forward_cuda, tatt.flash_forward_tc_cuda,
                tatt.flash_bwd_dkdv_cuda, tatt.flash_bwd_dkdv_tc_cuda,
                tatt.flash_bwd_dq_cuda, tatt.flash_bwd_dq_tc_cuda)
    before = [c.launches for c in counters]
    o, lse = tatt.flash_forward(tq, tk, tv, None, True)
    ref = tatt.flash_forward_plain(tq, tk, tv, None, True, 1.0 / math.sqrt(8))
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])
    tatt.flash_backward(tq, tk, tv, None, o, lse, tg, True, 1.0 / math.sqrt(8))
    assert [c.launches for c in counters] == before
