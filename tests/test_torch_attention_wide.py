"""The port's attention and LSTM kernels' plain versions at the head widths
and dtypes the reference takes beyond float32 / bfloat16 at head_dim <= 128:
float16 through flash attention and the LSTM sequence, and head widths
129-256 through flash attention and the decode attention D1.

On the CPU the port runs each kernel's plain PyTorch version; the JAX
package runs its Pallas kernels in interpret mode (or its plain XLA
``det_attention``), as its own tests run them.  Inputs come from numpy
seeds and go to both packages.  Tolerances:

  * flash attention in float32: 2e-5 absolute on O, LSE and dQ/dK/dV
    (sums in another order);
  * flash attention in float16: 5e-3 absolute and 2e-3 relative in norm
    (p and ds are rounded to float16 before their products in both
    packages, but each rounds sums of another order);
  * D1 at d 256: 1e-6 (both sum in the same order, in float32);
  * the float16 LSTM sequence: 4e-3 absolute (float16's spacing is 2^-11
    on [0.5, 1), and each step's h and c are rounded to it);
  * the 2-layer TransformerLM at d_model 512, 2 heads of 256: its
    ``fit_batch`` loss and its clipped gradients 1e-4 absolute of the
    reference's in float32; its decode logits bitwise its re-encode's.

The card's kernels are held against these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.layers import recurrent as jr
from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu.ops import kv_cache as jkv
from deeplearning4j_tpu.ops import lstm_kernel as jk
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter, TransformerLM
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.nn.layers import recurrent as tr
from deeplearning4j_tpu_torch.ops import attention as tatt
from deeplearning4j_tpu_torch.ops import kv_cache as tkv
from deeplearning4j_tpu_torch.ops import lstm_kernel as tk
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy

F32_TOL = 2e-5
F16_ABS, F16_REL = 5e-3, 2e-3
B, H, T = 2, 2, 128


def _inputs(D, dtype, seed):
    """q, k, v, the cotangent g [B, H, T, D] and a key mask [B, T] whose
    first 3 keys are masked (with causal attention rows 0-2 see no live
    key: dead rows), as numpy in ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, D), dtype=np.float32).astype(dtype)
                  for _ in range(4))
    km = (rng.random((B, T)) >= 0.25).astype(np.int32)
    km[:, :3] = 0
    km[:, 3] = 1
    return q, k, v, g, km


def _reference(q, k, v, g, km, causal):
    """The reference's flash_mha (interpret mode) forward, its LSE from
    ``_flash_forward`` and its VJP for the cotangent g, as float32 numpy."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    kmask = None if km is None else jnp.asarray(km)
    o, vjp = jax.vjp(lambda a, b, c: jatt.flash_mha(a, b, c, causal, kmask=kmask), *args)
    dq, dk, dv = vjp(jnp.asarray(g))
    _, lse = jatt._flash_forward(*args, kmask, causal, 1.0 / math.sqrt(q.shape[-1]))
    assert lse is not None, "T = 128 tiles: the reference's kernel must run"
    return [np.asarray(a, dtype=np.float32) for a in (o, dq, dk, dv)] + [
        np.asarray(lse, dtype=np.float32).reshape(q.shape[:3])]


def _port(q, k, v, g, km, causal):
    """The port's flash_mha forward and autograd backward on the CPU (the
    plain versions), its LSE from flash_forward, as float32 numpy."""
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kmask = None if km is None else torch.from_numpy(km)
    o = tatt.flash_mha(tq, tk_, tv, causal, kmask=kmask)
    o.backward(torch.from_numpy(g))
    _, lse = tatt.flash_forward(tq.detach(), tk_.detach(), tv.detach(), kmask, causal)
    return [a.detach().float().numpy() for a in (o, tq.grad, tk_.grad, tv.grad, lse)]


@pytest.mark.parametrize("mode", ["causal", "causal_kmask_dead_rows"])
@pytest.mark.parametrize("D", [64, 160, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_flash_mha_and_its_gradients_match_the_reference(dtype, D, mode):
    q, k, v, g, km = _inputs(D, dtype, seed=D + 7 * len(mode))
    km = km if "kmask" in mode else None
    want = _reference(q, k, v, g, km, True)
    got = _port(q, k, v, g, km, True)
    lse_live = want[4] < 1e29            # dead rows carry the sentinel in both
    np.testing.assert_array_equal(got[4] < 1e29, lse_live)
    for name, a, b in zip(("o", "dq", "dk", "dv", "lse"), got, want):
        if name == "lse":
            a, b = a[lse_live], b[lse_live]
        if dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0, err_msg=name)
        else:
            assert np.abs(a - b).max() <= F16_ABS, name
            assert np.linalg.norm(a - b) <= F16_REL * np.linalg.norm(b), name
    if km is not None:                   # dead rows get exactly zero dQ
        assert not np.any(got[1][:, :, :3])


def test_wide_heads_and_float16_pass_the_checks_and_wider_heads_do_not(monkeypatch):
    q, k, v, g, _ = (torch.from_numpy(a) for a in _inputs(256, np.float16, seed=3))
    o, lse = tatt.flash_forward(q, k, v, None, True)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    assert [tatt.head_width_bucket(d) for d in (1, 64, 65, 128, 129, 256)] == \
        [64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head_dim <= 256"):
        tatt.head_width_bucket(257)
    # the kernels' wrappers refuse a head past 256 before the device check
    # (nothing falls back to the plain version); 256 passes to that check
    wide, lse0 = torch.zeros(1, 1, 8, 264), torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        tatt.flash_forward_cuda(wide, wide, wide, None, True, 0.1)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        tatt.flash_bwd_dkdv_cuda(wide, wide, wide, wide, lse0, lse0, None, True, 0.1)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        tatt.flash_bwd_dq_cuda(wide, wide, wide, wide, lse0, lse0, None, True, 0.1)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        tkv.det_attention_cuda(wide, wide, wide, torch.zeros(1, 1, 8, 8))
    # float16 at 256 asks for the tensor-core library's f16 entries (CPU
    # tensors then stop at the device check)
    asked = []
    monkeypatch.setattr(tatt, "_flash_tc_fn", lambda f16=False: asked.append(("fwd", f16)))
    monkeypatch.setattr(tatt, "_bwd_tc_fns",
                        lambda f16=False: asked.append(("bwd", f16)) or (None, None))
    ok = torch.zeros(1, 1, 8, 256, dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_forward_cuda(ok, ok, ok, None, True, 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_bwd_dkdv_cuda(ok, ok, ok, ok, lse0, lse0, None, True, 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_bwd_dq_cuda(ok, ok, ok, ok, lse0, lse0, None, True, 0.1)
    assert asked == [("fwd", True), ("bwd", True), ("bwd", True)]
    with pytest.raises(TypeError):
        tatt.flash_forward_cuda(ok.double(), ok.double(), ok.double(), None, True, 0.1)


def test_det_attention_plain_at_d256_matches_the_reference():
    rng = np.random.default_rng(11)
    Bd, Hd, Tq, L, d = 2, 2, 20, 48, 256
    q = rng.standard_normal((Bd, Hd, Tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((Bd, Hd, L, d)).astype(np.float32) for _ in range(2))
    vis = np.arange(L)[None, :] <= (np.arange(Tq) + 9)[:, None]
    bias = np.where(vis, 0.0, tkv.NEG_INF).astype(np.float32)[None, None]
    want = np.asarray(jkv.det_attention(*(jnp.asarray(a) for a in (q, k, v, bias))))
    got = tkv.det_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_float16_lstm_sequence_matches_the_reference_kernel(monkeypatch):
    # the reference's K5 in interpret mode on every step of its scan (mb 8,
    # n 128 meet its tiling gates), in float16; the port's plain loop and
    # the card's route (LSTMSequence, whose wrappers run the plain versions
    # on the CPU) in float16
    monkeypatch.setattr(jk, "ENABLED", True)
    mb, t_len, n_in, n = 8, 5, 6, 128
    rng = np.random.default_rng(21)
    W = (rng.standard_normal((n_in, 4 * n)) / np.sqrt(n_in)).astype(np.float16)
    RW = (rng.standard_normal((n, 4 * n)) / np.sqrt(n)).astype(np.float16)
    b = (0.1 * rng.standard_normal(4 * n)).astype(np.float16)
    h0, c0 = ((0.5 * rng.standard_normal((mb, n))).astype(np.float16) for _ in range(2))
    x = rng.standard_normal((mb, t_len, n_in)).astype(np.float16)
    params = {"W": W, "RW": RW, "b": b}
    jhs, (jh, jc) = jr._scan_lstm(jr.LSTM(n_in=n_in, n_out=n),
                                  {key: jnp.asarray(a) for key, a in params.items()},
                                  jnp.asarray(x), None, jnp.asarray(h0), jnp.asarray(c0))
    assert jhs.dtype == jnp.float16
    tp = {key: torch.from_numpy(a) for key, a in params.items()}
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    zx = torch.from_numpy(x) @ tp["W"]
    plain = tk.lstm_sequence_plain(zx, tp["RW"], tp["b"], th0, tc0)
    hs, h, c = tk.LSTMSequence.apply(zx, tp["RW"], tp["b"], th0, tc0, None, False)
    layer = tr._scan_lstm(tr.LSTM(n_in=n_in, n_out=n), tp, torch.from_numpy(x), None, th0, tc0)
    for phs, (ph, pc) in (plain, (hs, (h, c)), layer):
        assert phs.dtype == torch.float16
        for a, want in ((phs, jhs), (ph, jh), (pc, jc)):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(want, np.float32),
                                       atol=4e-3, rtol=0)
    # the cell backward in float16 against the reference's closed form
    z = rng.standard_normal((mb, 4 * n)).astype(np.float16)
    cc, dh, dcn = (rng.standard_normal((mb, n)).astype(np.float16) for _ in range(3))
    jdz, jdc = jk._bwd_math(*(jnp.asarray(a) for a in (z, cc, dh, dcn)))
    tdz, tdc = tk.lstm_cell_bwd(*(torch.from_numpy(a) for a in (z, cc, dh, dcn)))
    assert tdz.dtype == torch.float16
    np.testing.assert_allclose(tdz.float().numpy(), np.asarray(jdz, np.float32), atol=4e-3, rtol=0)
    np.testing.assert_allclose(tdc.float().numpy(), np.asarray(jdc, np.float32), atol=4e-3, rtol=0)


# -- a TransformerLM with 256-wide heads ------------------------------------------------

WIDE = dict(vocab_size=96, n_layers=2, d_model=512, n_heads=2, max_len=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """numpy leaves of a port tree in the JAX flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [params_to_numpy(tree)]


@pytest.fixture(scope="module")
def wide_pair():
    """The reference's LM and the port's at d_model 512 with 2 heads of
    256, from the same weights, SGD(lr=1) so a step's change of a
    parameter is its clipped gradient."""
    jn = JLM(**WIDE, seed=9, updater=jupd.Sgd(lr=1.0))
    net = TransformerLM(**WIDE, updater=tupd.Sgd(lr=1.0), device="cpu")
    net.params = params_from_numpy(_np_tree(jn.params), device="cpu")
    net.opt_state = params_from_numpy(_np_tree(jn.opt_state), device="cpu")
    return jn, net


def test_wide_head_lm_fit_batch_and_clipped_gradients_match_the_reference(wide_pair):
    jn, net = wide_pair
    assert net.conf.layers[2].d_model // net.conf.layers[2].n_heads == 256
    rng = np.random.default_rng(31)
    x = rng.integers(0, WIDE["vocab_size"], (2, WIDE["max_len"] + 1)).astype(np.int32)
    before_j = jax.tree_util.tree_leaves(_np_tree(jn.params))
    before_t = _leaves(net.params)
    lj = float(jn.fit_batch(JDataSet(x[:, :-1], x[:, 1:])))
    lt = float(net.fit_batch(DataSet(x[:, :-1], x[:, 1:])))
    assert abs(lt - lj) <= 1e-4
    after_j = jax.tree_util.tree_leaves(_np_tree(jn.params))
    after_t = _leaves(net.params)
    assert len(after_t) == len(after_j)
    for bj, aj, bt, at in zip(before_j, after_j, before_t, after_t):
        np.testing.assert_allclose(bt - at, bj - aj, atol=1e-4, rtol=0)


def test_wide_head_lm_decode_logits_are_bitwise_the_reencode(wide_pair):
    _, net = wide_pair
    eng = DecodeEngine(TransformerDecodeAdapter(net), max_slots=2, page_size=16,
                       device="cpu").load()
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, WIDE["vocab_size"], n).tolist() for n in (5, 37)]
    try:
        futs = [eng.generate_async(p, max_new_tokens=6, echo_logits=True, temperature=0.0)
                for p in prompts]
        results = [f.result(timeout=300) for f in futs]
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()
    assert snap["pages_in_use"] == 0
    for p, r in zip(prompts, results):
        seq = torch.tensor([p + r.tokens[:-1]])
        with torch.inference_mode():
            ref = eng.program.reencode(eng.params, seq)[0, len(p) - 1:].numpy()
        np.testing.assert_array_equal(r.logits, ref)
        assert ref.argmax(-1).tolist() == r.tokens
