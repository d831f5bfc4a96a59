"""Parity of the port's attention (``deeplearning4j_tpu_torch.ops.attention``)
with the JAX package's.

On the CPU the port's ``flash_forward`` runs its plain PyTorch version;
the JAX ``flash_mha`` runs its Pallas kernel in interpret mode (lengths
that tile) or ``mha`` (lengths that do not), as the JAX package's own
tests run it.  Inputs come from a numpy seed and go to both packages.
f32 tolerance: atol = rtol = 1e-5 (sums in another order).  The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu_torch.ops import attention as tatt

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(b, h, t, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d), dtype=np.float32)
    k = rng.standard_normal((b, h, s, d), dtype=np.float32)
    v = rng.standard_normal((b, h, s, d), dtype=np.float32)
    return q, k, v


def _kmask(b, s, seed, frac=0.3):
    km = (np.random.default_rng(seed).random((b, s)) >= frac).astype(np.int32)
    km[:, 0] = 1          # every query row keeps a live key
    return km


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t", [32, 20], ids=["tiles", "mha_route"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_mha_matches_jax(causal, masked, t):
    q, k, v = _qkv(2, 3, t, t, 16, seed=t + 2 * causal + masked)
    km = _kmask(2, t, seed=5) if masked else None
    want = np.asarray(jatt.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal,
                                     kmask=None if km is None else jnp.asarray(km)))
    got = tatt.flash_mha(*_t(q, k, v), causal,
                         kmask=None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_lse_matches_jax_kernel(causal, masked):
    b, h, t, d = 2, 2, 64, 16
    q, k, v = _qkv(b, h, t, t, d, seed=11)
    km = _kmask(b, t, seed=12) if masked else None
    scale = 1.0 / math.sqrt(d)
    o_j, lse_j = jatt._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if km is None else jnp.asarray(km), causal, scale)
    assert lse_j is not None, "T=64 tiles: the JAX kernel must run"
    o, lse = tatt.flash_forward(*_t(q, k, v),
                                None if km is None else torch.from_numpy(km),
                                causal, scale)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_j).reshape(b, h, t), **TOL)


def test_flash_cross_lengths_match_jax():
    q, k, v = _qkv(1, 2, 64, 32, 16, seed=21)
    want = np.asarray(jatt.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), False))
    got = tatt.flash_mha(*_t(q, k, v), False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fully_masked_rows_take_the_lse_sentinel():
    b, h, t, d = 1, 2, 32, 8
    q, k, v = _qkv(b, h, t, t, d, seed=31)
    km = np.ones((b, t), np.int32)
    km[:, :4] = 0                      # causal rows 0..3 see no live key
    scale = 1.0 / math.sqrt(d)
    _, lse_j = jatt._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(km), True, scale)
    o, lse = tatt.flash_forward(*_t(q, k, v), torch.from_numpy(km), True, scale)
    lse_j = np.asarray(lse_j).reshape(b, h, t)
    assert np.all(lse_j[..., :4] == tatt.LSE_EMPTY)
    np.testing.assert_array_equal(lse.numpy()[..., :4], lse_j[..., :4])
    np.testing.assert_allclose(lse.numpy()[..., 4:], lse_j[..., 4:], **TOL)
    assert bool(torch.isfinite(o).all())


def test_flash_mha_routes_float64_to_mha():
    q, k, v = (torch.from_numpy(a.astype(np.float64))
               for a in _qkv(1, 2, 24, 24, 8, seed=41))
    got = tatt.flash_mha(q, k, v, True)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, tatt.mha(q, k, v, causal=True),
                               atol=0, rtol=0)


def test_flash_forward_on_cpu_takes_the_plain_version():
    q, k, v = _t(*_qkv(1, 1, 16, 16, 8, seed=51))
    before = tatt.flash_forward_cuda.launches
    o, lse = tatt.flash_forward(q, k, v, None, True)
    ref = tatt.flash_forward_plain(q, k, v, None, True, 1.0 / math.sqrt(8))
    assert tatt.flash_forward_cuda.launches == before
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])


def test_flash_forward_rejects_bad_arguments():
    q, k, v = _t(*_qkv(1, 1, 16, 16, 8, seed=52))
    with pytest.raises(ValueError):
        tatt.flash_forward(q, k[:, :, :, :4], v[:, :, :, :4])
    # float64 (which flash_mha routes to mha) and mixed dtypes are refused;
    # float16 is taken, as the reference's kernel takes it
    with pytest.raises(TypeError):
        tatt.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        tatt.flash_forward(q, k.half(), v)
    with pytest.raises(ValueError):
        tatt.flash_forward(q, k, v, torch.ones(2, 16, dtype=torch.int32))


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_matches_jax(causal, mask):
    q, k, v = _qkv(2, 2, 12, 12, 8, seed=61)
    m = None
    if mask:
        m = _kmask(2, 12, seed=62)[:, None, None, :]
    want = np.asarray(jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal,
                               mask=None if m is None else jnp.asarray(m)))
    got = tatt.mha(*_t(q, k, v), causal=causal,
                   mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_heads_layout_matches_jax():
    x = np.random.default_rng(71).standard_normal((2, 5, 12), dtype=np.float32)
    sj = np.asarray(jatt.split_heads(jnp.asarray(x), 3))
    st = tatt.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(tatt.merge_heads(st).numpy(), x)
    np.testing.assert_array_equal(tatt.causal_bias(4, 6, 2, 0).numpy(),
                                  np.asarray(jatt.causal_bias(4, 6, 2, 0)))


# -- backward: K2/K3's plain versions and the autograd Function ------------------------


def _jax_grads(q, k, v, g, causal, km, kernel=True):
    """(dq, dk, dv) of <flash_mha(q, k, v), g> by jax.grad: the custom
    VJP's Pallas backward (interpret mode) where the lengths tile, its
    XLA backward where they do not."""
    import jax

    def f(q_, k_, v_):
        o = jatt.flash_mha(q_, k_, v_, causal,
                           kmask=None if km is None else jnp.asarray(km))
        return jnp.sum(o * jnp.asarray(g))

    return [np.asarray(a) for a in
            jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, g, causal, km):
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    o = tatt.flash_mha(qt, kt, vt, causal,
                       kmask=None if km is None else torch.from_numpy(km))
    o.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("t", [64, 20], ids=["tiles", "mha_route"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_matches_jax_grad(causal, masked, t):
    q, k, v = _qkv(2, 3, t, t, 16, seed=80 + t + 2 * causal + masked)
    g = np.random.default_rng(81).standard_normal(q.shape, dtype=np.float32)
    km = _kmask(2, t, seed=82) if masked else None
    for got, want in zip(_port_grads(q, k, v, g, causal, km),
                         _jax_grads(q, k, v, g, causal, km)):
        np.testing.assert_allclose(got, want, **TOL)


def test_flash_backward_plain_matches_jax_kernels():
    b, h, t, d = 2, 2, 64, 16
    q, k, v = _qkv(b, h, t, t, d, seed=83)
    g = np.random.default_rng(84).standard_normal(q.shape, dtype=np.float32)
    km = _kmask(b, t, seed=85)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jkm, jg = (jnp.asarray(a) for a in (q, k, v, km, g))
    o_j, lse_j = jatt._flash_forward(jq, jk, jv, jkm, True, scale)
    want = jatt._flash_backward(jq, jk, jv, jkm, o_j, lse_j, jg, True, scale)
    qt, kt, vt, gt = _t(q, k, v, g)
    o, lse = tatt.flash_forward(qt, kt, vt, torch.from_numpy(km), True, scale)
    delta = tatt.flash_delta(o, gt)
    got = tatt.flash_backward_plain(qt, kt, vt, gt, lse, delta, torch.from_numpy(km),
                                    True, scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    dk, dv = tatt.flash_bwd_dkdv_plain(qt, kt, vt, gt, lse, delta,
                                       torch.from_numpy(km), True, scale)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


def test_rows_without_a_live_key_get_zero_gradients():
    b, h, t, d = 1, 2, 32, 8
    q, k, v = _qkv(b, h, t, t, d, seed=86)
    g = np.random.default_rng(87).standard_normal(q.shape, dtype=np.float32)
    km = np.ones((b, t), np.int32)
    km[:, :4] = 0                      # causal rows 0..3 see no live key
    dq, dk, dv = _port_grads(q, k, v, g, True, km)
    assert not dq[:, :, :4].any()      # exactly zero, not merely small
    assert not dk[:, :, :4].any() and not dv[:, :, :4].any()
    for got, want in zip((dq, dk, dv), _jax_grads(q, k, v, g, True, km)):
        np.testing.assert_allclose(got, want, **TOL)


def test_flash_backward_on_cpu_takes_the_plain_versions():
    q, k, v = _t(*_qkv(1, 1, 16, 16, 8, seed=88))
    before = (tatt.flash_bwd_dkdv_cuda.launches, tatt.flash_bwd_dq_cuda.launches)
    o, lse = tatt.flash_forward(q, k, v, None, True)
    grads = tatt.flash_backward(q, k, v, None, o, lse, torch.ones_like(q), True,
                                1.0 / math.sqrt(8))
    assert (tatt.flash_bwd_dkdv_cuda.launches, tatt.flash_bwd_dq_cuda.launches) == before
    assert all(gr.shape == q.shape for gr in grads)


def test_float64_gradients_take_the_mha_route():
    q, k, v = (torch.from_numpy(a.astype(np.float64)).requires_grad_()
               for a in _qkv(1, 2, 24, 24, 8, seed=89))
    tatt.flash_mha(q, k, v, True).sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    tatt.mha(q2, k2, v2, causal=True).sum().backward()
    for a, b_ in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b_.grad)
