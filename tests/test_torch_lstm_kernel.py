"""The port's fused LSTM cell (``ops/lstm_kernel.py``, kernels K5a/K5b)
against the JAX package's: the plain cell and its closed-form backward,
the Pallas kernel in interpret mode, the ``LSTMCell`` autograd Function,
float64 and the dispatch by device.  On the CPU the kernels' wrappers run
their plain versions; the CUDA kernels themselves are held to those in
``tests/test_torch_cuda.py``.

Inputs come from numpy seeds and go to both packages.  Tolerances, f32:
the cell and its backward 1e-6 (the same elementwise ops; only the
libraries' sigmoid/tanh differ in the last bit); gradients through
``LSTMCell`` against autograd of the plain cell 1e-6, against ``jax.grad``
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import lstm_kernel as jk
from deeplearning4j_tpu_torch.ops import lstm_kernel as tk


def _inputs(mb, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((mb, 4 * n)).astype(dtype)
    c, dh, dcn = (rng.standard_normal((mb, n)).astype(dtype) for _ in range(3))
    return z, c, dh, dcn


@pytest.mark.parametrize("mb,n", [(1, 3), (7, 32), (8, 128), (64, 256)])
def test_plain_cell_and_backward_match_jax(mb, n):
    z, c, dh, dcn = _inputs(mb, n, mb + n)
    jh, jc = jk._plain_cell(jnp.asarray(z), jnp.asarray(c))
    th, tc = tk.lstm_cell_plain(torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    jdz, jdc = jk._bwd_math(*(jnp.asarray(a) for a in (z, c, dh, dcn)))
    tdz, tdc = tk.lstm_cell_bwd_plain(*(torch.from_numpy(a) for a in (z, c, dh, dcn)))
    np.testing.assert_allclose(tdz.numpy(), np.asarray(jdz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), atol=1e-6, rtol=0)


def _loss_weights(mb, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((mb, n)).astype(np.float32) for _ in range(2))


def test_fused_cell_matches_jax_pallas_kernel_in_interpret_mode(monkeypatch):
    # the reference's Pallas kernel runs in interpret mode on the CPU once
    # switched on; mb 8 and n 128 meet its tiling gates.  The port's side
    # is the card's route, LSTMCell, whose wrappers run the plain versions
    # on the CPU
    monkeypatch.setattr(jk, "ENABLED", True)
    mb, n = 8, 128
    z, c, _, _ = _inputs(mb, n, 11)
    wh, wc = _loss_weights(mb, n, 12)

    def jloss(zz, cc):
        h, cn = jk.fused_lstm_cell(zz, cc)
        return jnp.sum(h * wh) + jnp.sum(cn * wc)

    (jh, jc) = jk.fused_lstm_cell(jnp.asarray(z), jnp.asarray(c))
    jdz, jdc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(c))
    tz, tc_in = (torch.from_numpy(a).requires_grad_() for a in (z, c))
    th, tc = tk.LSTMCell.apply(tz, tc_in)
    assert th.grad_fn is not None and "LSTMCell" in type(th.grad_fn).__name__
    (th * torch.from_numpy(wh)).sum().add((tc * torch.from_numpy(wc)).sum()).backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jdz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc_in.grad.numpy(), np.asarray(jdc), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mb,n", [(3, 5), (8, 128)])
def test_lstm_cell_gradients_match_autograd_and_jax_grad(mb, n):
    z, c, _, _ = _inputs(mb, n, 20 + n)
    wh, wc = _loss_weights(mb, n, 21 + n)

    def grads(fn):
        tz, tcc = (torch.from_numpy(a).requires_grad_() for a in (z, c))
        h, cn = fn(tz, tcc)
        ((h * torch.from_numpy(wh)).sum() + (cn * torch.from_numpy(wc)).sum()).backward()
        return tz.grad.numpy(), tcc.grad.numpy()

    fused = grads(tk.LSTMCell.apply)
    plain = grads(tk.lstm_cell_plain)

    def jloss(zz, cc):
        h, cn = jk._plain_cell(zz, cc)
        return jnp.sum(h * wh) + jnp.sum(cn * wc)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(c))
    for a, p, w in zip(fused, plain, want):
        np.testing.assert_allclose(a, p, atol=1e-6, rtol=0)
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5, rtol=0)


def test_unused_cell_state_gradient_arrives_as_zeros():
    # a sequence's last c' feeds nothing: its cotangent is materialized as
    # zeros, so the backward still runs K5b's math
    z, c, _, _ = _inputs(4, 6, 30)
    tz = torch.from_numpy(z).requires_grad_()
    h, _ = tk.LSTMCell.apply(tz, torch.from_numpy(c))
    h.sum().backward()
    dz, _ = tk.lstm_cell_bwd_plain(torch.from_numpy(z), torch.from_numpy(c),
                                   torch.ones(4, 6), torch.zeros(4, 6))
    np.testing.assert_allclose(tz.grad.numpy(), dz.numpy(), atol=1e-7, rtol=0)


def test_float64_takes_the_exact_plain_path():
    z, c, _, _ = _inputs(5, 7, 40, np.float64)
    tz, tcc = torch.from_numpy(z), torch.from_numpy(c)
    h, cn = tk.fused_lstm_cell(tz.requires_grad_(), tcc)
    assert "LSTMCell" not in type(h.grad_fn).__name__
    want = tk.lstm_cell_plain(tz, tcc)
    assert torch.equal(h, want[0]) and torch.equal(cn, want[1])
    # the closed-form backward (K5b's plain version) is the exact derivative
    zz, cc = (torch.from_numpy(a).requires_grad_() for a in _inputs(3, 4, 41, np.float64)[:2])
    assert torch.autograd.gradcheck(tk.LSTMCell.apply, (zz, cc))


def test_non_cpu_tensors_never_take_the_plain_cell(monkeypatch):
    # the dispatch looks at the device alone: a tensor off the CPU goes
    # to the kernels' wrappers, which launch or raise (here: no CUDA),
    # whatever the reference's opt-in variable says
    monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", "0")
    z, c, _, _ = _inputs(2, 3, 50)
    tz = torch.from_numpy(z).requires_grad_()
    h, _ = tk.fused_lstm_cell(tz, torch.from_numpy(c))
    assert "LSTMCell" not in type(h.grad_fn).__name__
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_lstm_cell(torch.from_numpy(z).to("meta"), torch.from_numpy(c).to("meta"))


def test_bfloat16_on_the_cpu_runs_the_plain_cell():
    z, c, _, _ = _inputs(6, 16, 60)
    before = tk.lstm_cell_fwd_cuda.launches
    h, cn = tk.fused_lstm_cell(torch.from_numpy(z).bfloat16(), torch.from_numpy(c).bfloat16())
    assert h.dtype == cn.dtype == torch.bfloat16
    assert tk.lstm_cell_fwd_cuda.launches == before
    ref = tk.lstm_cell_plain(torch.from_numpy(z), torch.from_numpy(c))
    assert float((h.float() - ref[0]).abs().max()) <= 2e-2
    assert float((cn.float() - ref[1]).abs().max()) <= 4e-2


def test_kernel_wrappers_refuse_cpu_tensors():
    z, c, dh, dcn = (torch.from_numpy(a) for a in _inputs(2, 4, 70))
    with pytest.raises(ValueError, match="CUDA"):
        tk.lstm_cell_fwd_cuda(z, c)
    with pytest.raises(ValueError, match="CUDA"):
        tk.lstm_cell_bwd_cuda(z, c, dh, dcn)
