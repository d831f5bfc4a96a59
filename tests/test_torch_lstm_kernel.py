"""The port's LSTM sequence and cell kernels (``ops/lstm_kernel.py``,
K5a/K5b) against the JAX package's: the plain cell and its closed-form
backward, the plain per-step loop against the reference's ``_scan_lstm``
(its default cell and its Pallas kernel in interpret mode), the
``LSTMSequence`` autograd Function, float64 and the dispatch by device.
On the CPU the kernels' wrappers run their plain versions; the CUDA
kernels themselves are held to those in ``tests/test_torch_cuda.py``.
One cell step is the sequence at T = 1 with h0 = 0 and b = 0, where
z = zx exactly.

Inputs come from numpy seeds and go to both packages.  Tolerances, f32:
the cell and its backward 1e-6 (the same elementwise ops; only the
libraries' sigmoid/tanh differ in the last bit); a sequence's outputs
against the reference's scan 1e-5 (the products sum in another order);
gradients through ``LSTMSequence`` against autograd of the plain loop
1e-6, against ``jax.grad`` 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import recurrent as jr
from deeplearning4j_tpu.ops import lstm_kernel as jk
from deeplearning4j_tpu_torch.nn.layers import recurrent as tr
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


def _seq_np(mb, t_len, n, seed, dtype=np.float32):
    """zx ~ N(0, 1) [mb, T, 4n], RW ~ N(0, 1/n), b ~ N(0, 0.01), h0 and
    c0 ~ N(0, 0.25), a 0/1 mask [mb, T] (first step kept), as numpy."""
    rng = np.random.default_rng(seed)
    zx = rng.standard_normal((mb, t_len, 4 * n))
    RW = rng.standard_normal((n, 4 * n)) / np.sqrt(n)
    b = 0.1 * rng.standard_normal(4 * n)
    h0, c0 = (0.5 * rng.standard_normal((mb, n)) for _ in range(2))
    mask = (rng.random((mb, t_len)) > 0.3).astype(np.float64)
    mask[:, 0] = 1.0
    return tuple(a.astype(dtype) for a in (zx, RW, b, h0, c0, mask))


def _seq_inputs(mb, t_len, n, seed, dtype=np.float32):
    """``_seq_np`` as torch tensors on the CPU."""
    return tuple(torch.from_numpy(a) for a in _seq_np(mb, t_len, n, seed, dtype))


def _cell_step(fn, z, c, seed=0):
    """One cell step (h', c') through a sequence entry ``fn`` (the
    signature of ``lstm_sequence``): T = 1, h0 = 0, b = 0 and a random RW,
    so z = zx + 0·RW + 0 = zx exactly."""
    mb, n = c.shape
    rw = np.random.default_rng(seed).standard_normal((n, 4 * n)).astype(np.float32)
    RW = torch.from_numpy(rw).to(z.dtype)
    hs, (_, cn) = fn(z[:, None], RW, torch.zeros(4 * n, dtype=z.dtype),
                     torch.zeros(mb, n, dtype=z.dtype), c)
    return hs[:, 0], cn


def _sequence_route(zx, RW, b, h0, c0, mask=None, reverse=False):
    """The card's route, ``LSTMSequence`` (K5a forward, K5b backward), on
    CPU tensors, whose kernels' dispatchers run the plain versions."""
    hs, h, c = tk.LSTMSequence.apply(zx, RW, b, h0, c0, mask, reverse)
    return hs, (h, c)


def _loss_weights(mb, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((mb, n)).astype(np.float32) for _ in range(2))


def test_fused_cell_matches_jax_pallas_kernel_in_interpret_mode(monkeypatch):
    # the reference's Pallas kernel runs in interpret mode on the CPU once
    # switched on; mb 8 and n 128 meet its tiling gates.  The port's side
    # is the card's route, LSTMSequence at T = 1 (h0 = 0, b = 0), whose
    # wrappers run the plain versions on the CPU
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
    th, tc = _cell_step(_sequence_route, tz, tc_in)
    assert "LSTMSequence" in type(tc.grad_fn).__name__
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

    fused = grads(lambda zz, cc: _cell_step(_sequence_route, zz, cc))
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
    h, _ = _cell_step(_sequence_route, tz, torch.from_numpy(c))
    h.sum().backward()
    dz, _ = tk.lstm_cell_bwd_plain(torch.from_numpy(z), torch.from_numpy(c),
                                   torch.ones(4, 6), torch.zeros(4, 6))
    np.testing.assert_allclose(tz.grad.numpy(), dz.numpy(), atol=1e-7, rtol=0)


def test_float64_takes_the_exact_plain_path():
    zx, RW, b, h0, c0, _ = _seq_inputs(5, 3, 7, 40, np.float64)
    hs, (h, cn) = tk.lstm_sequence(zx.requires_grad_(), RW, b, h0, c0)
    assert "LSTMSequence" not in type(hs.grad_fn).__name__
    want_hs, (want_h, want_c) = tk.lstm_sequence_plain(zx, RW, b, h0, c0)
    assert torch.equal(hs, want_hs) and torch.equal(h, want_h) and torch.equal(cn, want_c)
    # the closed-form backward (K5b's plain version) is the exact derivative
    zz, cc = (torch.from_numpy(a).requires_grad_() for a in _inputs(3, 4, 41, np.float64)[:2])
    assert torch.autograd.gradcheck(lambda a, b: _cell_step(_sequence_route, a, b), (zz, cc))


def test_non_cpu_tensors_never_take_the_plain_cell(monkeypatch):
    # the dispatch looks at the device alone: a tensor off the CPU goes
    # to the kernels' wrappers, which launch or raise (here: no CUDA),
    # whatever the reference's opt-in variable says
    monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", "0")
    ins = _seq_inputs(2, 4, 3, 50)[:5]
    hs, _ = tk.lstm_sequence(ins[0].requires_grad_(), *ins[1:])
    assert "LSTMSequence" not in type(hs.grad_fn).__name__
    with pytest.raises(ValueError, match="CUDA"):
        tk.lstm_sequence(*(t.detach().to("meta") for t in ins))


def test_bfloat16_on_the_cpu_runs_the_plain_cell():
    z, c, _, _ = _inputs(6, 16, 60)
    before = tk.lstm_seq_fwd_cuda.launches
    h, cn = _cell_step(tk.lstm_sequence, torch.from_numpy(z).bfloat16(),
                       torch.from_numpy(c).bfloat16())
    assert h.dtype == cn.dtype == torch.bfloat16
    assert tk.lstm_seq_fwd_cuda.launches == before
    ref = tk.lstm_cell_plain(torch.from_numpy(z), torch.from_numpy(c))
    assert float((h.float() - ref[0]).abs().max()) <= 2e-2
    assert float((cn.float() - ref[1]).abs().max()) <= 4e-2


def test_kernel_wrappers_refuse_cpu_tensors():
    z, c, dh, dcn = (torch.from_numpy(a) for a in _inputs(2, 4, 70))
    with pytest.raises(ValueError, match="CUDA"):
        tk.lstm_seq_fwd_cuda(*_seq_inputs(2, 3, 4, 70)[:5])
    with pytest.raises(ValueError, match="CUDA"):
        tk.lstm_cell_bwd_cuda(z, c, dh, dcn)


# -- the sequence: K5a's plain version and the LSTMSequence Function ----------------------

# (case, mb, T, n_in, n): ids or dense input, a mask, reverse, T = 1, and
# narrow widths
_SCAN_CASES = [("dense", 3, 7, 5, 6), ("dense_masked", 3, 7, 5, 6), ("ids", 4, 6, 11, 8),
               ("ids_masked", 4, 6, 11, 8), ("dense_reverse", 3, 7, 5, 6),
               ("ids_masked_reverse", 2, 5, 7, 16), ("dense_t1", 3, 1, 5, 6),
               ("ids_t1_masked", 5, 1, 9, 3), ("dense_wide", 2, 4, 9, 32)]


def _scan_both(case, mb, t_len, n_in, n, seed):
    """The reference's ``_scan_lstm`` and the port's (``_scan_lstm``, and
    ``lstm_sequence_plain`` on the port's projection) on one input set."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((n_in, 4 * n)) / np.sqrt(n_in)).astype(np.float32)
    _, RW, b, h0, c0, mask = _seq_np(mb, t_len, n, seed + 1)
    if "ids" in case:
        x = rng.integers(0, n_in, (mb, t_len)).astype(np.int32)
    else:
        x = rng.standard_normal((mb, t_len, n_in)).astype(np.float32)
    mask = mask if "masked" in case else None
    reverse = "reverse" in case
    params = {"W": W, "RW": RW, "b": b}
    j = jr._scan_lstm(jr.LSTM(n_in=n_in, n_out=n), {k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                      jnp.asarray(h0), jnp.asarray(c0), reverse=reverse)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx, th0, tc0 = torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(c0)
    tm = None if mask is None else torch.from_numpy(mask)
    layer = tr._scan_lstm(tr.LSTM(n_in=n_in, n_out=n), tp, tx, tm, th0, tc0, reverse=reverse)
    zx = tp["W"][tx.long()] if "ids" in case else tx @ tp["W"]
    plain = tk.lstm_sequence_plain(zx, tp["RW"], tp["b"], th0, tc0, tm, reverse)
    return j, layer, plain


def _assert_scan_close(j, *ports):
    (jhs, (jh, jc)) = j
    for hs, (h, c) in ports:
        np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=1e-5, rtol=0)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case,mb,t_len,n_in,n", _SCAN_CASES, ids=[c[0] for c in _SCAN_CASES])
def test_sequence_plain_matches_jax_scan(case, mb, t_len, n_in, n):
    j, layer, plain = _scan_both(case, mb, t_len, n_in, n, 80 + len(case))
    _assert_scan_close(j, layer, plain)


@pytest.mark.parametrize("case", ["dense", "ids_masked", "dense_masked_reverse"])
def test_sequence_plain_matches_jax_scan_with_the_pallas_cell(monkeypatch, case):
    # the reference's K5a in interpret mode on every step of its scan; mb 8
    # and n 128 meet its tiling gates
    monkeypatch.setattr(jk, "ENABLED", True)
    j, layer, plain = _scan_both(case, 8, 4, 6, 128, 90 + len(case))
    _assert_scan_close(j, layer, plain)


def test_sequence_plain_keeps_every_steps_z_and_c():
    # K5a's outputs: z and c of every step, time-major, and the last carry
    for reverse in (False, True):
        zx, RW, b, h0, c0, mask = _seq_inputs(3, 5, 4, 100)
        hs, zs, cs, h, c = tk.lstm_seq_fwd_plain(zx, RW, b, h0, c0, mask, reverse)
        assert tuple(zs.shape) == (5, 3, 16) and tuple(cs.shape) == (5, 3, 4)
        order = list(range(4, -1, -1)) if reverse else list(range(5))
        hp, cp = h0, c0
        for t in order:
            assert torch.equal(zs[t], zx[:, t] + hp @ RW + b)
            hn, cn = tk.lstm_cell_plain(zs[t], cp)
            hp, cp = tk.hold(mask[:, t], hn, hp), tk.hold(mask[:, t], cn, cp)
            assert torch.equal(hs[:, t], hp) and torch.equal(cs[t], cp)
        assert torch.equal(h, hp) and torch.equal(c, cp)
        want_hs, (want_h, want_c) = tk.lstm_sequence_plain(zx, RW, b, h0, c0, mask, reverse)
        assert torch.equal(hs, want_hs) and torch.equal(h, want_h) and torch.equal(c, want_c)


def _seq_loss_weights(mb, t_len, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((mb, t_len, n)).astype(np.float32),
            rng.standard_normal((mb, n)).astype(np.float32),
            rng.standard_normal((mb, n)).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_sequence_function_gradients_match_autograd_and_jax_grad(masked, reverse):
    mb, t_len, n = 3, 6, 5
    zx, RW, b, h0, c0, mask = _seq_np(mb, t_len, n, 110 + masked + 2 * reverse)
    mask = mask if masked else None
    w_hs, w_h, w_c = _seq_loss_weights(mb, t_len, n, 111)

    def grads(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in (zx, RW, b, h0, c0)]
        hs, (h, c) = fn(*ins, None if mask is None else torch.from_numpy(mask), reverse)
        loss = ((hs * torch.from_numpy(w_hs)).sum() + (h * torch.from_numpy(w_h)).sum()
                + (c * torch.from_numpy(w_c)).sum())
        loss.backward()
        return [t.grad.numpy() for t in ins]

    fused = grads(_sequence_route)
    plain = grads(tk.lstm_sequence_plain)

    # the reference's scan on dense input with W = I: zx = x @ I = x exactly,
    # so the gradient of x is the gradient of zx
    def jloss(x, rw, bb, hh, cc):
        params = {"W": jnp.eye(4 * n, dtype=jnp.float32), "RW": rw, "b": bb}
        hs, (h, c) = jr._scan_lstm(jr.LSTM(n_in=4 * n, n_out=n), params, x,
                                   None if mask is None else jnp.asarray(mask), hh, cc,
                                   reverse=reverse)
        return jnp.sum(hs * w_hs) + jnp.sum(h * w_h) + jnp.sum(c * w_c)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (zx, RW, b, h0, c0)))
    for a, p, w in zip(fused, plain, want):
        np.testing.assert_allclose(a, p, atol=1e-6, rtol=0)
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked,reverse", [(False, False), (True, False), (True, True)],
                         ids=["unmasked", "masked", "masked_reverse"])
def test_sequence_function_gradcheck_in_float64(masked, reverse):
    zx, RW, b, h0, c0, mask = _seq_inputs(2, 3, 2, 120, np.float64)
    ins = [t.requires_grad_() for t in (zx, RW, b, h0, c0)]
    m = mask if masked else None
    assert torch.autograd.gradcheck(
        lambda *a: tk.LSTMSequence.apply(*a, m, reverse), ins)


def test_scan_sends_only_the_standard_cell_to_the_sequence(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[6])               # reverse
        return tk.lstm_sequence_plain(*args)

    monkeypatch.setattr(tr, "lstm_sequence", spy)
    zx, RW, b, h0, c0, mask = _seq_inputs(2, 3, 4, 130)
    params = {"W": torch.eye(16), "RW": RW, "b": b}
    for cfg, reverse, want in ((tr.LSTM(n_in=16, n_out=4), False, [False]),
                               (tr.LSTM(n_in=16, n_out=4), True, [True]),
                               (tr.LSTM(n_in=16, n_out=4, gate_activation="hardsigmoid"),
                                False, []),
                               (tr.GravesLSTM(n_in=16, n_out=4), False, [])):
        calls.clear()
        p = dict(params, pW=torch.zeros(12)) if cfg.peephole else params
        hs, (h, c) = tr._scan_lstm(cfg, p, zx, mask, h0, c0, reverse=reverse)
        assert calls == want and tuple(hs.shape) == (2, 3, 4)
