"""The port's Mixture-of-Experts (``deeplearning4j_tpu_torch/parallel/moe.py``)
against the JAX package's ``parallel/moe.py`` on the CPU.

Same weights (``init_moe_params_numpy``) and tokens through both:
``moe_forward_dense`` forward within 1e-5 and gradients (of sum(y·w) +
aux with respect to the router, the experts and the tokens) within 1e-5
absolute plus 1e-5 relative; the
expert-parallel ``moe_forward_ep`` on two gloo ranks (``{model 2}``,
this file run as a script) against the reference's ``moe_forward_ep`` on
two virtual devices, at a capacity factor that drops tokens, to the same
tolerances, and the same (token, expert) routings dropped.
Logits are distinct, so the top-k order is the same in both; on a tie
both rank the lower expert index first (``top_k``).  An MLN with a
``MoE`` layer trains like the reference's from the same weights (losses
within 1e-5, the auxiliary loss in the objective), and its zip loads in
either package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, F, E, K = 64, 16, 32, 4, 2
CF = 0.75          # capacity 24 of the 32 routings an expert gets on average: drops


def _inputs():
    from deeplearning4j_tpu_torch.parallel.moe import init_moe_params_numpy

    p = init_moe_params_numpy(1, D, F, E)
    rng = np.random.default_rng(2)
    p["b1"] = rng.normal(size=p["b1"].shape).astype(np.float32) * 0.1
    p["b2"] = rng.normal(size=p["b2"].shape).astype(np.float32) * 0.1
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(N, D)).astype(np.float32)
    return p, x, w


def _jax_grads(fn, p, x, w):
    import jax
    import jax.numpy as jnp

    def loss(pp, xx):
        y, aux = fn(pp, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return (np.asarray(y), float(aux), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx))


def _port_grads(fn, p, x, w):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = fn(tp, tx)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    return (y.detach().numpy(), float(aux.detach()), {k: v.grad.numpy() for k, v in tp.items()},
            tx.grad.numpy())


def _close(got, want, tol):
    """Forward within ``tol``; gradients (entries up to ~10 here) within
    ``tol`` absolute plus ``tol`` relative (f32 sums in another order)."""
    y, aux, gp, gx = got
    wy, waux, wgp, wgx = want
    np.testing.assert_allclose(y, wy, rtol=0, atol=tol)
    assert abs(aux - waux) <= tol
    for k in wgp:
        np.testing.assert_allclose(gp[k], wgp[k], rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(gx, wgx, rtol=tol, atol=tol)


def test_dense_forward_and_gradients_match_the_reference():
    from deeplearning4j_tpu.parallel.moe import moe_forward_dense as jdense
    from deeplearning4j_tpu_torch.parallel.moe import moe_forward_dense

    p, x, w = _inputs()
    _close(_port_grads(lambda pp, xx: moe_forward_dense(pp, xx, K), p, x, w),
           _jax_grads(lambda pp, xx: jdense(pp, xx, K), p, x, w), 1e-5)


def test_top_k_breaks_ties_to_the_lower_index_as_the_reference():
    import jax

    from deeplearning4j_tpu_torch.parallel.moe import top_k

    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0], [0.1, 0.2, 0.3, 0.3]],
                      np.float32)
    v, i = top_k(torch.from_numpy(logits), 2)
    jv, ji = jax.lax.top_k(logits, 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _reference_drops(p, x):
    """(token, expert) routings past capacity, from the reference's router."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel.moe import _router, capacity

    gates, _ = _router({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), K)
    routed = np.asarray(gates) > 0
    pos = np.cumsum(routed, axis=0) - routed
    return routed & (pos >= capacity(N, E, K, CF))


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import build_mesh, initialize, shutdown
    from deeplearning4j_tpu_torch.parallel.collectives import Axis, all_reduce
    from deeplearning4j_tpu_torch.parallel.moe import moe_forward_ep

    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=100)
    mesh = build_mesh({"model": 2})
    p, x, w = _inputs()
    y, aux, gp, gx = _port_grads(
        lambda pp, xx: moe_forward_ep(pp, xx, mesh, k=K, capacity_factor=CF), p, x, w)
    ax = Axis(mesh, "model")
    # each rank's expert gradients land in its slice: the sum is the whole
    out = {"y": y, "aux": np.asarray(aux), "gx": gx}
    for k, g in gp.items():
        out[f"g/{k}"] = (g if k == "Wg" else all_reduce(torch.from_numpy(g), ax).numpy())
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("moe"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]


def test_expert_parallel_matches_the_references_on_two_ranks(ep_ranks):
    import jax

    from deeplearning4j_tpu.parallel.mesh import build_mesh as jmesh
    from deeplearning4j_tpu.parallel.moe import moe_forward_ep as jep

    p, x, w = _inputs()
    mesh = jmesh({"data": 1, "model": 2}, devices=jax.devices()[:2])
    want = _jax_grads(lambda pp, xx: jep(pp, xx, mesh, k=K, capacity_factor=CF), p, x, w)
    for r in range(2):
        got = ep_ranks[r]
        _close((got["y"], float(got["aux"]), {k: got[f"g/{k}"] for k in p}, got["gx"]),
               want, 1e-5)


def test_the_same_tokens_are_dropped():
    from deeplearning4j_tpu_torch.parallel.moe import dropped_tokens

    p, x, _ = _inputs()
    got = dropped_tokens({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), K, CF).numpy()
    want = _reference_drops(p, x)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_ep_differs_from_dense_only_by_the_dropped_tokens(ep_ranks):
    """Tokens none of whose routings dropped get the dense output."""
    from deeplearning4j_tpu_torch.parallel.moe import moe_forward_dense

    p, x, _ = _inputs()
    y, _ = moe_forward_dense({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), K)
    kept = ~_reference_drops(p, x).any(axis=1)
    np.testing.assert_allclose(ep_ranks[0]["y"][kept], y.numpy()[kept], rtol=0, atol=1e-5)


def _jax_moe_net():
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Adam
    from deeplearning4j_tpu.parallel.moe import MoE

    conf = (NeuralNetConfiguration.builder().seed(4).updater(Adam(lr=0.01))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(MoE(d_ff=32, n_experts=4, top_k=2, aux_weight=0.1))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    net = MultiLayerNetwork(conf)
    net.init()
    return net


def test_an_mln_with_moe_trains_like_the_reference_and_loads_both_ways(tmp_path):
    import jax

    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.utils.serializer import load_model as jload
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers.base import AUX_LOSS_KEY
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    jnet = _jax_moe_net()
    path = str(tmp_path / "jax.zip")
    jnet.save(path)
    net = load_model(path, device="cpu")           # the config names MoE
    assert type(net.conf.layers[1]).__name__ == "MoE"
    net.opt_state = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.opt_state),
                                      device="cpu")
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(32, 8)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    want = [float(jnet.fit_batch(JDataSet(xs, ys))) for _ in range(4)]
    got = [float(net.fit_batch(DataSet(xs, ys))) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(net.state[1][AUX_LOSS_KEY]) > 0
    back = str(tmp_path / "port.zip")
    net.save(back)
    ref = jload(back)
    np.testing.assert_allclose(np.asarray(ref.output(xs)), net.output(xs).numpy(),
                               rtol=0, atol=1e-5)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
