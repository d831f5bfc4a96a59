"""The port's ring and Ulysses attention (``deeplearning4j_tpu_torch/parallel/
ring.py``, ``ulysses.py``) against the JAX package's on the CPU.

q/k/v [2, 4, 32, 16] from a numpy seed, the sequence split over a
``{seq 4}`` mesh: ``ring_self_attention`` causal and not, and
``ulysses_self_attention`` causal and not, and causal with a key mask
(the batch rows mask their last 5 and 11 keys).  The JAX side runs on
four of the virtual CPU devices (its Ulysses reaches ``flash_mha`` as
its own tests run it there); the port side is four gloo processes
(``file://`` rendezvous, this file run as a script with ``--worker``),
one spawn for the mesh.  Tolerances: outputs within 3e-5 of the JAX
functions', the gradients of sum(out²) with respect to q, k and v within
1e-4; every rank returns the same bits.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
SHAPE = (2, 4, 32, 16)
#: case → (function, causal, key mask)
CASES = {
    "ring": ("ring", False, False),
    "ring_causal": ("ring", True, False),
    "ulysses": ("ulysses", False, False),
    "ulysses_causal": ("ulysses", True, False),
    "ulysses_causal_kmask": ("ulysses", True, True),
}


def _inputs():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    kmask = np.ones(SHAPE[0:1] + SHAPE[2:3], np.int32)
    kmask[0, -5:] = 0
    kmask[1, -11:] = 0
    return q, k, v, kmask


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import (build_mesh, initialize,
                                                   ring_self_attention, shutdown,
                                                   ulysses_self_attention)

    initialize(init_method="file://" + os.path.join(work, "rendezvous"),
               num_processes=RANKS, process_id=rank, backend="gloo", timeout_s=100)
    mesh = build_mesh({"seq": RANKS})
    q, k, v, kmask = (torch.from_numpy(a) for a in _inputs())
    out = {}
    for name, (fn, causal, masked) in CASES.items():
        qq, kk, vv = (a.clone().requires_grad_(True) for a in (q, k, v))
        if fn == "ring":
            o = ring_self_attention(qq, kk, vv, mesh, causal=causal)
        else:
            o = ulysses_self_attention(qq, kk, vv, mesh, causal=causal,
                                       kmask=kmask if masked else None)
        (o ** 2).sum().backward()
        out[f"{name}/out"] = o.detach().numpy()
        for n, t in (("dq", qq), ("dk", kk), ("dv", vv)):
            out[f"{name}/{n}"] = t.grad.numpy()
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu.parallel import ring_self_attention as j_ring
    from deeplearning4j_tpu.parallel.ulysses import ulysses_self_attention as j_uly

    # the port's ranks run while the JAX side compiles
    work = str(tmp_path_factory.mktemp("ring"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        mesh = j_mesh({"seq": RANKS}, devices=jax.devices()[:RANKS])
        q, k, v, kmask = _inputs()
        jax_out = {}
        for name, (fn, causal, masked) in CASES.items():
            def f(q, k, v):
                if fn == "ring":
                    o = j_ring(q, k, v, mesh, causal=causal)
                else:
                    o = j_uly(q, k, v, mesh, causal=causal,
                              kmask=jnp.asarray(kmask) if masked else None)
                return jnp.sum(o ** 2), o
            (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            jax_out[name] = {"out": np.asarray(o), "dq": np.asarray(g[0]),
                             "dk": np.asarray(g[1]), "dv": np.asarray(g[2])}
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        assert p.returncode == 0, f"rank {r} failed:\n{log.read()[-3000:]}"
        log.close()
    port = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(RANKS)]
    return {"jax": jax_out, "port": port}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    np.testing.assert_allclose(runs["port"][0][f"{case}/out"], runs["jax"][case]["out"],
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(runs, case):
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(runs["port"][0][f"{case}/{g}"], runs["jax"][case][g],
                                   atol=1e-4, rtol=1e-4, err_msg=g)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_returns_the_same_bits(runs, case):
    for r in range(1, RANKS):
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(runs["port"][r][f"{case}/{key}"],
                                          runs["port"][0][f"{case}/{key}"])


def test_blockwise_update_matches_jax():
    """One online-softmax step, f32 and bf16 inputs, with a causal bias."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.attention import blockwise_update as j_update
    from deeplearning4j_tpu.ops.attention import causal_bias as j_bias
    from deeplearning4j_tpu_torch.ops.attention import blockwise_update, causal_bias

    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(16, 8)).astype(np.float32) for _ in range(3))
    acc = rng.normal(size=(16, 8)).astype(np.float32)
    m = rng.normal(size=(16, 1)).astype(np.float32)
    l = np.abs(rng.normal(size=(16, 1))).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 2e-2)):
        want = j_update(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l),
                        *(jnp.asarray(a, jdt) for a in (q, k, v)), 0.3, j_bias(16, 16, 16, 0))
        got = blockwise_update(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l),
                               *(torch.from_numpy(a).to(dt) for a in (q, k, v)), 0.3,
                               causal_bias(16, 16, 16, 0))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


def test_ulysses_refuses_heads_below_the_axis():
    from deeplearning4j_tpu_torch.parallel import ulysses_attention
    from deeplearning4j_tpu_torch.parallel.collectives import Axis

    class _Mesh:
        shape, coords = {"seq": 1}, {"seq": 0}

        def group(self, axis):
            return None

    ax = Axis(_Mesh(), "seq")
    ax.size = 3
    q = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="not divisible by 'seq' axis size 3"):
        ulysses_attention(q, q, q, ax)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
