"""The port's ``pipeline_apply`` (``deeplearning4j_tpu_torch/parallel/
pipeline.py``) against the JAX package's on the CPU.

A stack of 8 blocks ``tanh(h·W + b)`` (f = 16, weights from a numpy seed)
on x [16, 16], pipelined over ``{pipe 4}`` (two stages a rank), GPipe
and 1F1B at M = 1, 2 and 4 microbatches: the output and the gradients of
sum(out²) with respect to every stage's parameters and to x within 1e-5
of the JAX ``pipeline_apply`` on four virtual CPU devices.  The port side
is four gloo processes (this file with ``--worker``), one spawn for the
mesh.  Also: each rank's 1F1B backward held at most min(M, 2S - 1)
stashed stage inputs; the forward of both schedules is the same bits;
``pipeline_schedule_stats`` equals the reference's; the errors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
N_BLOCKS, F, B = 8, 16, 16
CASES = [(s, m) for s in ("gpipe", "1f1b") for m in (1, 2, 4)]


def _inputs():
    rng = np.random.default_rng(7)
    w = (0.2 * rng.normal(size=(N_BLOCKS, F, F))).astype(np.float32)
    b = (0.1 * rng.normal(size=(N_BLOCKS, F))).astype(np.float32)
    x = rng.normal(size=(B, F)).astype(np.float32)
    return w, b, x


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import (build_mesh, initialize, pipeline,
                                                   pipeline_apply, shutdown)

    initialize(init_method="file://" + os.path.join(work, "rendezvous"),
               num_processes=RANKS, process_id=rank, backend="gloo", timeout_s=100)
    mesh = build_mesh({"pipe": RANKS})
    w, b, x = (torch.from_numpy(a) for a in _inputs())
    stages = []
    real = pipeline._Stage
    # keep each call's _Stage to read its 1f1b stash high-water mark
    pipeline._Stage = lambda *a: stages.append(real(*a)) or stages[-1]
    out = {}
    for sched, m in CASES:
        ww, bb, xx = (t.clone().requires_grad_(True) for t in (w, b, x))
        y = pipeline_apply(lambda p, h: torch.tanh(h @ p["W"] + p["b"]),
                           {"W": ww, "b": bb}, xx, mesh, n_microbatches=m, schedule=sched)
        (y ** 2).sum().backward()
        key = f"{sched}/{m}"
        out[f"{key}/out"] = y.detach().numpy()
        out[f"{key}/dW"], out[f"{key}/db"], out[f"{key}/dx"] = (
            t.grad.numpy() for t in (ww, bb, xx))
        out[f"{key}/peak_stash"] = np.asarray(stages[-1].peak_stash)
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu.parallel import pipeline_apply as j_pipeline

    work = str(tmp_path_factory.mktemp("pipe"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        mesh = j_mesh({"pipe": RANKS}, devices=jax.devices()[:RANKS])
        w, b, x = _inputs()
        jax_out = {}
        for sched, m in CASES:
            def f(params, x):
                y = j_pipeline(lambda p, h: jnp.tanh(h @ p["W"] + p["b"]), params, x,
                               mesh, n_microbatches=m, schedule=sched)
                return jnp.sum(y ** 2), y
            (_, y), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                {"W": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
            jax_out[f"{sched}/{m}"] = {"out": np.asarray(y), "dW": np.asarray(g[0]["W"]),
                                       "db": np.asarray(g[0]["b"]), "dx": np.asarray(g[1])}
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


def _sequential(w, b, x):
    h = x
    for i in range(N_BLOCKS):
        h = np.tanh(h @ w[i] + b[i])
    return h


@pytest.mark.parametrize("sched,m", CASES)
def test_output_matches_jax_on_every_rank(runs, sched, m):
    want = runs["jax"][f"{sched}/{m}"]["out"]
    np.testing.assert_allclose(want, _sequential(*_inputs()), atol=1e-5, rtol=1e-5)
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r][f"{sched}/{m}/out"], want,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sched,m", CASES)
def test_gradients_match_jax(runs, sched, m):
    """A rank's stacked-parameter gradient covers its own stages (zeros
    elsewhere), so the ranks' sum is the whole; dx is on every rank."""
    want = runs["jax"][f"{sched}/{m}"]
    for g in ("dW", "db"):
        total = sum(runs["port"][r][f"{sched}/{m}/{g}"] for r in range(RANKS))
        np.testing.assert_allclose(total, want[g], atol=1e-5, rtol=1e-5, err_msg=g)
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r][f"{sched}/{m}/dx"], want["dx"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_1f1b_forward_is_gpipes_and_its_stash_is_depth_bounded(runs, m):
    for r in range(RANKS):
        port = runs["port"][r]
        np.testing.assert_array_equal(port[f"1f1b/{m}/out"], port[f"gpipe/{m}/out"])
        assert 1 <= int(port[f"1f1b/{m}/peak_stash"]) <= min(m, 2 * RANKS - 1)


def test_errors_and_microbatch_degrade(caplog):
    from deeplearning4j_tpu_torch.parallel import build_mesh, pipeline_apply
    from deeplearning4j_tpu_torch.parallel.pipeline import microbatches

    with pytest.raises(ValueError, match="schedule must be one of"):
        pipeline_apply(lambda p, h: h, {"W": torch.zeros(2, 1)}, torch.zeros(4, 1),
                       build_mesh(), schedule="zigzag")
    with pytest.raises(ValueError, match="3 stages not divisible by pipe=2"):
        pipeline_apply(lambda p, h: h, {"W": torch.zeros(3, 1)}, torch.zeros(4, 1),
                       build_mesh({"pipe": 2}, world_size=2))
    assert microbatches(12, 4) == 4
    with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch"):
        assert microbatches(7, 4) == 1
    assert "NO pipelining" in caplog.text


def test_one_rank_pipeline_is_the_stack():
    """pipe = 1: the microbatched stack equals the blocks applied in turn."""
    from deeplearning4j_tpu_torch.parallel import build_mesh, pipeline_apply

    w, b, x = (torch.from_numpy(a) for a in _inputs())
    for sched in ("gpipe", "1f1b"):
        y = pipeline_apply(lambda p, h: torch.tanh(h @ p["W"] + p["b"]), {"W": w, "b": b},
                           x, build_mesh(), n_microbatches=4, schedule=sched)
        np.testing.assert_allclose(y.numpy(), _sequential(*_inputs()), atol=1e-5)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
