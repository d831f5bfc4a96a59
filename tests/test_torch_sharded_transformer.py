"""The port's ``ShardedTransformerLM`` (``deeplearning4j_tpu_torch/parallel/
transformer.py``) against the JAX package's on the CPU.

A tiny LM (vocab 64, 4 layers, d_model 32, 4 heads, max_len 16) on a
global [8, 16] batch of ids from a numpy seed (targets rolled by one),
SGD lr 0.1, 3 ``fit_batch`` steps from the JAX LM's initial weights
(carried across by ``load_params``), in seven arms of four ranks:
``{data 2, model 2}``, ``{model 2, seq 2}`` with ring and with Ulysses
attention, and ``{model 2, pipe 2}`` with GPipe and 1F1B at M = 2 and
4.  The JAX side runs on four of the virtual CPU devices; the port side
is four gloo processes (``file://`` rendezvous), this file run as a
script (``--worker``), one spawn that runs every arm.

Tolerances: losses within 1e-5 relative of the JAX run on the same mesh
at every step, the gathered parameters within 1e-5 (f32 sums in other
orders: the collectives, the vocabulary-parallel loss); 1F1B's first
loss bitwise GPipe's in the port (the same value program); the leaves a
line of ranks shares bitwise equal across it.  Decode: one-way and over
``{data 2}`` (tensor-parallel, two head shards in one process) the
tokens of the JAX engine on the same LM and its echoed logits within
1e-5, each program's logits bitwise its own re-encode.  The
constructor's errors are the reference's.

The meshes train with SGD because Adam divides each gradient by its own
running magnitude, which turns last-bit differences of near-zero
gradients into parameter moves of up to the learning rate: after 3
Adam(3e-4) steps the reference's own meshes differ from its one-device
run by up to 6.5e-6 (SGD: 1.2e-7).  Adam (bf16 moments, as bench config 7
runs it) and its moments carried across are held on one rank.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
STEPS = 3
SIZE = dict(vocab_size=64, n_layers=4, d_model=32, n_heads=4, max_len=16)
LR = 0.1
#: mesh name → (axes, LM keyword arguments)
MESHES = {
    "dp_tp": ({"data": 2, "model": 2}, {}),
    "tp_sp_ring": ({"model": 2, "seq": 2}, {"seq_parallel": "ring"}),
    "tp_sp_ulysses": ({"model": 2, "seq": 2}, {"seq_parallel": "ulysses"}),
    "tp_pp_gpipe": ({"model": 2, "pipe": 2}, {"schedule": "gpipe", "n_microbatches": 2}),
    "tp_pp_1f1b": ({"model": 2, "pipe": 2}, {"schedule": "1f1b", "n_microbatches": 2}),
    "tp_pp_gpipe_m4": ({"model": 2, "pipe": 2}, {"schedule": "gpipe", "n_microbatches": 4}),
    "tp_pp_1f1b_m4": ({"model": 2, "pipe": 2}, {"schedule": "1f1b", "n_microbatches": 4}),
}
#: block leaves split over ``model`` (the rest are replicated over it)
TP_LEAVES = {"Wq", "Wk", "Wv", "W1", "b1", "Wo", "W2"}


def _data(seed=0, b=8):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SIZE["vocab_size"], (b, SIZE["max_len"])).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _flat(tree):
    """Leaves in sorted-key order (blocks nested), as f32 arrays."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            for b in sorted(tree[k]):
                out[f"{k}/{b}"] = np.asarray(tree[k][b], np.float32)
        else:
            out[k] = np.asarray(tree[k], np.float32)
    return out


def _unflat(d):
    tree = {}
    for key, v in d.items():
        if "/" in key:
            a, b = key.split("/")
            tree.setdefault(a, {})[b] = v
        else:
            tree[key] = v
    return tree


# -- the port's ranks -----------------------------------------------------------------


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (ShardedTransformerLM, build_mesh,
                                                   initialize, shutdown)

    initialize(init_method="file://" + os.path.join(work, "rendezvous"),
               num_processes=RANKS, process_id=rank, backend="gloo", timeout_s=100)
    init = dict(np.load(os.path.join(work, "init.npz")))
    params = _unflat({k[2:]: v for k, v in init.items() if k.startswith("p/")})
    tok, tgt = _data()
    out = {}
    for name, (axes, kw) in MESHES.items():
        lm = ShardedTransformerLM(**SIZE, mesh=build_mesh(axes), updater=Sgd(lr=LR),
                                  device="cpu", **kw)
        lm.load_params(params)
        out[f"{name}/losses"] = np.asarray([float(lm.fit_batch(tok, tgt))
                                            for _ in range(STEPS)])
        for k, v in _flat(lm.params_numpy()).items():
            out[f"{name}/params/{k}"] = v
        for k, v in _flat({kk: vv.detach() for kk, vv in lm.params.items()
                           if kk != "blocks"}).items():
            out[f"{name}/local/{k}"] = v
        for k, v in lm.params["blocks"].items():
            out[f"{name}/local/blocks/{k}"] = v.detach().numpy()
        out[f"{name}/coords"] = np.asarray([lm.mesh.coords[a] for a in
                                            ("data", "model", "seq", "pipe")])
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


# -- the JAX side and the run -----------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
    from deeplearning4j_tpu.parallel import ShardedTransformerLM as JLM
    from deeplearning4j_tpu.parallel import build_mesh as j_mesh

    work = str(tmp_path_factory.mktemp("sharded"))
    tok, tgt = _data()

    def build(axes, kw):
        n = int(np.prod(list(axes.values())))
        return JLM(**SIZE, mesh=j_mesh(axes, devices=jax.devices()[:n]),
                   updater=JSgd(lr=LR), seed=1, **kw)

    params = jax.tree_util.tree_map(np.asarray, build({"data": 1}, {}).params)
    np.savez(os.path.join(work, "init.npz"),
             **{f"p/{k}": v for k, v in _flat(params).items()})
    # the port's ranks run while the JAX side compiles
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        jax_out = {}
        for name, (axes, kw) in MESHES.items():
            lm = build(axes, kw)
            jax_out[name] = {
                "losses": np.asarray([float(lm.fit_batch(tok, tgt)) for _ in range(STEPS)]),
                "params": _flat(jax.tree_util.tree_map(np.asarray, lm.params))}
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


@pytest.mark.parametrize("mesh", list(MESHES))
def test_losses_match_jax_on_the_same_mesh(runs, mesh):
    want = runs["jax"][mesh]["losses"]
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r][f"{mesh}/losses"], want,
                                   rtol=1e-5, atol=0)
    assert want[-1] < want[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_params_match_jax(runs, mesh):
    want = runs["jax"][mesh]["params"]
    for r in range(RANKS):
        for k, v in want.items():
            np.testing.assert_allclose(runs["port"][r][f"{mesh}/params/{k}"], v,
                                       atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("m", ["tp_pp_1f1b", "tp_pp_1f1b_m4"])
def test_1f1b_first_loss_is_bitwise_gpipe(runs, m):
    """1F1B's value pass is GPipe's program at the same microbatch count,
    so the first step's loss (which no update has touched) is the same
    bits, at M = 2 and 4."""
    gpipe = m.replace("1f1b", "gpipe")
    for r in range(RANKS):
        assert runs["port"][r][f"{m}/losses"][0] == runs["port"][r][f"{gpipe}/losses"][0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shared_leaves_are_bitwise_equal_across_a_line(runs, mesh):
    """Ranks that differ in one axis hold the leaves not split on that
    axis bitwise alike: all leaves across ``data`` and ``seq``, the
    replicated ones across ``model``, the non-block ones across ``pipe``."""
    port = runs["port"]
    coords = [tuple(port[r][f"{mesh}/coords"]) for r in range(RANKS)]
    local = [{k[len(mesh) + 7:]: v for k, v in port[r].items()
              if k.startswith(f"{mesh}/local/")} for r in range(RANKS)]
    pairs = 0
    for a in range(RANKS):
        for b in range(a + 1, RANKS):
            diff = [i for i in range(4) if coords[a][i] != coords[b][i]]
            if len(diff) != 1:
                continue
            axis = ("data", "model", "seq", "pipe")[diff[0]]
            for k, v in local[a].items():
                split = ((axis == "model" and (k == "head" or k.split("/")[-1] in TP_LEAVES))
                         or (axis == "pipe" and k.startswith("blocks/")))
                if not split:
                    np.testing.assert_array_equal(v, local[b][k], err_msg=f"{axis} {k}")
                    pairs += 1
    assert pairs > 0


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_one_rank_adam_with_bf16_moments_matches_jax(compute_dtype):
    """Bench config 7's updater, ``Adam(lr=3e-4, moment_dtype="bfloat16")``,
    on a one-rank mesh (blocks unrolled, flash attention's plain version
    on the CPU), f32 and bf16 compute: the JAX LM's weights and moments
    carried across, 3 steps; losses within 1e-5 relative in f32 (bf16:
    4e-3 relative, one bf16 spacing), parameters within 1e-5 (bf16: the
    update within 10% in norm), and the moments read back bitwise."""
    import jax

    from deeplearning4j_tpu.nn.updaters import Adam as JAdam
    from deeplearning4j_tpu.parallel import ShardedTransformerLM as JLM
    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh

    cd = None if compute_dtype is None else jax.numpy.bfloat16
    jlm = JLM(**SIZE, mesh=j_mesh({"data": 1}, devices=jax.devices()[:1]), seed=1,
              updater=JAdam(lr=3e-4, moment_dtype="bfloat16"), compute_dtype=cd)
    lm = ShardedTransformerLM(**SIZE, mesh=build_mesh({"data": 1}), device="cpu",
                              updater=Adam(lr=3e-4, moment_dtype="bfloat16"),
                              compute_dtype=compute_dtype)
    lm.load_params(jax.tree_util.tree_map(np.asarray, jlm.params),
                   jax.tree_util.tree_map(np.asarray, jlm.opt_state))
    assert lm.opt_state["m"]["blocks"]["Wq"].dtype == torch.bfloat16
    moments = _flat(lm.opt_state_numpy()["v"])
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jlm.opt_state["v"])).items():
        np.testing.assert_array_equal(moments[k], v)
    tok, tgt = _data()
    want = [float(jlm.fit_batch(tok, tgt)) for _ in range(STEPS)]
    got = [float(lm.fit_batch(tok, tgt)) for _ in range(STEPS)]
    f32 = compute_dtype is None
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 4e-3, atol=0)
    mine = _flat(lm.params_numpy())
    theirs = _flat(jax.tree_util.tree_map(np.asarray, jlm.params))
    if f32:
        for k, v in theirs.items():
            np.testing.assert_allclose(mine[k], v, atol=1e-5, rtol=0, err_msg=k)
        return
    # bf16: near-zero gradients take either sign, and Adam's first steps
    # move each such weight by the full learning rate either way, so the
    # updates are held as vectors: the port's within 10% of the
    # reference's in norm (the reference's own {model 2} run is 6.2% from
    # its one-device run in bf16; the port reads 6.2%)
    start = _flat(jax.tree_util.tree_map(np.asarray, JLM(
        **SIZE, mesh=j_mesh({"data": 1}, devices=jax.devices()[:1]), seed=1).params))
    d_mine = np.concatenate([(mine[k] - start[k]).ravel() for k in sorted(theirs)])
    d_want = np.concatenate([(theirs[k] - start[k]).ravel() for k in sorted(theirs)])
    assert np.linalg.norm(d_mine - d_want) <= 0.1 * np.linalg.norm(d_want)


def test_pipeline_schedule_stats_match_reference():
    from deeplearning4j_tpu.parallel.pipeline import pipeline_schedule_stats as j_stats
    from deeplearning4j_tpu_torch.parallel import pipeline_schedule_stats

    for sched in ("gpipe", "1f1b"):
        for m, s in ((2, 2), (4, 2), (8, 4)):
            kw = dict(layers_per_stage=3, residual_factor=12.0, stage_input_bytes=4096)
            assert pipeline_schedule_stats(sched, m, s, **kw) == j_stats(sched, m, s, **kw)
            assert pipeline_schedule_stats(sched, m, s) == j_stats(sched, m, s)


# -- the constructor's errors, in one process ---------------------------------------

_INVALID = {
    "not divisible by model": ({"model": 3}, {}),
    "seq_parallel must be": ({"data": 1}, {"seq_parallel": "zigzag"}),
    "ulysses scatters heads": ({"model": 2, "seq": 4}, {"seq_parallel": "ulysses"}),
    "attention_impl must be": ({"data": 1}, {"attention_impl": "cudnn"}),
    "requires seq=1": ({"seq": 2}, {"attention_impl": "xla"}),
    "n_layers 4 not divisible by pipe=3": ({"pipe": 3}, {}),
    "schedule must be one of": ({"data": 1}, {"schedule": "interleaved"}),
    "unexpected mesh axes": ({"data": 1, "expert": 2}, {}),
}


@pytest.mark.parametrize("match", list(_INVALID))
def test_constructor_errors_are_the_references(match):
    import jax

    from deeplearning4j_tpu.parallel import ShardedTransformerLM as JLM
    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh

    axes, kw = _INVALID[match]
    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError, match=match):
        JLM(**SIZE, mesh=j_mesh(axes, devices=jax.devices()[:n]), **kw)
    with pytest.raises(ValueError, match=match):
        ShardedTransformerLM(**SIZE, mesh=build_mesh(axes, world_size=n), device="cpu", **kw)


def test_decode_program_refusals():
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    lm = ShardedTransformerLM(**SIZE, mesh=build_mesh({"data": 1}), device="cpu",
                              compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        lm.decode_program()
    lm = ShardedTransformerLM(**SIZE, mesh=build_mesh({"model": 2}, world_size=2),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        lm.decode_program()
    lm = ShardedTransformerLM(**{**SIZE, "n_heads": 2, "d_model": 32},
                              mesh=build_mesh({"data": 4}, world_size=4), device="cpu")
    with pytest.raises(ValueError, match="not divisible by the decode"):
        lm.decode_program()
    lm = ShardedTransformerLM(**SIZE, mesh=build_mesh({"data": 2}, world_size=2),
                              device="cpu")
    with pytest.raises(ValueError, match="int8 KV"):
        DecodeEngine(lm, kv_dtype="int8", page_size=8, device="cpu")


# -- decode, one way and two head shards ------------------------------------------------

DECODE_LEN = 32
PROMPTS = (3, 9, 17)
SPECS = [dict(temperature=0.0), dict(temperature=0.8, top_k=10, seed=7),
         dict(temperature=0.0)]


def _serve(engine, prompts):
    futs = [engine.generate_async(p, max_new_tokens=6, echo_logits=True, **kw)
            for p, kw in zip(prompts, SPECS)]
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("n", [1, 2])
def test_decode_matches_jax_and_its_own_reencode(n):
    import jax

    from deeplearning4j_tpu.parallel import ShardedTransformerLM as JLM
    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu.serving import DecodeEngine as JEngine
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    size = {**SIZE, "max_len": DECODE_LEN}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, SIZE["vocab_size"], k).tolist() for k in PROMPTS]
    jlm = JLM(**size, mesh=j_mesh({"data": n}, devices=jax.devices()[:n]), seed=1)
    jeng = JEngine(jlm, max_slots=4, page_size=8).load()
    try:
        want = _serve(jeng, prompts)
    finally:
        jeng.shutdown()
    lm = ShardedTransformerLM(**size, mesh=build_mesh({"data": n}, world_size=n),
                              device="cpu")
    lm.load_params(jax.tree_util.tree_map(np.asarray, jlm.params))
    eng = DecodeEngine(lm, max_slots=4, page_size=8, device="cpu").load()
    try:
        got = _serve(eng, prompts)
        snap = eng.metrics_snapshot()
        assert eng.program.tp == n and snap["tp"] == n
        if n > 1:
            assert all(len(pool) == n for pool in eng._cache)
        for p, w, g in zip(prompts, want, got):
            assert g.tokens == w.tokens
            np.testing.assert_allclose(g.logits, w.logits, atol=1e-5, rtol=0)
            seq = torch.tensor([p + g.tokens[:-1]])
            with torch.inference_mode():
                ref = eng.program.reencode(eng.params, seq)[0, len(p) - 1:].numpy()
            np.testing.assert_array_equal(g.logits, ref)
        assert snap["pages_in_use"] == 0
    finally:
        eng.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
