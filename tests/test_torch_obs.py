"""The port's observability copies (``deeplearning4j_tpu_torch/obs``)
against the JAX package's ``obs`` on the CPU: the same registry
operations give the reference's snapshot dict, snapshots from both merge
into one pod view, and a port trace and a reference trace pass both
validators and merge into one timeline (either package's merge).
Also: the port's ElasticTrainer records the reference's span and instant
names, and its recovery counters reach the registry; and the training
loop opens the reference's spans at the reference's places (``fit_batch``
plain and guarded, ``ShardedTrainer``'s compressed step, the score reads,
``update_kernel.jit_apply``) with the same nesting and args, while a
traced step stays bitwise the untraced one.
"""

import json

import numpy as np
import pytest

import deeplearning4j_tpu.obs.metrics as JM
import deeplearning4j_tpu.obs.trace as JT
import deeplearning4j_tpu_torch.obs.metrics as TM
import deeplearning4j_tpu_torch.obs.trace as TT


def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total")
    c.inc()
    c.inc(2.5, replica=0)
    c.inc(1, replica=1)
    g = reg.gauge("queue_depth")
    g.set(3, replica=0)
    reg.gauge("const").set_fn(lambda: 7.0)
    h = reg.histogram("latency_ms", buckets=(1.0, 5.0, 25.0))
    for v in (0.5, 2.0, 3.0, 30.0, 4.0):
        h.record(v)
    h.record(9.0, replica=1)
    reg.register_collector("elastic", lambda: {"restarts": 2, "steps": [1, 2]})
    return reg.snapshot()


def test_registry_snapshot_is_the_references():
    assert _drive(TM) == _drive(JM)


def test_snapshots_merge_across_packages():
    a, b = _drive(TM), _drive(JM)
    assert TM.merge_snapshots([a, b]) == JM.merge_snapshots([a, b])
    assert TM.merge_snapshots([a, b])["counters"]["requests_total"] == 2.0


def _trace(mod, path, pid, name):
    rec = mod.TraceRecorder(process_id=pid, process_name=name)
    with rec.span("step", cat="train", step=1):
        rec.instant("fault", cat="elastic", kind="device_loss")
    rec.save(str(path))
    return json.loads(path.read_text())


def test_traces_validate_and_merge_into_one_timeline(tmp_path):
    port = _trace(TT, tmp_path / "worker0.inc0.trace.json", 0, "port")
    ref = _trace(JT, tmp_path / "worker1.inc0.trace.json", 1, "reference")
    for obj in (port, ref):
        assert TT.validate_chrome_trace(obj) == []
        assert JT.validate_chrome_trace(obj) == []
    paths = [str(tmp_path / "worker0.inc0.trace.json"), str(tmp_path / "worker1.inc0.trace.json")]
    merged = TT.merge_traces(paths, str(tmp_path / "pod.trace.json"))
    assert JT.validate_chrome_trace(merged) == []
    pids = {e["pid"] for e in merged["traceEvents"] if e.get("ph") in ("X", "i")}
    assert len(pids) == 2
    ref_merged = JT.merge_traces(paths)
    strip = lambda m: sorted((e["name"], e["ph"], e["pid"]) for e in m["traceEvents"])  # noqa: E731
    assert strip(merged) == strip(ref_merged)


def test_elastic_recovery_reaches_the_trace_and_the_registry(tmp_path):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.parallel import (ChaosInjector, ElasticTrainer, FaultSchedule)

    conf = (NeuralNetConfiguration.builder().seed(5)
            .layer(Dense(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(16, 4)).astype(np.float32),
                 np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)])

    class Plain:
        def __init__(self, n):
            self.net = n

        def fit_batch(self, d):
            return self.net.fit_batch(d)

    before = TM.get_registry().counter("elastic_restarts_total").value()
    rec = TT.enable_tracing()
    try:
        inj = ChaosInjector(Plain(net), FaultSchedule.scripted({2: "device_loss"}))
        et = ElasticTrainer(inj, str(tmp_path), checkpoint_every=1)
        for _ in range(3):
            et.fit_batch(ds)
        names = {(e["name"], e["ph"]) for e in rec.events()}
    finally:
        TT.disable_tracing()
    assert {("fault", "i"), ("elastic/recovery", "X"), ("ckpt/save", "X"),
            ("ckpt/restore", "X")} <= names
    assert TM.get_registry().counter("elastic_restarts_total").value() == before + 1
    collected = TM.get_registry().snapshot()["collected"]
    mine = [v for k, v in collected.items()
            if k.startswith("elastic#") and v["run_id"] == et.run_id]
    assert len(mine) == 1 and mine[0]["total_restarts"] == 1


# -- the training loop's spans, against the reference's ---------------------------


def _nets(guard=None):
    """The reference's small MLP and the port's copy of it (config, weights
    and updater state carried across), both on the CPU."""
    import jax

    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    from deeplearning4j_tpu.nn.layers import Dense as JDense, OutputLayer as JOutput
    from deeplearning4j_tpu.nn.multilayer import (MultiLayerNetwork as JNet,
                                                  NeuralNetConfiguration as JBuilder)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    jconf = (JBuilder.builder().seed(5)
             .layer(JDense(n_out=8, activation="relu"))
             .layer(JOutput(n_out=2, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JNet(jconf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf.to_dict()), device="cpu")
    net.init()
    as_np = lambda tree: [jax.tree_util.tree_map(np.asarray, t) for t in tree]  # noqa: E731
    net.params = params_from_numpy(as_np(jnet.params), device="cpu")
    net.opt_state = params_from_numpy(as_np(jnet.opt_state), device="cpu")
    if guard is not None:
        jnet.set_nan_guard(guard)
        net.set_nan_guard(guard)
    return jnet, net


def _xy(n=32):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def _train_tree(tree):
    """(name, args, children) of every ``train`` span, recursively."""
    return [(n["name"], n["event"].get("args"), _train_tree(n["children"]))
            for n in tree if n["event"].get("cat") == "train"]


def _traced(mod, step):
    """Run ``step()`` and read its loss with ``mod``'s tracing on → (the
    train spans' tree, the loss read)."""
    rec = mod.enable_tracing()
    try:
        loss = float(step())
        events = rec.export()
    finally:
        mod.disable_tracing()
    assert mod.validate_chrome_trace(events) == []
    return _train_tree(mod.span_tree(events)), loss


def _leaves(net):
    return [t.numpy().copy() for layer in net.params for _, t in sorted(layer.items())]


@pytest.mark.parametrize("guard", [None, 3])
def test_fit_batch_span_tree_is_the_references(guard):
    """``fit_batch``, plain and nan-guarded, opens the reference's spans:
    train/step (the iteration after the step; guarded=True on the guarded
    path) over train/h2d and train/dispatch, then train/device_sync on
    the loss's read."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    jnet, net = _nets(guard)
    x, y = _xy()
    ref, ref_loss = _traced(JT, lambda: jnet.fit_batch(JDataSet(x, y)))
    port, port_loss = _traced(TT, lambda: net.fit_batch(DataSet(x, y)))
    assert port == ref
    args = {"iteration": 1, "guarded": True} if guard else {"iteration": 1}
    assert port == [("train/step", args, [("train/h2d", None, []),
                                          ("train/dispatch", None, [])]),
                    ("train/device_sync", None, [])]
    np.testing.assert_allclose(port_loss, ref_loss, rtol=0, atol=1e-6)


def test_tracing_never_changes_the_step():
    """A traced step's loss and parameters are bitwise the untraced one's,
    and with tracing off nothing is recorded."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    x, y = _xy()
    TT.disable_tracing()
    _, off = _nets()
    l_off = float(off.fit_batch(DataSet(x, y)))
    assert TT.get_recorder() is None
    _, on = _nets()
    tree, l_on = _traced(TT, lambda: on.fit_batch(DataSet(x, y)))
    assert tree and l_on == l_off
    for a, b in zip(_leaves(on), _leaves(off)):
        np.testing.assert_array_equal(a, b)


def test_compressed_step_span_tree_is_the_references():
    """``ShardedTrainer``'s compressed step on one rank: train/step
    (path="compressed_exchange") over train/dispatch, as the reference's;
    tracing changes no bit of it."""
    import jax

    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.parallel import ShardedTrainer as JTrainer
    from deeplearning4j_tpu.parallel.mesh import build_two_tier_mesh as j_two_tier
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh

    jnet, net = _nets()
    x, y = _xy()
    jtr = JTrainer(jnet, j_two_tier(1, {"data": 1}, devices=jax.devices()[:1]),
                   grad_compression="threshold")
    ref, ref_loss = _traced(JT, lambda: jtr.fit_batch(JDataSet(x, y)))
    tr = ShardedTrainer(net, build_two_tier_mesh(1), grad_compression="threshold")
    port, port_loss = _traced(TT, lambda: tr.fit_batch(DataSet(x, y)))
    assert port == ref == [
        ("train/step", {"iteration": 1, "path": "compressed_exchange"},
         [("train/dispatch", None, [])]),
        ("train/device_sync", None, [])]
    np.testing.assert_allclose(port_loss, ref_loss, rtol=0, atol=1e-6)
    _, plain = _nets()
    off = ShardedTrainer(plain, build_two_tier_mesh(1), grad_compression="threshold")
    assert float(off.fit_batch(DataSet(x, y))) == port_loss
    for a, b in zip(_leaves(net), _leaves(plain)):
        np.testing.assert_array_equal(a, b)


def test_materialize_scores_is_one_device_sync_span():
    """The epoch's batched read opens one train/device_sync with
    ``n_scores``, as the reference's ``materialize_scores`` does."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.optimize.score import LazyScore as JScore, materialize_scores as jmat
    from deeplearning4j_tpu_torch.optimize.score import LazyScore, materialize_scores

    import torch

    trees = []
    for mod, mat, score in ((JT, jmat, lambda v: JScore(jnp.float32(v))),
                            (TT, materialize_scores, lambda v: LazyScore(torch.tensor(v)))):
        scores = [score(1.5), score(2.5), score(3.5)]
        rec = mod.enable_tracing()
        try:
            mat(scores)
            mat(scores)                        # nothing left to read: no span
            trees.append(_train_tree(mod.span_tree(rec.export())))
        finally:
            mod.disable_tracing()
        assert [float(s) for s in scores] == [1.5, 2.5, 3.5]
    assert trees[1] == trees[0] == [("train/device_sync", {"n_scores": 3}, [])]


def test_jit_apply_emits_the_train_update_span():
    """The port's ``update_kernel.jit_apply``: each call under
    train/update, the result the updater's own apply, ``run.jitted`` the
    plain callable."""
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.ops import update_kernel

    upd = Adam(lr=1e-3)
    g = torch.Generator().manual_seed(0)
    params = {"W": torch.randn(16, 16, generator=g), "b": torch.randn(16, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    state = upd.init_state(params)
    it = torch.tensor(0.0)
    run = update_kernel.jit_apply(upd)
    rec = TT.enable_tracing()
    try:
        p, s = run(params, grads, state, it)
        tree = _train_tree(TT.span_tree(rec.export()))
    finally:
        TT.disable_tracing()
    assert tree == [("train/update", None, [])]
    want_p, _ = run.jitted(params, grads, state, it)
    for k in params:
        torch.testing.assert_close(p[k], want_p[k], rtol=0, atol=0)
