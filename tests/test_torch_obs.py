"""The port's observability copies (``deeplearning4j_tpu_torch/obs``)
against the JAX package's ``obs`` on the CPU: the same registry
operations give the reference's snapshot dict, snapshots from both merge
into one pod view, and a port trace and a reference trace pass both
validators and merge into one timeline (either package's merge).
Also: the port's ElasticTrainer records the reference's span and instant
names, and its recovery counters reach the registry.
"""

import json

import numpy as np

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
