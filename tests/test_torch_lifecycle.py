"""The port's promotion flywheel (``serving/lifecycle.py``) against the
reference on the CPU: the reference's journal, gate and pipeline cases
over the port's registry and fleet with scriptable hosts, the provenance
helpers on the same arrays and on weights carried across packages
(``weights_sha`` equal to the reference's digest, ``data_fingerprint``
equal, ``EvalGate`` scores within 1e-6), and the parts the reference's
fakes skip: a warm bundle built at REGISTER and hit by a real ``Engine``,
a resume that reloads the journaled checkpoint, the ``pipeline/*`` spans
and the ``lifecycle`` collector."""

import math
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.parallel.elastic import CheckpointManager, ElasticTrainer
from deeplearning4j_tpu_torch.serving import (Engine, EvalGate, FleetRouter, ModelRegistry,
                                              PipelineJournal, PromotionPipeline,
                                              StageDeadlineError, data_fingerprint,
                                              weights_sha)


def _mlp(seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.05))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _toy_data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(features=x, labels=y)


class _Host:
    """A scriptable fleet host."""

    def __init__(self, tag="m:v1"):
        self.tag = tag
        self.swap_exc = None
        self.swaps = []

    def output_async(self, x, slo_ms=None):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(self.tag)
        return fut

    def swap_model(self, model, tag=None, warm_bundle=None):
        if self.swap_exc is not None:
            exc, self.swap_exc = self.swap_exc, None
            raise exc
        self.swaps.append(tag)
        self.tag = tag

    @property
    def current_tag(self):
        return self.tag

    def metrics_snapshot(self):
        return {"queue_depth": 0}

    def shutdown(self):
        pass


def _fleet(n=2, tag="m:v1"):
    router = FleetRouter(start_watchdog=False)
    hosts = []
    for i in range(n):
        h = _Host(tag=tag)
        hosts.append(h)
        router.add_host(f"h{i}", engine=h)
    return router, hosts


class _Model:
    """A cheap model with params distinguishable per version."""

    def __init__(self, v):
        self.v = v
        self.params = {"w": np.full((2, 2), float(v), np.float32)}


class _Calc:
    minimize_score = False

    def __init__(self, score=0.9):
        self.score = score

    def calculate_score(self, model):
        return self.score


def _pipeline(reg, fleet, train_fn, tmp_path, calc=None, **kw):
    kw.setdefault("build_warm_bundle", False)
    kw.setdefault("journal_path", str(tmp_path / "pipeline.jsonl"))
    return PromotionPipeline(reg, fleet, "m", train_fn,
                             EvalGate(calc or _Calc(0.9), threshold=0.5), **kw)


# -- journal, gate, provenance --------------------------------------------------------


def test_journal_replay_drops_a_torn_final_line(tmp_path):
    j = PipelineJournal(str(tmp_path / "j.jsonl"))
    j.append({"gen": 1, "stage": "TRAIN", "status": "done"})
    j.append({"gen": 1, "stage": "EVAL", "status": "done"})
    with open(j.path, "a") as f:
        f.write('{"gen": 1, "stage": "REGI')
    assert [r["stage"] for r in j.replay()] == ["TRAIN", "EVAL"]
    assert PipelineJournal(str(tmp_path / "absent.jsonl")).replay() == []


def test_journal_lines_are_the_references(tmp_path):
    from deeplearning4j_tpu.serving.lifecycle import PipelineJournal as JJournal

    rec = {"gen": 2, "stage": "REGISTER", "status": "done", "version": 3, "weights_sha": "ab"}
    PipelineJournal(str(tmp_path / "t.jsonl")).append(rec)
    JJournal(str(tmp_path / "j.jsonl")).append(rec)
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert JJournal(str(tmp_path / "t.jsonl")).replay() == [rec]


def test_eval_gate_direction_and_nonfinite_scores():
    assert EvalGate(_Calc(0.8), threshold=0.5).check(None)["passed"]
    assert not EvalGate(_Calc(0.4), threshold=0.5).check(None)["passed"]

    class Loss:
        minimize_score = True

        def calculate_score(self, model):
            return 0.3
    down = EvalGate(Loss(), threshold=0.5)
    assert down.minimize and down.check(None)["passed"]
    verdict = EvalGate(_Calc(float("nan")), threshold=0.5).check(None)
    assert not verdict["passed"] and "non-finite" in verdict["reason"]
    assert math.isnan(verdict["score"])


def test_weights_sha_and_data_fingerprint_are_the_references():
    from deeplearning4j_tpu.serving import data_fingerprint as jfp
    from deeplearning4j_tpu.serving import weights_sha as jsha

    a, b = _Model(1), _Model(1)
    assert weights_sha(a) == weights_sha(b) == jsha(a)
    assert weights_sha(a) != weights_sha(_Model(2))
    ds = _toy_data()
    assert data_fingerprint(ds) == jfp(ds) == data_fingerprint(ds)
    assert data_fingerprint(ds) != data_fingerprint(_toy_data(seed=1))
    assert data_fingerprint(ds.features) == jfp(ds.features) != data_fingerprint(ds)
    nested = {"b": [np.ones(3, np.int32), None, (np.zeros(1),)], "a": {"x": np.arange(2.0)}}

    class Nested:
        params = nested
    assert weights_sha(Nested()) == jsha(Nested())


def _carried():
    """The same MLP in both packages, the reference's weights carried to
    the port."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration as TConf
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    d = _mlp().conf.to_dict()
    j = JNet(JConf.from_dict(d))
    j.init()
    t = MultiLayerNetwork(TConf.from_dict(d), device="cpu")
    t.init()
    t.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j.params), device="cpu")
    return t, j


def test_carried_weights_hash_and_score_as_the_reference():
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.earlystopping import DataSetLossCalculator as JLoss
    from deeplearning4j_tpu.serving import EvalGate as JGate
    from deeplearning4j_tpu.serving import weights_sha as jsha
    from deeplearning4j_tpu_torch.earlystopping import DataSetLossCalculator

    t, j = _carried()
    assert weights_sha(t) == jsha(j)
    before = weights_sha(t)
    t.params = [{k: v.to(torch.bfloat16) for k, v in p.items()} for p in t.params]
    j.params = jax.tree_util.tree_map(lambda a: a.astype(jax.numpy.bfloat16), j.params)
    assert weights_sha(t) == jsha(j) != before
    t, j = _carried()
    ds = _toy_data(48, seed=3)
    got = EvalGate(DataSetLossCalculator(ds), threshold=3.0).check(t)
    want = JGate(JLoss(JDataSet(ds.features, ds.labels)), threshold=3.0).check(j)
    assert got["passed"] == want["passed"]
    assert abs(got["score"] - want["score"]) <= 1e-6


# -- the pipeline ----------------------------------------------------------------------


def test_happy_path_promotes_through_the_fleet_and_chains_lineage(tmp_path):
    reg = ModelRegistry(device="cpu")
    router, _ = _fleet(n=2, tag="")
    pipe = _pipeline(reg, router, lambda g: _Model(g), tmp_path, data_slice=_toy_data())
    rep = pipe.run_generation()
    assert rep["outcome"] == "PROMOTED"
    v = rep["version"]
    assert reg.resolve("m", "prod")[0] == v and router.current_tag == f"m:v{v}"
    rec = reg.lineage("m", v)
    assert rec["eval_passed"] and rec["weights_sha"] == weights_sha(_Model(1))
    assert rec["data_fingerprint"] == data_fingerprint(_toy_data())
    assert rec["parent_version"] is None
    rep2 = pipe.run_generation()
    assert rep2["outcome"] == "PROMOTED"
    assert reg.lineage("m", rep2["version"])["parent_version"] == v
    router.shutdown()


def test_eval_failure_registers_an_audit_record_and_rolls_back(tmp_path):
    reg = ModelRegistry(device="cpu")
    router, _ = _fleet(n=2, tag="")
    calc = _Calc(0.9)
    pipe = _pipeline(reg, router, lambda g: _Model(g), tmp_path, calc=calc)
    good = pipe.run_generation()
    calc.score = 0.1
    bad = pipe.run_generation()
    assert bad["outcome"] == "ROLLED_BACK" and bad["rolled_back_to"] == good["version"]
    assert reg.lineage("m", bad["version"])["eval_passed"] is False
    assert reg.rollback_target("m") == good["version"]
    assert reg.resolve("m", "prod")[0] == good["version"]
    assert router.current_tag == f"m:v{good['version']}"
    router.shutdown()


def test_canary_rejection_rolls_the_alias_back(tmp_path):
    reg = ModelRegistry(device="cpu")
    votes = []

    def canary_cb(v, m, **kw):
        vote = {"promote": len(votes) == 0, "reasons": ["regressed p99"]}
        votes.append(vote)
        return vote
    reg.subscribe("m", "prod", lambda v, m: None, canary=canary_cb)
    pipe = _pipeline(reg, None, lambda g: _Model(g), tmp_path, canary_frac=0.5)
    pipe.run_generation()
    g2 = pipe.run_generation()
    assert g2["outcome"] == "PROMOTED"
    g3 = pipe.run_generation()
    assert g3["outcome"] == "ROLLED_BACK" and "canary rejected" in g3["reason"]
    assert g3["rolled_back_to"] == g2["version"] == reg.resolve("m", "prod")[0]
    assert g3["canary"]["promoted"] is False
    assert pipe.stats()["rolled_back"] == 1


def test_mid_roll_host_death_rolls_back_to_the_lineage_target(tmp_path):
    reg = ModelRegistry(device="cpu")
    router, hosts = _fleet(n=3, tag="")
    pipe = _pipeline(reg, router, lambda g: _Model(g), tmp_path, stage_retries=0)
    good = pipe.run_generation()
    hosts[1].swap_exc = RuntimeError("host killed mid-roll")
    bad = pipe.run_generation()
    assert bad["outcome"] == "ROLLED_BACK" and "rolling swap failed" in bad["reason"]
    assert bad["rolled_back_to"] == good["version"] == reg.resolve("m", "prod")[0]
    assert router.current_tag == f"m:v{good['version']}"
    assert router.hosts()["h1"] == "down"
    router.shutdown()


def test_stage_retries_are_bounded_and_counted(tmp_path):
    from deeplearning4j_tpu_torch.obs.metrics import get_registry

    retries = get_registry().counter("pipeline_stage_retries_total")
    before = retries.value()
    reg = ModelRegistry(device="cpu")
    attempts = []

    def flaky(g):
        attempts.append(g)
        if len(attempts) < 3:
            raise OSError("preempted")
        return _Model(g)
    rep = _pipeline(reg, None, flaky, tmp_path, stage_retries={"TRAIN": 2}).run_generation()
    assert rep["outcome"] == "PROMOTED" and len(attempts) == 3
    assert retries.value() - before == 2
    attempts.clear()

    def dead(g):
        attempts.append(g)
        raise OSError("gone")
    rep2 = _pipeline(reg, None, dead, tmp_path, journal_path=str(tmp_path / "j2.jsonl"),
                     stage_retries={"TRAIN": 1}).run_generation()
    assert rep2["outcome"] == "ROLLED_BACK" and len(attempts) == 2 and "TRAIN" in rep2["reason"]


def test_stage_deadline_on_the_injected_clock(tmp_path):
    reg = ModelRegistry(device="cpu")
    t = [0.0]

    def slow(g):
        t[0] += 99.0
        return _Model(g)
    pipe = _pipeline(reg, None, slow, tmp_path, clock=lambda: t[0], stage_retries=0,
                     stage_deadline_s={"TRAIN": 5.0})
    rep = pipe.run_generation()
    assert rep["outcome"] == "ROLLED_BACK" and "deadline" in rep["reason"]
    assert issubclass(StageDeadlineError, Exception)


def test_controller_crash_resumes_from_the_journal(tmp_path):
    reg = ModelRegistry(device="cpu")
    trained = []

    def train_fn(g):
        trained.append(g)
        return _Model(g)

    class _Crash(Exception):
        pass
    boom = {"armed": True}

    def crash_at_canary(stage, gen):
        if stage == "CANARY" and gen == 2 and boom["armed"]:
            boom["armed"] = False
            raise _Crash("controller killed")
    pipe = _pipeline(reg, None, train_fn, tmp_path, stage_hook=crash_at_canary)
    pipe.run_generation()
    with pytest.raises(_Crash):
        pipe.run_generation()
    assert trained == [1, 2]
    pipe2 = _pipeline(reg, None, train_fn, tmp_path)
    assert pipe2.resume()["partial"] == 2
    rep = pipe2.run_generation()
    assert rep["gen"] == 2 and rep["outcome"] == "PROMOTED"
    assert trained == [1, 2] and len(reg.versions("m")) == 2
    assert pipe2.stats()["resumes"] == 1


def test_run_counts_journaled_generations(tmp_path):
    reg = ModelRegistry(device="cpu")
    reports = _pipeline(reg, None, lambda g: _Model(g), tmp_path).run(generations=3)
    assert [r["gen"] for r in reports] == [1, 2, 3]
    assert len(_pipeline(reg, None, lambda g: _Model(g), tmp_path).run(generations=3)) == 3
    assert len(reg.versions("m")) == 3


def test_an_elastic_trainer_result_stamps_lineage_and_provenance(tmp_path):
    reg = ModelRegistry(device="cpu")

    def train_fn(g):
        tr = ElasticTrainer(_mlp(g), checkpoint_dir=str(tmp_path / f"g{g}"),
                            checkpoint_every=2, run_id=f"run-{g}")
        tr.fit(_toy_data(), epochs=1)
        return tr
    rep = _pipeline(reg, None, train_fn, tmp_path).run_generation()
    assert rep["outcome"] == "PROMOTED"
    rec = reg.lineage("m", rep["version"])
    assert rec["run_id"] == "run-1" and os.path.exists(rec["checkpoint_path"])
    assert reg.checkpoint_path("m", rep["version"]) == rec["checkpoint_path"]
    assert CheckpointManager(str(tmp_path / "g1")).registered_version(
        rec["checkpoint_path"]) == ("m", rep["version"])


def test_register_builds_a_warm_bundle_a_host_swaps_with(tmp_path):
    """REGISTER writes ``<checkpoint>.warm`` naming the (bucket, dtype)
    graphs; the fleet's rolling swap passes it to a real ``Engine``, which
    counts a hit for every pair and no miss."""
    from deeplearning4j_tpu_torch.serving import warmcache

    reg = ModelRegistry(device="cpu")
    kw = dict(max_batch=4, replicas=1, slo_ms=30_000.0, device="cpu")

    def train_fn(g):
        tr = ElasticTrainer(_mlp(g), checkpoint_dir=str(tmp_path / f"g{g}"),
                            checkpoint_every=2, run_id=f"run-{g}")
        tr.fit(_toy_data(), epochs=1)
        return tr
    host = Engine(_mlp(1), **kw).load()
    router = FleetRouter([], start_watchdog=False)
    router.add_host("h0", engine=host)
    try:
        pipe = _pipeline(reg, router, train_fn, tmp_path, build_warm_bundle=True,
                         bundle_engine_kwargs=kw)
        rep = pipe.run_generation()
        assert rep["outcome"] == "PROMOTED"
        ckpt = reg.checkpoint_path("m", rep["version"])
        bundle = warmcache.bundle_path_for(ckpt)
        assert os.path.exists(bundle) and len(warmcache.load_bundle(bundle, device="cpu")) == 3
        assert host.current_tag == f"m:v{rep['version']}"
        c = host.metrics_snapshot()["counters"]
        assert c["bundle_hits"] == 3 and c["bundle_misses"] == 3   # the first load had none
    finally:
        router.shutdown(shutdown_hosts=True)


def test_a_fresh_controller_reloads_the_journaled_checkpoint(tmp_path):
    """A new process (a new registry) resuming after REGISTER reloads the
    candidate from its journaled checkpoint onto the registry's device."""
    trained = []

    def train_fn(g):
        trained.append(g)
        tr = ElasticTrainer(_mlp(g), checkpoint_dir=str(tmp_path / f"g{g}"),
                            checkpoint_every=2, run_id=f"run-{g}")
        tr.fit(_toy_data(), epochs=1)
        return tr

    class _Crash(Exception):
        pass

    def crash(stage, gen):
        if stage == "CANARY":
            raise _Crash()
    with pytest.raises(_Crash):
        _pipeline(ModelRegistry(device="cpu"), None, train_fn, tmp_path,
                  stage_hook=crash).run_generation()
    reg2 = ModelRegistry(device="cpu")
    pipe = _pipeline(reg2, None, train_fn, tmp_path)
    rep = pipe.run_generation()
    assert rep["outcome"] == "PROMOTED" and trained == [1]
    model = reg2.resolve("m", "prod")[1]
    assert isinstance(model, MultiLayerNetwork) and model.device.type == "cpu"


def test_spans_and_the_lifecycle_collector(tmp_path):
    from deeplearning4j_tpu_torch.obs import trace as obs_trace
    from deeplearning4j_tpu_torch.obs.metrics import get_registry

    rec = obs_trace.enable_tracing()
    try:
        reg = ModelRegistry(device="cpu")
        pipe = _pipeline(reg, None, lambda g: _Model(g), tmp_path)
        pipe.run(generations=2)
        names = [e["name"] for e in rec.events()]
    finally:
        obs_trace.disable_tracing()
    assert names.count("pipeline/generation") == 2 and names.count("pipeline/promoted") == 2
    assert names.count("pipeline/stage") == 2 * 4     # TRAIN EVAL REGISTER CANARY
    collected = get_registry().snapshot()["collected"]
    mine = [v for k, v in collected.items() if k.startswith("lifecycle")
            and isinstance(v, dict) and v.get("promoted") == 2]
    assert mine and mine[-1]["generations_done"] == 2
