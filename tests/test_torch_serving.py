"""The port's predict-serving stack against the JAX package's: the dynamic
batcher, the replicated ``Engine`` (warm-up, replicas, deadlines, errors,
shutdown, metrics), the versioned ``ModelRegistry`` with hot-swap, the
``/predict`` ``/generate`` ``/metrics`` ``/healthz`` routes and ``serve``
(mirroring the reference's ``tests/test_serving.py``), and the repairs
of the serving errors, ``_set_safe`` and the decode engine's health.

Weights come from the JAX package (``params_from_numpy``, or a zip it
wrote) and inputs from numpy seeds.  Tolerance: the port's Engine and
the reference's Engine serving the same model agree within 1e-6 (f32);
the port's Engine and the port's own ``output`` are bitwise on the CPU.
Everything runs on the CPU (``device="cpu"``).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.serving import Engine as JEngine
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models.transformer import (TransformerDecodeAdapter,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                    MultiLayerNetwork)
from deeplearning4j_tpu_torch.serving import (
    CanaryRejectedError, ContinuousBatcher, DeadlineExceededError, DecodeEngine,
    DynamicBatcher, Engine, ModelNotLoadedError, ModelRegistry, OverloadedError,
    PoisonInputError, ReplicaCrashError, ServingMetrics, pow2_buckets, warmcache,
)
from deeplearning4j_tpu_torch.serving.engine import _fail_safe, _set_safe
from deeplearning4j_tpu_torch.ui import UIServer
from deeplearning4j_tpu_torch.utils.params import params_from_numpy
from deeplearning4j_tpu_torch.utils.serializer import load_model

IRIS_ZIP = "deeplearning4j_tpu/models/weights/iris_mlp_iris.zip"
ENGINE_TOL = dict(atol=1e-6, rtol=0)
LM = dict(vocab_size=32, n_layers=2, d_model=32, n_heads=4, max_len=16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmlp(seed=7):
    conf = (JConf.builder().seed(seed).updater(JSgd(lr=0.05))
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(12)).build())
    net = JNet(conf)
    net.init()
    return net


def _port_of(jnet):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
                            device="cpu")
    net.params = params_from_numpy(_np(jnet.params), device="cpu")
    net.state = params_from_numpy(_np(jnet.state), device="cpu")
    net.opt_state = net.init_opt_state(net.params)
    return net


def _mlp(seed=7):
    return _port_of(_jmlp(seed))


def _out(net, x):
    return net.output(x).numpy()


def _engine(model, **kw):
    return Engine(model, device="cpu", **kw)


class _ConstModel:
    """Duck-typed model whose output identifies it: the hot-swap and
    dispatch tests read the version off the result rows."""

    def __init__(self, val, delay_s=0.0):
        self.val = float(val)
        self.delay_s = delay_s
        self.calls = 0

    def output(self, x):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.full((x.shape[0], 1), self.val, np.float32)


# -- batcher ------------------------------------------------------------------------------


class TestDynamicBatcher:
    def test_pow2_buckets(self):
        assert pow2_buckets(32) == [1, 2, 4, 8, 16, 32]
        assert pow2_buckets(24) == [1, 2, 4, 8, 16, 24]
        b = DynamicBatcher(max_batch=32)
        assert b.bucket_for(3) == 4
        assert b.bucket_for(32) == 32
        assert b.bucket_for(33) == 64  # oversized: next pow2, runs alone

    def test_split_at_max_batch_before_bucketing(self):
        b = DynamicBatcher(max_batch=32, slo_ms=5000)
        for _ in range(33):
            b.submit(np.zeros((1, 4), np.float32))
        first, second = b.next_batch(), b.next_batch()
        assert sum(r.rows for r in first) == 32
        assert sum(r.rows for r in second) == 1
        b.close()

    def test_multirow_never_overshoots(self):
        b = DynamicBatcher(max_batch=32, slo_ms=5000)
        for _ in range(11):
            b.submit(np.zeros((3, 4), np.float32))  # 33 rows total
        rows = [sum(r.rows for r in b.next_batch()) for _ in range(2)]
        assert all(r <= 32 for r in rows) and sum(rows) == 33
        b.close()

    def test_oversized_request_goes_alone(self):
        b = DynamicBatcher(max_batch=8, slo_ms=5000)
        b.submit(np.zeros((11, 2), np.float32))
        b.submit(np.zeros((1, 2), np.float32))
        first = b.next_batch()
        assert len(first) == 1 and first[0].rows == 11
        b.close()

    def test_expired_request_fails_fast(self):
        b = DynamicBatcher(max_batch=8, slo_ms=5000)
        dead = b.submit(np.zeros((1, 2), np.float32), slo_ms=1.0)
        live = b.submit(np.zeros((1, 2), np.float32), slo_ms=10_000)
        time.sleep(0.02)
        assert [r.rows for r in b.next_batch()] == [1]
        with pytest.raises(DeadlineExceededError):
            dead.result(timeout=1)
        assert not live.done()
        b.close()

    def test_deadline_slack_close_uses_bucket_ema(self):
        """A batch closes once the earliest deadline less the bucket's
        expected exec time has come, not only at max_wait."""
        now = [0.0]
        b = DynamicBatcher(max_batch=8, slo_ms=100, max_wait_ms=1e6,
                           clock=lambda: now[0])
        b.observe_exec_ms(1, 80.0)
        b.submit(np.zeros((1, 2), np.float32))
        got = []
        t = threading.Thread(target=lambda: got.append(b.next_batch()), daemon=True)
        t.start()
        time.sleep(0.1)
        assert not got                   # 100 ms deadline, 80 ms budget: waits
        now[0] = 0.021                   # past deadline − budget
        t.join(timeout=2)
        assert got and got[0][0].rows == 1
        b.close()

    def test_admission_shed_raises(self):
        m = ServingMetrics()
        b = DynamicBatcher(max_batch=8, max_queue=2, admission="shed",
                           slo_ms=5000, metrics=m)
        b.submit(np.zeros((1, 2), np.float32))
        b.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(OverloadedError):
            b.submit(np.zeros((1, 2), np.float32))
        assert m.snapshot()["counters"]["shed"] == 1
        b.close()

    def test_admission_block_waits_for_space(self):
        b = DynamicBatcher(max_batch=8, max_queue=1, admission="block",
                           slo_ms=5000)
        b.submit(np.zeros((1, 2), np.float32))
        unblocked = []

        def blocked_submit():
            b.submit(np.zeros((1, 2), np.float32), slo_ms=10_000)
            unblocked.append(True)

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not unblocked  # still blocked on the full queue
        b.next_batch()        # frees space
        t.join(timeout=2)
        assert unblocked
        b.close()

    def test_drain_sheds_new_and_keeps_queued(self):
        b = DynamicBatcher(max_batch=8, slo_ms=5000)
        queued = b.submit(np.zeros((1, 2), np.float32))
        b.begin_drain()
        assert b.draining()
        with pytest.raises(OverloadedError, match="draining"):
            b.submit(np.zeros((1, 2), np.float32))
        assert b.next_batch()[0].future is queued
        b.close()

    def test_close_fails_pending_deterministically(self):
        b = DynamicBatcher(max_batch=8, slo_ms=5000)
        fut = b.submit(np.zeros((1, 2), np.float32))
        b.close()
        with pytest.raises(RuntimeError, match="shut down"):
            fut.result(timeout=1)
        late = b.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(RuntimeError, match="shut down"):
            late.result(timeout=1)
        assert b.next_batch() is None

    def test_bad_args(self):
        with pytest.raises(ValueError, match="admission"):
            DynamicBatcher(admission="drop")
        b = DynamicBatcher()
        with pytest.raises(ValueError, match="batch axis"):
            b.submit(np.float32(3.0))
        b.close()

    def test_continuous_batcher_is_the_subclass(self):
        assert issubclass(ContinuousBatcher, DynamicBatcher)
        b = ContinuousBatcher(max_batch=2, slo_ms=5000)
        b.begin_drain()
        with pytest.raises(OverloadedError):
            b.submit_request("p")
        b.close()


# -- engine -------------------------------------------------------------------------------


class TestEngine:
    def test_batched_parity_with_direct_output(self):
        net = _mlp()
        xs = np.random.default_rng(0).normal(size=(64, 12)).astype(np.float32)
        eng = _engine(net, max_batch=16, replicas=2).load()
        try:
            futs = [eng.output_async(xs[i:i + 4]) for i in range(0, 32, 4)]
            outs = [f.result(timeout=60) for f in futs]
            assert all(o.shape == (4, 3) for o in outs)
            np.testing.assert_allclose(outs[0], _out(net, xs[:4]), rtol=2e-5, atol=1e-6)
        finally:
            eng.shutdown()

    def test_warmup_zero_serve_time_programs(self):
        """After load() every bucket-sized request is served by a prepared
        program: the count is buckets x replicas and does not grow."""
        net = _mlp()
        eng = _engine(net, max_batch=16, replicas=2).load()
        try:
            c0 = eng.compile_cache_size()
            assert c0 == len(eng.batcher.buckets) * 2
            rng = np.random.default_rng(1)
            for rows in list(range(1, 17)) * 2:
                x = rng.normal(size=(rows, 12)).astype(np.float32)
                assert eng.output(x, slo_ms=10_000).shape == (rows, 3)
            assert eng.compile_cache_size() == c0
            assert eng.metrics.snapshot()["counters"]["unwarmed_serves"] == 0
        finally:
            eng.shutdown()

    def test_oversized_request_counts_as_unwarmed(self):
        net = _mlp()
        eng = _engine(net, max_batch=4, replicas=1).load()
        try:
            x = np.zeros((5, 12), np.float32)  # > max_batch: own pow2 bucket
            assert eng.output(x, slo_ms=10_000).shape == (5, 3)
            assert eng.metrics.snapshot()["counters"]["unwarmed_serves"] == 1
        finally:
            eng.shutdown()

    def test_unwarmed_dtype_counts(self):
        net = _mlp()
        eng = _engine(net, max_batch=4, replicas=1).load()
        try:
            out = eng.output(np.zeros((2, 12), np.float64), slo_ms=10_000)
            np.testing.assert_array_equal(out, _out(net, np.zeros((2, 12), np.float32)))
            assert eng.metrics.snapshot()["counters"]["unwarmed_serves"] == 1
        finally:
            eng.shutdown()

    def test_other_feature_width_is_refused_not_broadcast(self):
        """An Iris request of [2, 1] is not the warmed [., 4]: it runs
        eagerly, so the model's own shape error fails it (no 200), as the
        reference's Engine fails it."""
        net = load_model(IRIS_ZIP, device="cpu")
        eng = _engine(net, max_batch=4, replicas=2, slo_ms=10_000).load()
        server = UIServer(port=0).attach_engine(eng).start()
        try:
            with pytest.raises(Exception):
                eng.output(np.ones((2, 1), np.float32))
            code, r = _post(f"http://127.0.0.1:{server.port}/predict",
                            json.dumps({"inputs": [[1.0], [2.0]]}).encode())
            assert code != 200 and "outputs" not in r
            x = np.ones((2, 4), np.float32)
            np.testing.assert_array_equal(eng.output(x), _out(net, x))
        finally:
            server.stop()
            eng.shutdown()
        jeng = JEngine(j_load(IRIS_ZIP), max_batch=4, replicas=1, slo_ms=10_000).load()
        try:
            with pytest.raises(Exception):
                jeng.output(np.ones((2, 1), np.float32))
        finally:
            jeng.shutdown()

    def test_shorter_lm_row_runs_eagerly_like_output(self):
        """A TransformerLM warmed at [., 16] serves a row of 8 ids eagerly:
        ``output``'s result on it, counted as unwarmed."""
        net = TransformerLM(**LM, seed=3, device="cpu")
        eng = _engine(net, max_batch=2, replicas=1, slo_ms=30_000).load(
            input_shape=(LM["max_len"],))
        try:
            x = np.random.default_rng(13).integers(
                0, LM["vocab_size"], (1, 8)).astype(np.float32)
            out = eng.output(x)
            assert out.shape == (1, 8, LM["vocab_size"])
            np.testing.assert_array_equal(out, net.output(x).numpy())
            assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 1
        finally:
            eng.shutdown()

    def test_replicas_share_the_load(self):
        eng = _engine(_ConstModel(1.0, delay_s=0.005), replicas=3,
                      max_batch=4, slo_ms=10_000, max_wait_ms=0.5)
        try:
            futs = [eng.output_async(np.zeros((1, 2), np.float32))
                    for _ in range(30)]
            for f in futs:
                f.result(timeout=30)
            used = [r.processed for r in eng._replicas]
            assert sum(used) == len(eng.batch_log)
            assert sum(1 for u in used if u > 0) >= 2  # round-robin spread
        finally:
            eng.shutdown()

    def test_deadline_exceeded_behind_slow_batch(self):
        eng = _engine(_ConstModel(1.0, delay_s=0.15), replicas=1,
                      max_batch=4, slo_ms=10_000, inflight_per_replica=1)
        try:
            first = eng.output_async(np.zeros((1, 2), np.float32))
            time.sleep(0.02)  # let the slow batch start executing
            stuck = eng.output_async(np.zeros((1, 2), np.float32), slo_ms=30)
            assert first.result(timeout=10).shape == (1, 1)
            with pytest.raises(DeadlineExceededError):
                stuck.result(timeout=10)
            assert eng.metrics.snapshot()["counters"]["deadline_missed"] == 1
        finally:
            eng.shutdown()

    def test_error_propagates_to_all_waiters(self):
        class Broken:
            def output(self, x):
                raise RuntimeError("boom")

        eng = _engine(Broken(), max_batch=8, slo_ms=10_000)
        try:
            futs = [eng.output_async(np.ones((2, 3), np.float32)) for _ in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=10)
            assert eng.metrics.snapshot()["counters"]["errors"] >= 1
        finally:
            eng.shutdown()

    def test_shutdown_concurrent_submit_never_hangs(self):
        eng = _engine(_ConstModel(1.0, delay_s=0.002), max_batch=4, slo_ms=10_000)
        futs, stop = [], threading.Event()

        def spam():
            while not stop.is_set():
                try:
                    futs.append(eng.output_async(np.zeros((1, 2), np.float32)))
                except RuntimeError:
                    break

        threads = [threading.Thread(target=spam, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        eng.shutdown()
        stop.set()
        for t in threads:
            t.join(timeout=5)
        for f in futs:
            f.exception(timeout=10)          # resolves: result or error
        assert futs and all(f.done() for f in futs)

    def test_metrics_snapshot_shape(self):
        eng = _engine(_ConstModel(2.0), max_batch=4, slo_ms=10_000)
        try:
            eng.output(np.zeros((3, 2), np.float32))
            snap = eng.metrics_snapshot()
            assert snap["counters"]["requests"] == 1
            assert snap["counters"]["rows"] == 3
            assert snap["counters"]["padded_rows"] == 1  # 3 -> bucket 4
            assert snap["batch_occupancy"] == 0.75
            assert snap["queue_wait_ms"]["count"] == 1
            assert snap["e2e_ms"]["count"] == 1
            assert snap["replicas"] == 1 and snap["compile_cache_size"] is None
            assert snap["device"] == "cpu"
        finally:
            eng.shutdown()

    def test_concurrent_clients_lose_no_update(self):
        """More client threads than cores, the interpreter switching
        threads every microsecond: every request gets its own rows back,
        and the counters, the replicas' processed counts and the version's
        active count add up (a lost read-modify-write would break one)."""
        import sys

        class RowSums:
            def output(self, x):
                return x.sum(axis=1, keepdims=True)

        eng = _engine(RowSums(), max_batch=8, replicas=3, slo_ms=60_000,
                      max_wait_ms=0.5)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            n_threads, per_thread = 16, 25
            bad, rows = [], [0] * n_threads

            def client(k):
                rng = np.random.default_rng(k)
                for _ in range(per_thread):
                    x = rng.integers(0, 100, (1 + rng.integers(0, 3), 2)).astype(np.float32)
                    rows[k] += x.shape[0]
                    out = eng.output(x)
                    if not np.array_equal(out, x.sum(axis=1, keepdims=True)):
                        bad.append(k)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        try:
            assert not bad
            c = eng.metrics_snapshot()["counters"]
            assert c["requests"] == n_threads * per_thread and c["rows"] == sum(rows)
            assert sum(r.processed for r in eng._replicas) == c["batches"] == len(eng.batch_log)
            assert eng._current.active == 0
        finally:
            eng.shutdown()

    def test_drain_sheds_while_queued_complete(self):
        eng = _engine(_ConstModel(1.0, delay_s=0.02), max_batch=1, slo_ms=10_000)
        try:
            futs = [eng.output_async(np.zeros((1, 2), np.float32)) for _ in range(3)]
            eng.begin_drain()
            with pytest.raises(OverloadedError):
                eng.output_async(np.zeros((1, 2), np.float32))
            assert all(f.result(timeout=10).shape == (1, 1) for f in futs)
            assert eng.metrics_snapshot()["counters"]["drains"] == 1
        finally:
            eng.shutdown()

    def test_runs_on_the_card_unless_told(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(_ConstModel(1.0))


# -- against the reference's Engine ---------------------------------------------------------


def _serve_both(jmodel, tmodel, xs, input_shape=None, **kw):
    """The same requests through the JAX Engine and the port's Engine."""
    jeng = JEngine(jmodel, **kw).load(input_shape=input_shape)
    teng = _engine(tmodel, **kw).load(input_shape=input_shape)
    try:
        jf = [jeng.output_async(x) for x in xs]
        tf = [teng.output_async(x) for x in xs]
        return ([np.asarray(f.result(timeout=120)) for f in jf],
                [f.result(timeout=120) for f in tf], teng.compile_cache_size(),
                teng.metrics_snapshot())
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_iris_zip_served_like_the_reference():
    jnet = j_load(IRIS_ZIP)
    tnet = load_model(IRIS_ZIP, device="cpu")
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(1 + i % 3, 4)).astype(np.float32) for i in range(12)]
    want, got, programs, snap = _serve_both(jnet, tnet, xs, max_batch=4, replicas=2,
                                            slo_ms=10_000)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **ENGINE_TOL)
    assert programs == 3 * 2 and snap["counters"]["unwarmed_serves"] == 0


def test_transformer_lm_served_like_the_reference():
    """Token ids as float32 rows [rows, max_len], as /predict sends them
    (EmbeddingSequence casts them back)."""
    jnet = JLM(**LM, seed=3)
    tnet = TransformerLM(**LM, seed=3, device="cpu")
    tnet.params = params_from_numpy(_np(jnet.params), device="cpu")
    rng = np.random.default_rng(12)
    xs = [rng.integers(0, LM["vocab_size"], (1 + i % 2, LM["max_len"])).astype(np.float32)
          for i in range(6)]
    want, got, _, snap = _serve_both(jnet, tnet, xs, input_shape=(LM["max_len"],),
                                     max_batch=2, replicas=1, slo_ms=30_000)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (a.shape[0], LM["max_len"], LM["vocab_size"])
        np.testing.assert_allclose(a, b, **ENGINE_TOL)
    assert snap["counters"]["unwarmed_serves"] == 0


def test_mixed_dtype_network_served_in_float32_rows():
    """A float32-param / bfloat16-compute MLP: the engine returns its
    bfloat16 outputs widened to float32, bitwise ``output``'s."""
    jconf = _jmlp().conf.to_dict()
    jconf["compute_dtype"] = "bfloat16"
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf), device="cpu")
    net.init()
    x = np.random.default_rng(2).normal(size=(3, 12)).astype(np.float32)
    eng = _engine(net, max_batch=4).load()
    try:
        out = eng.output(x, slo_ms=10_000)
        assert out.dtype == np.float32
        want = net.output(np.concatenate([x, np.zeros((1, 12), np.float32)]))[:3]
        assert want.dtype == torch.bfloat16
        np.testing.assert_array_equal(out, want.float().numpy())
    finally:
        eng.shutdown()


# -- registry and hot swap ------------------------------------------------------------------


class TestModelRegistry:
    def test_register_resolve_alias_rollback(self):
        reg = ModelRegistry(device="cpu")
        m1, m2 = _ConstModel(1.0), _ConstModel(2.0)
        v1 = reg.register("m", m1)
        v2 = reg.register("m", m2)
        assert (v1, v2) == (1, 2)
        assert reg.resolve("m", "latest") == (2, m2)
        assert reg.resolve("m", v1) == (1, m1)
        assert reg.resolve("m", "v2") == (2, m2)
        reg.set_alias("m", "prod", v1)
        assert reg.resolve("m", "prod") == (1, m1)
        assert reg.set_alias("m", "prod", v2) == 1     # deploy
        assert reg.resolve("m", "prod") == (2, m2)
        reg.set_alias("m", "prod", v1)                 # rollback = alias move
        assert reg.resolve("m", "prod") == (1, m1)
        assert reg.names() == ["m"] and reg.versions("m") == [1, 2]
        assert reg.aliases("m") == {"prod": 1}

    def test_versions_immutable_and_unknown_refs(self):
        reg = ModelRegistry(device="cpu")
        reg.register("m", _ConstModel(1.0))
        with pytest.raises(ValueError, match="immutable"):
            reg.register("m", _ConstModel(9.0), version=1)
        with pytest.raises(KeyError):
            reg.resolve("nope")
        with pytest.raises(KeyError, match="unknown version ref"):
            reg.resolve("m", "staging")
        with pytest.raises(KeyError):
            reg.set_alias("m", "prod", 99)

    def test_lineage_and_rollback_target(self):
        reg = ModelRegistry(device="cpu")
        reg.register("m", _ConstModel(1.0), lineage={"eval_passed": True})
        reg.register("m", _ConstModel(2.0), lineage={"eval_passed": False})
        reg.register("m", _ConstModel(3.0),
                     lineage={"parent_version": 2, "eval_passed": True, "run_id": "r3"})
        assert reg.lineage("m", 3)["run_id"] == "r3"
        assert [r["version"] for r in reg.lineage("m")] == [1, 2, 3]
        assert reg.rollback_target("m") == 1        # v2 failed its eval
        assert reg.rollback_target("m", 1) is None
        snap = reg.models_snapshot()["m"]
        assert snap["versions"] == [1, 2, 3] and snap["pinned"] is None
        assert snap["lineage"]["recorded"] == 3 and snap["lineage"]["eval_passed"] == 2

    @pytest.mark.parametrize("fmt", [1, 2, 3, 4])
    def test_loads_every_serializer_format_version(self, tmp_path, fmt):
        """Checkpoints the JAX package wrote, at every format version
        (v1-v3 derived by rewriting meta.json as old writers left it)."""
        jnet = _jmlp(seed=fmt)
        p = str(tmp_path / "m_v4.zip")
        j_save(jnet, p)
        if fmt < 4:
            p_old = str(tmp_path / f"m_v{fmt}.zip")
            with zipfile.ZipFile(p) as zin, zipfile.ZipFile(p_old, "w") as zout:
                for name in zin.namelist():
                    b = zin.read(name)
                    if name == "meta.json":
                        meta = json.loads(b)
                        del meta["integrity"]  # v1-v3 carried no digests
                        meta["format_version"] = fmt
                        b = json.dumps(meta).encode()
                    zout.writestr(name, b)
            p = p_old
        reg = ModelRegistry(device="cpu")
        v = reg.load("m", p)
        _, model = reg.resolve("m", v)
        assert reg.models_snapshot()["m"]["checkpoint_path"] == p
        x = np.random.default_rng(0).normal(size=(4, 12)).astype(np.float32)
        np.testing.assert_allclose(_out(model, x), np.asarray(jnet.output(x)),
                                   atol=1e-6, rtol=1e-5)

    def test_hot_swap_under_load_never_mixes_versions(self):
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", _ConstModel(1.0, delay_s=0.001))
        v2 = reg.register("m", _ConstModel(2.0, delay_s=0.001))
        reg.set_alias("m", "prod", v1)
        eng = Engine.from_registry(reg, "m", "prod", max_batch=8, replicas=2,
                                   slo_ms=10_000, device="cpu")
        try:
            results, stop = [], threading.Event()

            def pound():
                while not stop.is_set():
                    results.append(eng.output(np.zeros((2, 3), np.float32)))

            threads = [threading.Thread(target=pound, daemon=True) for _ in range(4)]
            for t in threads:
                t.start()
            for _ in range(4):
                reg.set_alias("m", "prod", v2)
                time.sleep(0.02)
                reg.set_alias("m", "prod", v1)
                time.sleep(0.02)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            assert len(results) > 10
            for out in results:
                vals = set(np.unique(out))
                assert len(vals) == 1, f"mixed versions within one batch: {vals}"
                assert vals <= {1.0, 2.0}
            assert {b["tag"] for b in eng.batch_log} <= {"m:v1", "m:v2"}
            assert eng.current_tag == "m:v1"
            assert eng.metrics.snapshot()["counters"]["swaps"] == 8
        finally:
            eng.shutdown()

    def test_swap_warms_new_version(self):
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", _mlp(seed=1))
        v2 = reg.register("m", _mlp(seed=2))
        reg.set_alias("m", "prod", v1)
        eng = Engine.from_registry(reg, "m", "prod", max_batch=4, replicas=1,
                                   device="cpu").load()
        try:
            x = np.random.default_rng(0).normal(size=(2, 12)).astype(np.float32)
            r1 = eng.output(x, slo_ms=10_000)
            reg.set_alias("m", "prod", v2)
            c_after_swap = eng.compile_cache_size()
            assert c_after_swap == len(eng.batcher.buckets)  # warmed on swap
            r2 = eng.output(x, slo_ms=10_000)
            assert not np.allclose(r1, r2)
            np.testing.assert_array_equal(r2, _out(reg.resolve("m", v2)[1], x))
            assert eng.compile_cache_size() == c_after_swap
            assert eng.metrics.snapshot()["counters"]["unwarmed_serves"] == 0
        finally:
            eng.shutdown()


# -- HTTP routes and serve -----------------------------------------------------------------


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body.startswith(b"{") else body)


class TestMetricsEndpoint:
    def test_metrics_predict_and_404(self):
        net = _mlp()
        eng = _engine(net, max_batch=8, replicas=1).load()
        server = UIServer(port=0).attach_engine(eng).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            code, m = _get(base + "/metrics")
            assert code == 200 and m["serving"][0]["replicas"] == 1
            code, r = _post(base + "/predict",
                            json.dumps({"inputs": [[0.0] * 12] * 2}).encode())
            assert code == 200 and len(r["outputs"]) == 2 and len(r["outputs"][0]) == 3
            assert r["model"] == "v0"
            np.testing.assert_array_equal(np.asarray(r["outputs"], np.float32),
                                          _out(net, np.zeros((2, 12), np.float32)))
            assert _get(base + "/definitely-not-a-page")[0] == 404
            code, bad = _post(base + "/predict", b"{}")
            assert code == 400 and bad["error_class"] == "bad_request"
            code, bad = _post(base + "/predict", b"{not json")
            assert code == 400 and bad["error_class"] == "bad_request"
        finally:
            server.stop()
            eng.shutdown()

    def test_generate_and_healthz_with_both_engines(self):
        lm = TransformerLM(**LM, seed=5, device="cpu")
        dec = DecodeEngine(TransformerDecodeAdapter(lm), max_slots=2, page_size=4,
                           device="cpu").load()
        eng = _engine(_mlp(), max_batch=4).load()
        server = UIServer(port=0).attach_engine(eng).attach_decode_engine(dec).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            prompt = [3, 1, 4, 1, 5]
            code, r = _post(base + "/generate", json.dumps(
                {"prompt_ids": prompt, "max_tokens": 5}).encode())
            direct = dec.generate(prompt, max_new_tokens=5)
            assert code == 200 and r["tokens"] == direct.tokens
            assert r["model"] == "v0" and r["n_prompt"] == 5
            code, bad = _post(base + "/generate", json.dumps(
                {"prompt_ids": [LM["vocab_size"] + 1]}).encode())
            assert code == 400 and bad["error_class"] == "bad_request"
            code, h = _get(base + "/healthz")
            assert code == 200 and h["ready"] is True
            assert set(h["engines"]) == {"predict", "decode"}
            assert h["engines"]["decode"]["ready"] and h["engines"]["predict"]["ready"]
            code, m = _get(base + "/metrics")
            assert code == 200 and len(m["serving"]) == 2
            assert "unwarmed_serves" in m["serving"][0]["counters"]
            assert m["serving"][1]["counters"]["tokens_out"] >= 10
            dec.shutdown()
            code, h = _get(base + "/healthz")
            assert code == 503 and h["engines"]["decode"]["ready"] is False
        finally:
            server.stop()
            eng.shutdown()
            dec.shutdown()

    def test_routes_without_engines_answer_503(self):
        server = UIServer(port=0).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            assert _post(base + "/predict", b"{}")[1]["error_class"] == "unavailable"
            assert _post(base + "/generate", b"{}")[0] == 503
            code, h = _get(base + "/healthz")
            assert code == 503 and h["ready"] is False
        finally:
            server.stop()


class TestCliServe:
    def test_smoke_serves_and_prints_metrics(self, tmp_path, capsys):
        p = str(tmp_path / "m.zip")
        j_save(_jmlp(), p)
        rc = cli.main(["serve", "--model", p, "--smoke", "6", "--replicas", "1",
                       "--max-batch", "4", "--device", "cpu"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "alias 'prod'" in out
        snap = json.loads(out.strip().splitlines()[-1])
        assert snap["counters"]["requests"] == 6
        assert snap["counters"]["unwarmed_serves"] == 0
        assert snap["compile_cache_size"] == 3  # buckets 1,2,4 x 1 replica

    def test_smoke_refuses_a_transformer_lm(self, tmp_path):
        p = str(tmp_path / "lm.zip")
        j_save(JLM(**LM), p)
        with pytest.raises(SystemExit, match="transformer LM"):
            cli.main(["serve", "--model", p, "--smoke", "2", "--device", "cpu"])

    def test_parser_flags(self):
        args = cli.build_parser().parse_args(
            ["serve", "--model", "m.zip", "--max-batch", "64", "--slo-ms", "25",
             "--replicas", "2", "--admission", "block", "--forward-timeout", "0.5",
             "--max-retries", "2", "--breaker-threshold", "4", "--queue-cap", "9",
             "--prefix-cache", "--kv-dtype", "int8"])
        assert args.fn.__name__ == "cmd_serve"
        assert (args.max_batch, args.slo_ms, args.replicas, args.admission,
                args.forward_timeout, args.max_retries, args.breaker_threshold,
                args.queue_cap, args.prefix_cache, args.kv_dtype, args.device) == (
            64, 25.0, 2, "block", 0.5, 2, 4, 9, True, "int8", "cuda")


# -- the repairs --------------------------------------------------------------------------


def test_poison_input_error_is_a_runtime_error_not_a_value_error():
    """The reference's class: a caller catching RuntimeError catches it,
    and /predict's ValueError → 400 branch never swallows it."""
    assert issubclass(PoisonInputError, RuntimeError)
    assert not issubclass(PoisonInputError, ValueError)
    with pytest.raises(RuntimeError):
        raise PoisonInputError("x")


def test_set_safe_reports_whether_it_resolved_and_the_guard_is_narrow():
    f = Future()
    assert _set_safe(f, 1) is True
    _fail_safe(f, RuntimeError("late"))       # race: swallowed
    assert _set_safe(f, 2) is False           # race: swallowed
    assert f.result() == 1

    class ExplodingFuture(Future):
        def done(self):
            return False

        def set_result(self, v):
            raise TypeError("not a race — must propagate")

        def set_exception(self, e):
            raise TypeError("not a race — must propagate")

    with pytest.raises(TypeError):
        _set_safe(ExplodingFuture(), 3)
    with pytest.raises(TypeError):
        _fail_safe(ExplodingFuture(), RuntimeError("x"))


def test_decode_engine_health_drain_and_tag():
    lm = TransformerLM(**LM, seed=6, device="cpu")
    dec = DecodeEngine(TransformerDecodeAdapter(lm), max_slots=2, page_size=4,
                       tag="lm:v3", device="cpu")
    assert dec.health_snapshot() == {"status": "unready", "ready": False,
                                     "kind": "decode", "model": "lm:v3"}
    dec.load()
    try:
        assert dec.health_snapshot()["ready"] and dec.current_tag == "lm:v3"
        res = dec.generate([1, 2, 3], max_new_tokens=3)
        assert res.model_tag == "lm:v3"
        assert dec.metrics_snapshot()["model"] == "lm:v3"
        queued = dec.generate_async([2, 3], max_new_tokens=2)
        dec.begin_drain()
        with pytest.raises(OverloadedError, match="draining"):
            dec.generate_async([1], max_new_tokens=1)
        assert len(queued.result(timeout=60).tokens) == 2
        assert dec.metrics.counter("drains") == 1
    finally:
        dec.shutdown()
    assert dec.health_snapshot()["ready"] is False


def test_replica_crash_error_is_shared_with_the_decode_engine():
    from deeplearning4j_tpu_torch.serving import decode, engine
    assert decode.ReplicaCrashError is engine.ReplicaCrashError is ReplicaCrashError


# -- ParallelInference (parallel/inference.py) ---------------------------------------------


def test_parallel_inference_shim_matches_the_reference():
    """The back-compatible shim: the same weights answer the reference's
    ``ParallelInference`` within 1e-6 in request order (any leading batch
    size), concurrent requests fuse, a model error reaches the waiter, and
    ``shutdown`` fails a late request in both packages."""
    from deeplearning4j_tpu.parallel import ParallelInference as JPI
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    jnet = _jmlp()
    pi = ParallelInference(_port_of(jnet), max_batch=8, bucket_sizes=[1, 2, 4, 8],
                           device="cpu")
    jpi = JPI(jnet, max_batch=8, bucket_sizes=[1, 2, 4, 8])
    assert pi.buckets == jpi.buckets == [1, 2, 4, 8]
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(1 + i % 5, 12)).astype(np.float32) for i in range(10)]
    futs = [pi.output_async(x) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(timeout=30), jpi.output(x), rtol=0, atol=1e-6)
    big = rng.normal(size=(11, 12)).astype(np.float32)     # past max_batch
    np.testing.assert_allclose(pi.output(big), jpi.output(big), rtol=0, atol=1e-6)
    for shim in (pi, jpi):
        shim.shutdown()
        with pytest.raises(RuntimeError):
            shim.output_async(xs[0]).result(timeout=10)


def test_parallel_inference_propagates_model_errors():
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    class Broken:
        def output(self, x):
            raise ValueError("bad model")

    pi = ParallelInference(Broken(), max_batch=4, device="cpu")
    try:
        with pytest.raises(ValueError, match="bad model"):
            pi.output(np.zeros((2, 3), np.float32))
    finally:
        pi.shutdown()


# -- F1: the fixed-bucket latency histograms and the unified registry ------------------------


def test_latency_snapshots_are_the_references_on_the_same_samples():
    """1,000 lognormal(3, 0.7) samples (numpy seed 0) into the port's and
    the reference's ``LatencyHistogram``: equal snapshot dicts (fixed
    buckets, interpolated percentiles, 3 decimals), and equal empty ones."""
    from deeplearning4j_tpu.serving.metrics import LatencyHistogram as JHist
    from deeplearning4j_tpu_torch.serving import LatencyHistogram

    samples = np.random.default_rng(0).lognormal(3.0, 0.7, 1000)
    port, ref = LatencyHistogram(), JHist()
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["max_ms"] == 0.0
    for v in samples:
        port.record(float(v))
        ref.record(float(v))
    got, want = port.snapshot(), ref.snapshot()
    assert got == want
    assert got["buckets_ms"] and sum(got["counts"]) == 1000
    assert (port.count, port.sum_ms, port.max_ms) == (ref.count, ref.sum_ms, ref.max_ms)


def test_metric_sets_register_with_the_process_registry_and_match_the_reference_keys():
    from deeplearning4j_tpu.serving.metrics import ServingMetrics as JServing
    from deeplearning4j_tpu_torch.obs.metrics import get_registry
    from deeplearning4j_tpu_torch.serving import DecodeMetrics

    m, d = ServingMetrics(), DecodeMetrics()
    collected = get_registry().snapshot()["collected"]
    assert m.global_name.startswith("serving#") and m.global_name in collected
    assert d.global_name.startswith("decode#") and d.global_name in collected
    assert set(m.snapshot()["counters"]) == set(JServing().snapshot()["counters"])
    m.inc("shed", tenant="gold")
    assert m.counter_value("shed") == 1 and m.counter_value("shed", tenant="gold") == 1
    assert m.registry.snapshot()["counters"]["shed{tenant=gold}"] == 1
    for snap in (m.snapshot(), d.snapshot()):
        for k, h in snap.items():
            if k.endswith("_ms") and isinstance(h, dict):
                assert "buckets_ms" in h and "counts" in h, k


def test_metrics_endpoint_carries_the_registry():
    eng = _engine(_mlp(), max_batch=4).load()
    server = UIServer(port=0).attach_engine(eng).start()
    try:
        eng.output(np.zeros((2, 12), np.float32))
        code, m = _get(f"http://127.0.0.1:{server.port}/metrics")
        assert code == 200 and "registry" in m
        mine = m["registry"]["collected"][eng.metrics.global_name]
        assert mine["counters"]["requests"] == 1
        for h in ("queue_wait_ms", "device_time_ms", "e2e_ms"):
            assert "buckets_ms" in m["serving"][0][h] and "counts" in m["serving"][0][h]
            assert sum(mine[h]["counts"]) == mine[h]["count"]
    finally:
        server.stop()
        eng.shutdown()


# -- named models -----------------------------------------------------------------------------


class _Conf3:
    class input_type:                                   # noqa: N801
        @staticmethod
        def batch_shape(n):
            return (n, 3)


class _Const3(_ConstModel):
    """A constant model whose conf gives ``add_model`` its shape (3,)."""

    conf = _Conf3()


def _three_models():
    reg = ModelRegistry(device="cpu")
    for name, val in (("m1", 1.0), ("m2", 2.0), ("m3", 3.0)):
        reg.set_alias(name, "prod", reg.register(name, _Const3(val)))
    return reg


X3 = np.zeros((1, 3), np.float32)


class TestMultiModelEngine:
    def _engine(self, reg):
        return Engine.from_registry(reg, "m1", max_batch=8, slo_ms=10_000, device="cpu").load(
            input_shape=(3,))

    def test_add_model_places_and_routes(self):
        reg = _three_models()
        eng = self._engine(reg)
        try:
            eng.add_model_from_registry(reg, "m2", input_shape=(3,))
            assert eng.has_model("m2") and eng.has_model("m1") and eng.has_model(None)
            assert eng.placed_models() == {"m1": "m1:v1", "m2": "m2:v1"}
            assert float(eng.output(X3)[0, 0]) == 1.0
            assert float(eng.output(X3, model="m2")[0, 0]) == 2.0
            assert float(eng.output(X3, model="m1")[0, 0]) == 1.0
            assert eng.model_last_used("m2") is not None
            assert eng.metrics_snapshot()["models"] == eng.placed_models()
            assert eng.metrics.counter_value("model_loads") == 1
            assert all(len({e["model"]}) == 1 for e in eng.batch_log)
        finally:
            eng.shutdown()

    def test_add_model_rejects_duplicates_and_default(self):
        reg = _three_models()
        eng = self._engine(reg)
        try:
            eng.add_model("m2", _Const3(2.0))
            with pytest.raises(ValueError, match="already placed"):
                eng.add_model("m2", _Const3(9.0))
            with pytest.raises(ValueError, match="already placed"):
                eng.add_model("m1", _Const3(9.0))
            with pytest.raises(ValueError, match="input shape"):
                eng.add_model("m4", _ConstModel(4.0))
        finally:
            eng.shutdown()

    def test_remove_model_evicts_but_never_the_default(self):
        reg = _three_models()
        eng = self._engine(reg)
        try:
            eng.add_model("m2", _Const3(2.0))
            assert eng.remove_model("m2") is True and not eng.has_model("m2")
            assert eng.remove_model("m2") is False
            with pytest.raises(ModelNotLoadedError):
                eng.output_async(X3, model="m2").result(timeout=10)
            with pytest.raises(ValueError, match="default model"):
                eng.remove_model("m1")
            with pytest.raises(ModelNotLoadedError):
                eng.compile_cache_size(model="m2")
            assert eng.metrics.counter_value("model_evictions") == 1
        finally:
            eng.shutdown()

    def test_named_networks_keep_their_own_programs_and_answers(self):
        """Two real networks of different widths beside each other: each
        request is its own model's eager forward, each model's program
        count flat; a removal drains and strands nothing."""
        a, b = _mlp(seed=1), _port_of(_np_init(4))
        eng = _engine(a, max_batch=4, replicas=2, slo_ms=30_000).load()
        try:
            eng.add_model("small", b)
            assert eng.compile_cache_size() == eng.compile_cache_size(model="small") == 6
            rng = np.random.default_rng(5)
            futs = []
            for i in range(24):
                if i % 2:
                    x = rng.normal(size=(1 + i % 3, 4)).astype(np.float32)
                    futs.append((b, x, eng.output_async(x, model="small")))
                else:
                    x = rng.normal(size=(1 + i % 3, 12)).astype(np.float32)
                    futs.append((a, x, eng.output_async(x)))
            for net, x, f in futs:
                np.testing.assert_allclose(f.result(timeout=30), _out(net, x), rtol=0,
                                           atol=1e-6)
            assert eng.compile_cache_size() == eng.compile_cache_size(model="small") == 6
            assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
            late = [eng.output_async(rng.normal(size=(1, 4)).astype(np.float32),
                                     model="small") for _ in range(6)]
            assert eng.remove_model("small")
            for f in late:
                f.exception(timeout=30)           # each resolves: a result or typed
            assert all(f.done() for f in late)
        finally:
            eng.shutdown()


def _np_init(n_in):
    """A 4 → 5 → 2 reference network for ``_port_of`` (built in place)."""
    net = JNet(JConf.builder().seed(2).layer(JDense(n_out=5, activation="relu"))
               .layer(JOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
               .set_input_type(JInputType.feed_forward(n_in)).build())
    net.init()
    return net


class TestRegistryInventory:
    def test_list_aliases_and_checkpoint_path(self, tmp_path):
        reg = _three_models()
        assert reg.list_aliases() == {"m1": {"prod": 1}, "m2": {"prod": 1},
                                      "m3": {"prod": 1}}
        reg.register("m4", _ConstModel(4.0))
        assert "m4" not in reg.list_aliases()
        assert reg.checkpoint_path("m1") is None and reg.checkpoint_path("nope") is None
        p = str(tmp_path / "m.zip")
        j_save(_jmlp(), p)
        v = reg.load("mlp", p)
        assert reg.checkpoint_path("mlp", v) == p
        assert reg.resolve("mlp", v)[1]._checkpoint_path == p


# -- canary promotion ---------------------------------------------------------------------------


class _NaNModel:
    def output(self, x):
        return np.full((x.shape[0], 1), np.nan, np.float32)


class _Traffic:
    """Background traffic driving a canary window."""

    def __init__(self, eng, shape=(1, 3), **kw):
        self.eng, self.shape, self.kw = eng, shape, kw
        self.stop = threading.Event()
        self.results, self.errors = [], []
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            try:
                self.results.append(self.eng.output(np.zeros(self.shape, np.float32),
                                                    **self.kw))
            except Exception as e:
                self.errors.append(e)
            time.sleep(0.002)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *a):
        self.stop.set()
        self.thread.join(timeout=10)


class TestCanary:
    def _setup(self, v2_model):
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", _ConstModel(1.0))
        v2 = reg.register("m", v2_model)
        reg.set_alias("m", "prod", v1)
        eng = Engine.from_registry(reg, "m", "prod", max_batch=4, slo_ms=10_000,
                                   max_wait_ms=0.5, device="cpu")
        return reg, v1, v2, eng

    def test_healthy_candidate_promotes(self):
        reg, v1, v2, eng = self._setup(_ConstModel(1.0))
        try:
            with _Traffic(eng):
                record = reg.set_alias("m", "prod", v2, canary=0.5, canary_window=4,
                                       canary_timeout_s=30)
            assert record["promoted"] is True
            d = record["decisions"][0]
            assert d["promote"] and d["mirrored_batches"] >= 4
            assert d["error_rate"] == 0.0 and d["mean_divergence"] == 0.0
            assert reg.resolve("m", "prod")[0] == v2 and eng.current_tag == "m:v2"
            c = eng.metrics_snapshot()["counters"]
            assert (c["canary_promotions"], c["canary_rollbacks"]) == (1, 0)
            assert c["canary_mirrored_batches"] >= 4
            assert reg.canary_history("m")[0]["promoted"] is True
            assert eng.metrics_snapshot()["canary_decisions"][0]["promote"] is True
        finally:
            eng.shutdown()

    def test_regressed_candidate_rolls_back(self):
        reg, v1, v_bad, eng = self._setup(_NaNModel())
        try:
            with _Traffic(eng) as traffic:
                record = reg.set_alias("m", "prod", v_bad, canary=0.5, canary_window=4,
                                       canary_timeout_s=30)
            d = record["decisions"][0]
            assert record["promoted"] is False and not d["promote"]
            assert d["error_rate"] == 1.0 and any("error rate" in r for r in d["reasons"])
            assert reg.resolve("m", "prod")[0] == v1 and eng.current_tag == "m:v1"
            assert eng.metrics_snapshot()["counters"]["canary_rollbacks"] == 1
            assert not traffic.errors
            assert all(np.isfinite(r).all() and r[0, 0] == 1.0 for r in traffic.results)
        finally:
            eng.shutdown()

    def test_divergent_candidate_rolls_back_on_threshold_and_raises_on_request(self):
        reg, v1, v2, eng = self._setup(_ConstModel(5.0))
        try:
            with _Traffic(eng):
                with pytest.raises(CanaryRejectedError) as e:
                    reg.set_alias("m", "prod", v2, canary=1.0, canary_window=3,
                                  canary_timeout_s=30,
                                  canary_thresholds={"max_divergence": 0.5},
                                  raise_on_reject=True)
            assert any("divergence" in r for r in e.value.reasons)
            assert e.value.record["promoted"] is False and e.value.candidate == v2
            assert eng.current_tag == "m:v1"
        finally:
            eng.shutdown()

    def test_no_traffic_window_times_out_to_rollback(self):
        reg, v1, v2, eng = self._setup(_ConstModel(1.0))
        try:
            record = reg.set_alias("m", "prod", v2, canary=0.5, canary_window=4,
                                   canary_timeout_s=0.3)
            assert record["promoted"] is False
            assert any("window incomplete" in r for r in record["decisions"][0]["reasons"])
            assert reg.resolve("m", "prod")[0] == v1
        finally:
            eng.shutdown()

    def test_canary_to_first_pin_or_same_version_is_direct(self):
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", _ConstModel(1.0))
        assert reg.set_alias("m", "prod", v1, canary=0.5) is None
        assert reg.set_alias("m", "prod", v1, canary=0.5) == v1

    def test_canary_programs_are_prepared_before_mirroring_and_released_on_rollback(self):
        """A network canary: its programs exist (every pair, every replica)
        before the first mirrored batch, none is prepared at serve time, and
        a NaN-poisoned candidate's programs are dropped at the rollback."""
        good, bad = _mlp(seed=3), _mlp(seed=4)
        bad.params[-1]["b"] = torch.full_like(bad.params[-1]["b"], float("nan"))
        reg = ModelRegistry(device="cpu")
        v1, v2, v3 = (reg.register("m", n) for n in (_mlp(seed=3), good, bad))
        reg.set_alias("m", "prod", v1)
        eng = Engine.from_registry(reg, "m", "prod", max_batch=4, replicas=2,
                                   slo_ms=10_000, max_wait_ms=0.5, device="cpu").load()
        seen = []
        real = eng._mirror_canary

        def spy(can, *a):
            seen.append(can.version.cache_size())
            return real(can, *a)
        eng._mirror_canary = spy
        try:
            # the programs are this test's subject: a loaded CPU's timing
            # noise must not veto v2 through the p99 rule
            loose = {"p99_factor": 1000.0}
            with _Traffic(eng, shape=(1, 12)) as traffic:
                ok = reg.set_alias("m", "prod", v2, canary=0.5, canary_window=4,
                                   canary_timeout_s=30, canary_thresholds=loose)
                bad_rec = reg.set_alias("m", "prod", v3, canary=0.5, canary_window=4,
                                        canary_timeout_s=30, canary_thresholds=loose)
            assert ok["promoted"] and not bad_rec["promoted"], (ok, bad_rec)
            assert seen and all(n == 6 for n in seen)
            assert [r["promoted"] for r in reg.canary_history("m")] == [True, False]
            assert eng.current_tag == "m:v2" and eng.compile_cache_size() == 6
            assert eng.metrics_snapshot()["counters"]["unwarmed_serves"] == 0
            assert not traffic.errors
        finally:
            eng.shutdown()


# -- warm bundles -------------------------------------------------------------------------------


def _bundle_engine(net):
    return _engine(net, max_batch=4, slo_ms=60_000)


class TestWarmBundle:
    def test_round_trip_counts_hits_and_serves_bitwise(self, tmp_path):
        net = _mlp()
        bundle = str(tmp_path / "m.zip.warm")
        x = np.random.default_rng(0).normal(size=(4, 12)).astype(np.float32)
        cold = _bundle_engine(net).load()
        try:
            c0 = cold.compile_cache_size()
            out_cold = cold.output(x)
            assert cold.metrics.counter_value("bundle_misses") == 3
            assert cold.metrics.counter_value("bundle_hits") == 0
            assert cold.save_warmup_bundle(bundle) == bundle
        finally:
            cold.shutdown()
        warm = _bundle_engine(net).load(warm_bundle=bundle)
        try:
            assert warm.metrics.counter_value("bundle_hits") == 3
            assert warm.metrics.counter_value("bundle_misses") == 0
            assert warm.compile_cache_size() == c0
            np.testing.assert_array_equal(warm.output(x), out_cold)
            assert warm.compile_cache_size() == c0
        finally:
            warm.shutdown()
        with zipfile.ZipFile(bundle) as z:
            meta = json.loads(z.read("meta.json"))
        assert meta["tag"] == "v0" and len(meta["entries"]) == 3
        assert set(meta["integrity"]) == set(meta["entries"])

    def test_missing_bundle_is_silent(self, tmp_path):
        import warnings
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert warmcache.load_bundle(str(tmp_path / "nope.warm")) == {}
            eng = _bundle_engine(_mlp()).load(warm_bundle=str(tmp_path / "still_nope.warm"))
            try:
                assert eng.metrics.counter_value("bundle_misses") == 3
            finally:
                eng.shutdown()
        assert [x for x in w if issubclass(x.category, RuntimeWarning)] == []

    @pytest.mark.parametrize("spoil", ["corrupt", "truncate", "fingerprint", "reference"])
    def test_unusable_bundle_warns_once_and_serves(self, tmp_path, spoil):
        net = _mlp()
        bundle = str(tmp_path / "m.zip.warm")
        x = np.random.default_rng(1).normal(size=(3, 12)).astype(np.float32)
        cold = _bundle_engine(net).load()
        want = cold.output(x)
        cold.save_warmup_bundle(bundle)
        cold.shutdown()
        if spoil == "corrupt":
            with open(bundle, "r+b") as f:
                f.seek(os.path.getsize(bundle) // 2)
                f.write(b"\x00" * 32)
        elif spoil == "truncate":
            with open(bundle, "r+b") as f:
                f.truncate(100)
        elif spoil == "fingerprint":
            spoiled = str(tmp_path / "spoiled.warm")
            with zipfile.ZipFile(bundle) as zin, zipfile.ZipFile(spoiled, "w") as zout:
                for name in zin.namelist():
                    b = zin.read(name)
                    if name == "meta.json":
                        meta = json.loads(b)
                        meta["fingerprint"] = "NVIDIA B200|8|sm_100|9.9|13.0|0"
                        b = json.dumps(meta).encode()
                    zout.writestr(name, b)
            bundle = spoiled
        else:
            # a bundle the reference writes (its layout, its fingerprint)
            from deeplearning4j_tpu.serving import warmcache as jwarm
            bundle = jwarm.save_bundle(str(tmp_path / "ref.zip.warm"), "v0", {})
        with pytest.warns(RuntimeWarning, match="falling back to capture") as rec:
            eng = _bundle_engine(net).load(warm_bundle=bundle)
        try:
            assert len([r for r in rec if issubclass(r.category, RuntimeWarning)]) == 1
            assert eng.metrics.counter_value("bundle_hits") == 0
            assert eng.metrics.counter_value("bundle_misses") == 3
            np.testing.assert_array_equal(eng.output(x), want)
        finally:
            eng.shutdown()

    def test_wrong_tag_falls_back(self, tmp_path):
        bundle = str(tmp_path / "m.zip.warm")
        eng = _bundle_engine(_mlp()).load()
        eng.save_warmup_bundle(bundle)
        eng.shutdown()
        with pytest.warns(RuntimeWarning, match="tag"):
            assert warmcache.load_bundle(bundle, tag="someone-else") == {}
        assert warmcache.load_bundle(bundle, tag="v0")

    def test_save_without_programs_or_path_raises(self, tmp_path):
        eng = _engine(_ConstModel(1.0), max_batch=4).load(input_shape=(3,))
        try:
            with pytest.raises(RuntimeError, match="nothing to bundle"):
                eng.save_warmup_bundle(str(tmp_path / "x.warm"))
        finally:
            eng.shutdown()
        eng2 = _bundle_engine(_mlp()).load()
        try:
            with pytest.raises(ValueError, match="path"):
                eng2.save_warmup_bundle()
        finally:
            eng2.shutdown()

    def test_registry_provenance_finds_the_bundle(self, tmp_path):
        p = str(tmp_path / "m.zip")
        j_save(_jmlp(seed=4), p)
        reg = ModelRegistry(device="cpu")
        reg.set_alias("m", "prod", reg.load("m", p))
        first = Engine.from_registry(reg, "m", max_batch=4, slo_ms=60_000,
                                     device="cpu").load()
        try:
            assert first.save_warmup_bundle() == p + ".warm"
        finally:
            first.shutdown()
        second = Engine.from_registry(reg, "m", max_batch=4, slo_ms=60_000,
                                      device="cpu").load()
        try:
            assert second.metrics.counter_value("bundle_hits") == 3
            assert second.metrics.counter_value("bundle_misses") == 0
        finally:
            second.shutdown()


# -- tenants and models over HTTP, and the chaos hook ------------------------------------------


def test_predict_forwards_tenant_and_model_and_answers_429_and_404():
    from deeplearning4j_tpu_torch.serving import TenantTable

    table = TenantTable.from_specs([{"tenant": "free", "quota_qps": 1, "burst": 1},
                                    {"tenant": "gold", "weight": 3.0}])
    eng = _engine(_Const3(1.0), max_batch=4, slo_ms=10_000, tenants=table).load(
        input_shape=(3,))
    eng.add_model("m2", _Const3(2.0))
    server = UIServer(port=0).attach_engine(eng).start()
    base = f"http://127.0.0.1:{server.port}/predict"
    try:
        body = {"inputs": [[0.0, 0.0, 0.0]]}
        code, r = _post(base, json.dumps({**body, "model": "m2", "tenant": "gold"}).encode())
        assert code == 200 and r["outputs"] == [[2.0]]
        code, r = _post(base, json.dumps({**body, "model": "nope"}).encode())
        assert code == 404 and r["error_class"] == "model_not_loaded"
        code, _ = _post(base, json.dumps({**body, "tenant": "free"}).encode())
        assert code == 200
        code, r = _post(base, json.dumps({**body, "tenant": "free"}).encode())
        assert code == 429 and r["error_class"] == "tenant_overloaded"
        assert (r["tenant"], r["shed_count"], r["reason"]) == ("free", 1, "quota")
        code, m = _get(f"http://127.0.0.1:{server.port}/metrics")
        assert m["serving"][0]["tenants"]["free"]["shed"] == 1
        assert m["serving"][0]["models"] == {"": "v0", "m2": "m2"}
    finally:
        server.stop()
        eng.shutdown()


def test_chaos_hook_crashes_a_replica_and_the_request_is_retried():
    from deeplearning4j_tpu_torch.parallel.chaos import FaultKind, FaultSchedule, ServingChaos

    chaos = ServingChaos(FaultSchedule.scripted({2: FaultKind.REPLICA_CRASH}))
    eng = _engine(_ConstModel(1.0), max_batch=4, slo_ms=10_000, replicas=2, chaos=chaos,
                  supervise_interval_s=0.01)
    try:
        for _ in range(3):
            assert float(eng.output(np.zeros((1, 2), np.float32))[0, 0]) == 1.0
        assert chaos.injected(FaultKind.REPLICA_CRASH) == 1
        c = eng.metrics_snapshot()["counters"]
        assert c["replica_crashes"] == 1 and c["retries"] >= 1
    finally:
        eng.shutdown()
