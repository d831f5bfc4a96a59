"""The port's serving resilience (mirrors the reference's
``tests/test_serving_resilience.py``): replica supervision (crash and
hang detection, retry on another replica, respawn and re-warm), the
circuit breaker, deadline-aware retries, poison-input bisection, a
hot-swap racing replica crashes, and the HTTP surface's health and
structured errors.

Faults are injected inside the model's forward, where a real one would
arrive: on a replica thread, the n-th forward of a script either raises
``SystemExit`` (the thread dies in the middle of its batch) or sleeps
(the replica hangs).  Forwards on other threads (warm-up, a respawn's
re-warm) are not counted, so the n-th forward is the n-th batch a
replica executes, as the reference's chaos schedule counts them.  Every
test runs on the CPU (``device="cpu"``).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.serving import (Engine, ModelRegistry, PoisonInputError,
                                              ReplicaCrashError, ReplicaHungError)
from deeplearning4j_tpu_torch.ui import UIServer

# the injected crashes end replica threads with SystemExit on purpose
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _mlp(seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


class _ConstModel:
    def __init__(self, val, delay_s=0.0):
        self.val = float(val)
        self.delay_s = delay_s
        self.calls = 0

    def output(self, x):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.full((x.shape[0], 1), self.val, np.float32)


class _NaNModel:
    def output(self, x):
        return np.full((x.shape[0], 1), np.nan, np.float32)


class _Contaminating:
    """A poison row NaNs the whole batch output (a cross-batch reduction):
    the hard case for poison isolation."""

    def output(self, x):
        return (np.sum(x) * np.ones((x.shape[0], 1))).astype(np.float32)


class _Script:
    """Which replica-thread forwards (1-based, counted across the models
    that share the script) crash or hang."""

    def __init__(self, crash=(), hang=(), hang_s=1.0):
        self.crash, self.hang, self.hang_s = set(crash), set(hang), hang_s
        self.n = 0
        self.injected = 0
        self.lock = threading.Lock()

    def before_forward(self):
        if not threading.current_thread().name.startswith("engine-replica"):
            return
        with self.lock:
            self.n += 1
            n = self.n
        if n in self.crash:
            with self.lock:
                self.injected += 1
            raise SystemExit(f"replica thread dies in forward {n}")
        if n in self.hang:
            with self.lock:
                self.injected += 1
            time.sleep(self.hang_s)


class _FaultyModel:
    """A duck-typed model with a fault script."""

    def __init__(self, inner, script):
        self.inner, self.script = inner, script

    def output(self, x):
        self.script.before_forward()
        return self.inner.output(x)


class _FaultyNet:
    """A network served through ``_apply_layers``, with a fault script."""

    def __init__(self, net, script):
        self.net, self.script = net, script
        self.conf, self.params, self.state = net.conf, net.params, net.state

    def _apply_layers(self, *a, **kw):
        self.script.before_forward()
        return self.net._apply_layers(*a, **kw)


def _engine(model, **kw):
    return Engine(model, device="cpu", **kw)


# -- replica supervision ------------------------------------------------------------------


class TestReplicaSupervision:
    def test_crash_mid_batch_never_strands_futures(self):
        eng = _engine(_FaultyNet(_mlp(), _Script(crash=[1])), max_batch=4, replicas=1,
                      slo_ms=10_000, max_retries=0, supervise_interval_s=0.01).load()
        try:
            t0 = time.monotonic()
            with pytest.raises(ReplicaCrashError):
                eng.output(np.zeros((2, 12), np.float32))
            assert time.monotonic() - t0 < 5.0  # raises, not hangs
            snap = eng.metrics_snapshot()
            assert snap["counters"]["replica_crashes"] == 1
            assert snap["counters"]["replica_respawns"] == 1
        finally:
            eng.shutdown()

    def test_crash_retries_on_a_different_replica(self):
        eng = _engine(_FaultyNet(_mlp(), _Script(crash=[1])), max_batch=4, replicas=2,
                      slo_ms=10_000, supervise_interval_s=0.01).load()
        try:
            c0 = eng.compile_cache_size()
            out = eng.output(np.zeros((2, 12), np.float32))  # crash → retry
            assert out.shape == (2, 3)
            snap = eng.metrics_snapshot()
            assert snap["counters"]["replica_crashes"] == 1
            assert snap["counters"]["retries"] >= 1
            assert snap["counters"]["replica_respawns"] == 1
            crashed = [r for r in snap["health"]["replicas"] if r["respawns"] == 1]
            assert len(crashed) == 1
            assert crashed[0]["replica"] not in {b["replica"] for b in eng.batch_log}
            # the respawn's re-warm adds no program
            assert eng.compile_cache_size() == c0
            assert snap["counters"]["unwarmed_serves"] == 0
            assert eng.output(np.zeros((3, 12), np.float32)).shape == (3, 3)
            assert eng.compile_cache_size() == c0
        finally:
            eng.shutdown()

    def test_hang_detected_and_retried(self):
        eng = _engine(_FaultyNet(_mlp(), _Script(hang=[1], hang_s=1.0)), max_batch=4,
                      replicas=2, slo_ms=10_000, forward_timeout_s=0.15,
                      supervise_interval_s=0.01).load()
        try:
            t0 = time.monotonic()
            out = eng.output(np.zeros((2, 12), np.float32))
            waited = time.monotonic() - t0
            assert out.shape == (2, 3)
            assert waited < 0.9  # resolved by the retry, not by the hang ending
            snap = eng.metrics_snapshot()
            assert snap["counters"]["replica_hangs"] == 1
            assert snap["counters"]["retries"] >= 1
            time.sleep(1.0)  # the hung incarnation wakes, its result is dropped
            assert eng.metrics_snapshot()["counters"]["replica_respawns"] == 1
            assert eng.output(np.zeros((1, 12), np.float32)).shape == (1, 3)
        finally:
            eng.shutdown()

    def test_hang_without_retry_budget_fails_typed(self):
        eng = _engine(_FaultyNet(_mlp(), _Script(hang=[1], hang_s=1.0)), max_batch=4,
                      replicas=1, slo_ms=10_000, forward_timeout_s=0.15, max_retries=0,
                      supervise_interval_s=0.01).load()
        try:
            with pytest.raises(ReplicaHungError):
                eng.output(np.zeros((2, 12), np.float32))
        finally:
            eng.shutdown()

    def test_circuit_breaker_trips_and_recovers(self):
        """Two consecutive crashes at breaker_threshold=2 open the breaker;
        after the cooldown the replica half-opens and a successful probe
        closes it."""
        eng = _engine(_FaultyNet(_mlp(), _Script(crash=[1, 2])), max_batch=4, replicas=1,
                      slo_ms=10_000, breaker_threshold=2, breaker_cooldown_s=0.2,
                      supervise_interval_s=0.01).load()
        try:
            with pytest.raises(ReplicaCrashError):
                eng.output(np.zeros((2, 12), np.float32))
            snap = eng.metrics_snapshot()
            assert snap["counters"]["replica_crashes"] == 2
            assert snap["counters"]["circuit_opens"] == 1
            out = eng.output(np.zeros((2, 12), np.float32), slo_ms=10_000)
            assert out.shape == (2, 3)
            health = eng.health_snapshot()
            assert health["status"] == "ok"
            assert health["replicas"][0]["breaker_open"] is False
            assert health["replicas"][0]["consecutive_failures"] == 0
        finally:
            eng.shutdown()

    def test_health_snapshot_shape(self):
        eng = _engine(_ConstModel(1.0), max_batch=4, replicas=2, slo_ms=10_000)
        try:
            h = eng.health_snapshot()
            assert h["status"] == "ok" and h["ready"] is True
            assert len(h["replicas"]) == 2
            for r in h["replicas"]:
                assert r["health"] == "healthy" and r["alive"] and r["device"] == "cpu"
                assert r["breaker_open"] is False
        finally:
            eng.shutdown()
            assert eng.health_snapshot()["ready"] is False


# -- retry and deadline --------------------------------------------------------------------


class TestRetryDeadline:
    def test_retry_never_launches_past_deadline(self):
        """A crashed request whose remaining deadline is smaller than the
        bucket's expected exec time fails typed instead of retrying."""
        model = _ConstModel(1.0, delay_s=0.15)   # warm-up seeds the EMA ~150ms
        eng = _engine(_FaultyModel(model, _Script(crash=[1])), max_batch=2, replicas=2,
                      slo_ms=10_000, supervise_interval_s=0.01).load(input_shape=(2,))
        try:
            calls_before = model.calls
            with pytest.raises(ReplicaCrashError):
                eng.output(np.zeros((1, 2), np.float32), slo_ms=100)
            # the only model calls after the crash are the re-warm's
            assert model.calls - calls_before <= len(eng.batcher.buckets)
            assert eng.metrics_snapshot()["counters"]["retries"] == 0
        finally:
            eng.shutdown()

    def test_retry_with_slack_succeeds(self):
        model = _ConstModel(1.0, delay_s=0.05)
        eng = _engine(_FaultyModel(model, _Script(crash=[1])), max_batch=2, replicas=2,
                      slo_ms=10_000, supervise_interval_s=0.01).load(input_shape=(2,))
        try:
            out = eng.output(np.zeros((1, 2), np.float32), slo_ms=5_000)
            assert out.shape == (1, 1)
            assert eng.metrics_snapshot()["counters"]["retries"] == 1
        finally:
            eng.shutdown()

    def test_model_error_retried_then_propagates(self):
        class Broken:
            def __init__(self):
                self.calls = 0

            def output(self, x):
                self.calls += 1
                raise RuntimeError("boom")

        model = Broken()
        eng = _engine(model, max_batch=4, slo_ms=10_000, max_retries=1)
        try:
            with pytest.raises(RuntimeError, match="boom"):
                eng.output(np.ones((2, 3), np.float32))
            assert model.calls == 2   # the original and exactly one retry
        finally:
            eng.shutdown()


# -- poison-input isolation ----------------------------------------------------------------


class TestPoisonIsolation:
    def test_poison_isolated_co_batched_succeed(self):
        net = _mlp()
        eng = _engine(net, max_batch=8, replicas=1, slo_ms=10_000, max_wait_ms=20.0).load()
        try:
            good = [eng.output_async(np.ones((1, 12), np.float32)) for _ in range(3)]
            poison = eng.output_async(np.full((1, 12), np.nan, np.float32))
            more_good = [eng.output_async(np.ones((1, 12), np.float32)) for _ in range(3)]
            want = net.output(np.ones((1, 12), np.float32)).numpy()
            for f in good + more_good:
                np.testing.assert_allclose(f.result(timeout=30), want, atol=1e-6, rtol=0)
            with pytest.raises(PoisonInputError):
                poison.result(timeout=30)
            snap = eng.metrics_snapshot()
            assert snap["counters"]["poison_isolated"] == 1
            assert snap["counters"]["unwarmed_serves"] == 0  # pow2 halves
            poisoned = [b for b in eng.batch_log if b["poison"]]
            assert [b["n_requests"] >= 2 for b in poisoned] == [True]
            assert id(poison) in poisoned[0]["request_ids"]
        finally:
            eng.shutdown()

    def test_poison_isolated_when_model_contaminates_whole_batch(self):
        eng = _engine(_Contaminating(), max_batch=8, replicas=1, slo_ms=10_000,
                      max_wait_ms=20.0)
        try:
            good = [eng.output_async(np.ones((1, 4), np.float32)) for _ in range(3)]
            poison = eng.output_async(np.full((1, 4), np.nan, np.float32))
            for f in good:
                assert np.isfinite(f.result(timeout=30)).all()
            with pytest.raises(PoisonInputError):
                poison.result(timeout=30)
            assert eng.metrics_snapshot()["counters"]["poison_isolated"] == 1
        finally:
            eng.shutdown()

    def test_poison_isolation_can_be_disabled(self):
        eng = _engine(_NaNModel(), max_batch=4, replicas=1, slo_ms=10_000,
                      poison_isolation=False)
        try:
            assert np.isnan(eng.output(np.ones((2, 3), np.float32))).all()
        finally:
            eng.shutdown()


# -- hot swap racing replica failures --------------------------------------------------------


class TestSwapRacingFailure:
    def test_swap_drains_and_completes_with_replica_crash_mid_drain(self):
        script = _Script(crash=[3, 7, 11])
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", _FaultyModel(_ConstModel(1.0, delay_s=0.002), script))
        v2 = reg.register("m", _FaultyModel(_ConstModel(2.0, delay_s=0.002), script))
        reg.set_alias("m", "prod", v1)
        eng = Engine.from_registry(reg, "m", "prod", max_batch=4, replicas=2,
                                   slo_ms=10_000, supervise_interval_s=0.01, device="cpu")
        try:
            futs, stop = [], threading.Event()

            def pound():
                while not stop.is_set():
                    futs.append(eng.output_async(np.zeros((1, 3), np.float32)))
                    time.sleep(0.001)

            threads = [threading.Thread(target=pound, daemon=True) for _ in range(3)]
            for t in threads:
                t.start()
            while script.n < 5:
                time.sleep(0.005)
            swapped = []

            def swap():
                reg.set_alias("m", "prod", v2)
                swapped.append(True)

            st = threading.Thread(target=swap, daemon=True)
            st.start()
            st.join(timeout=30)
            assert swapped, "hot-swap drain stranded by the replica crash"
            deadline = time.monotonic() + 10
            while script.n < 12 and time.monotonic() < deadline:
                time.sleep(0.01)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            vals = []
            for f in futs:
                try:
                    vals.append(float(np.unique(f.result(timeout=30))[0]))
                except (ReplicaCrashError, RuntimeError):
                    pass
            assert all(f.done() for f in futs)
            assert vals and all(v in (1.0, 2.0) for v in vals)
            for entry in eng.batch_log:   # batches never mix versions
                assert entry["tag"] in ("m:v1", "m:v2")
            assert eng.current_tag == "m:v2"
            assert script.injected == 3
        finally:
            eng.shutdown()


# -- HTTP surface ----------------------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHttpSurface:
    def test_healthz_and_structured_errors(self):
        class Broken:
            def output(self, x):
                raise RuntimeError("secret internal detail")

        eng = _engine(Broken(), max_batch=4, slo_ms=500, max_retries=0)
        server = UIServer(port=0).attach_engine(eng).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            h = json.loads(urllib.request.urlopen(base + "/healthz", timeout=5).read())
            assert h["status"] == "ok" and h["ready"] is True
            assert h["replicas"][0]["health"] == "healthy"
            code, payload = _post(base + "/predict", {"inputs": [[0.0] * 3]})
            assert code == 500 and payload["error_class"] == "internal"
            assert "Traceback" not in payload["error"]
            code, payload = _post(base + "/predict", {})
            assert code == 400 and payload["error_class"] == "bad_request"
        finally:
            server.stop()
            eng.shutdown()

    def test_healthz_without_engine_is_503(self):
        server = UIServer(port=0).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                       timeout=5)
            assert ei.value.code == 503
            assert json.loads(ei.value.read())["ready"] is False
        finally:
            server.stop()

    def test_poison_maps_to_422(self):
        eng = _engine(_mlp(), max_batch=4, slo_ms=10_000).load()
        server = UIServer(port=0).attach_engine(eng).start()
        try:
            code, payload = _post(f"http://127.0.0.1:{server.port}/predict",
                                  {"inputs": [[float("nan")] * 12]})
            assert code == 422 and payload["error_class"] == "poison_input"
        finally:
            server.stop()
            eng.shutdown()

    def test_poison_row_fails_alone_among_co_batched_http_requests(self):
        net = _mlp()
        eng = _engine(net, max_batch=4, slo_ms=10_000, max_wait_ms=200.0).load()
        server = UIServer(port=0).attach_engine(eng).start()
        try:
            url = f"http://127.0.0.1:{server.port}/predict"
            rows = [[1.0] * 12, [float("nan")] * 12, [0.5] * 12, [-1.0] * 12]
            got = [None] * 4

            def send(i):
                got[i] = _post(url, {"inputs": [rows[i]]})

            threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert [g[0] for g in got] == [200, 422, 200, 200]
            assert got[1][1]["error_class"] == "poison_input"
            for i in (0, 2, 3):
                np.testing.assert_allclose(
                    np.asarray(got[i][1]["outputs"], np.float32),
                    net.output(np.asarray([rows[i]], np.float32)).numpy(),
                    atol=1e-6, rtol=0)
            # the poison request's own batch held others: bisection ran
            poisoned = [b for b in eng.batch_log if b["poison"]]
            assert len(poisoned) == 1 and poisoned[0]["n_requests"] >= 2
            assert eng.metrics_snapshot()["counters"]["poison_isolated"] == 1
        finally:
            server.stop()
            eng.shutdown()


# -- respawn failure visibility ---------------------------------------------------------------


class TestRespawnFailureVisibility:
    def test_failed_rewarm_is_counted(self):
        eng = _engine(_mlp(), max_batch=4, replicas=1, supervise_interval_s=0.01).load()
        try:
            def boom(idx):
                raise RuntimeError("warm-up device lost")
            eng._rewarm_replica = boom
            eng._recover_replica(eng._replicas[0], None, ReplicaCrashError("injected"))
            snap = eng.metrics_snapshot()
            assert snap["counters"]["respawn_failures"] == 1
            assert snap["counters"]["replica_respawns"] == 1
        finally:
            eng.shutdown()

    def test_respawn_failures_key_present_at_zero(self):
        eng = _engine(_mlp(), max_batch=4, replicas=1).load()
        try:
            assert eng.metrics_snapshot()["counters"]["respawn_failures"] == 0
        finally:
            eng.shutdown()
