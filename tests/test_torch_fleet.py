"""The port's fleet router against the JAX package's
(``tests/test_fleet.py``'s scenarios on ``deeplearning4j_tpu_torch``).

Dispatch, session affinity, failover, drain and membership, rolling swap,
lifecycle, chaos plumbing, the HTTP surface and the serve CLI run on the
port's ``FleetRouter`` over duck-typed fake engines (their futures
resolve with the host's tag, or wait for the test), with an injected
clock and ``poke(now=)`` driving the watchdog.  A lockstep test drives
the same fake hosts, clock and request script through both routers: the
dispatch log (request → host, retries), the counters and the session
ring must be equal.
"""

import json
import sys
import threading
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                    MultiLayerNetwork)
from deeplearning4j_tpu_torch.parallel import FaultKind, FaultSchedule, FleetChaos
from deeplearning4j_tpu_torch.serving import (
    Engine, FleetHost, FleetMetrics, FleetRouter, FleetTimeoutError,
    HttpHost, ModelRegistry, OverloadedError, ServingUnavailableError,
)
from deeplearning4j_tpu_torch.utils.params import params_from_numpy


def _mlp(seed=7):
    import jax

    conf = (JConf.builder().seed(seed).updater(JSgd(lr=0.05))
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(12)).build())
    jnet = JNet(conf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf.to_dict()), device="cpu")
    net.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                   device="cpu")
    net.state = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.state),
                                  device="cpu")
    return net


class _FakeEngine:
    """Duck-typed host engine under full test control: resolves
    instantly with its own tag (so tests read WHICH host/version served
    a request straight off the result), or holds futures for manual
    resolution; sync failures and swap failures are scriptable."""

    def __init__(self, tag="m:v1", manual=False, depth=0):
        self.tag = tag
        self.manual = manual
        self.depth = depth
        self.fail_next = 0
        self.exc_type = RuntimeError
        self.swap_exc = None
        self.pending = []
        self.calls = []
        self.swaps = []
        self.shutdowns = 0

    def output_async(self, x, slo_ms=None):
        self.calls.append(np.asarray(x))
        if self.fail_next > 0:
            self.fail_next -= 1
            raise self.exc_type("scripted host failure")
        fut = Future()
        if self.manual:
            self.pending.append(fut)
        else:
            fut.set_result(self.tag)
        return fut

    def swap_model(self, model, tag=None):
        if self.swap_exc is not None:
            raise self.swap_exc
        self.swaps.append(tag)
        self.tag = tag

    @property
    def current_tag(self):
        return self.tag

    def metrics_snapshot(self):
        return {"queue_depth": self.depth}

    def health_snapshot(self):
        return {"status": "ok", "ready": True, "model": self.tag}

    def shutdown(self):
        self.shutdowns += 1


class _FakeDecode(_FakeEngine):
    def generate_async(self, prompt_ids=None, slo_ms=None, **kw):
        return self.output_async(prompt_ids, slo_ms=slo_ms)


def _router(n_hosts=2, tags=None, manual=False, clock=None, **kw):
    kw.setdefault("start_watchdog", False)
    if clock is not None:
        kw["clock"] = clock
    router = FleetRouter(**kw)
    engines = []
    for i in range(n_hosts):
        eng = _FakeEngine(tag=(tags[i] if tags else f"m:v1"),
                          manual=manual)
        engines.append(eng)
        router.add_host(f"h{i}", engine=eng)
    return router, engines


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_round_robin_over_idle_hosts(self):
        router, (a, b) = _router()
        for i in range(6):
            assert router.output_async([i]).result(timeout=5) == "m:v1"
        assert len(a.calls) == 3 and len(b.calls) == 3
        router.shutdown()

    def test_inflight_steers_to_idle_host(self):
        router, (a, b) = _router(manual=True)
        router.output_async([0])
        router.output_async([1])
        # one attempt in flight per host; both resolve -> both counted
        assert len(a.calls) == 1 and len(b.calls) == 1
        for eng in (a, b):
            eng.pending[0].set_result(eng.tag)
        router.shutdown()

    def test_cached_queue_depth_steers(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock)
        a.depth = 50
        router.poke(now=clock())          # watchdog tick polls /metrics
        for i in range(4):
            router.output_async([i]).result(timeout=5)
        assert len(a.calls) == 0 and len(b.calls) == 4
        assert router.metrics_snapshot()["hosts"]["h0"]["queue_depth"] == 50
        router.shutdown()

    def test_no_dispatchable_host_sheds_typed(self):
        router, _ = _router()
        router.mark_host_down("h0", reason="test")
        router.mark_host_down("h1", reason="test")
        fut = router.output_async([0])
        with pytest.raises(OverloadedError):
            fut.result(timeout=5)
        assert router.metrics.snapshot()["counters"]["shed"] == 1
        router.shutdown()

    def test_decode_kind_routes_only_to_decode_hosts(self):
        router = FleetRouter(start_watchdog=False)
        predict = _FakeEngine(tag="p:v1")
        decode = _FakeDecode(tag="d:v1")
        router.add_host("p", engine=predict)
        router.add_host("d", decode=decode)
        for i in range(3):
            assert router.generate_async([1, 2]).result(timeout=5) == "d:v1"
            assert router.output_async([0]).result(timeout=5) == "p:v1"
        assert len(predict.calls) == 3 and len(decode.calls) == 3
        router.shutdown()

    def test_fleet_host_requires_an_engine(self):
        with pytest.raises(ValueError):
            FleetHost("empty")


# ---------------------------------------------------------------------------
# session affinity
# ---------------------------------------------------------------------------

class TestAffinity:
    def test_session_sticks_to_one_host(self):
        router, (a, b) = _router()
        for _ in range(10):
            router.output_async([0], session="alice").result(timeout=5)
        assert sorted([len(a.calls), len(b.calls)]) == [0, 10]
        assert (router.metrics.snapshot()["counters"]["affinity_routed"]
                == 10)
        router.shutdown()

    def test_sessions_spread_over_the_ring(self):
        router, (a, b) = _router()
        for i in range(64):
            router.output_async([i], session=f"s{i}").result(timeout=5)
        assert len(a.calls) > 0 and len(b.calls) > 0
        router.shutdown()

    def test_affinity_rehomes_when_host_dies(self):
        router, (a, b) = _router()
        router.output_async([0], session="alice").result(timeout=5)
        home, other = (a, b) if a.calls else (b, a)
        home_id = "h0" if home is a else "h1"
        router.mark_host_down(home_id, reason="test")
        router.output_async([1], session="alice").result(timeout=5)
        assert len(other.calls) == 1
        router.shutdown()


# ---------------------------------------------------------------------------
# failover: retries, at-most-once, timeouts, breaker
# ---------------------------------------------------------------------------

class TestFailover:
    def _steer_to(self, router, engines, target_idx, clock):
        """Pin first dispatch onto one host by inflating the others'
        cached queue depth."""
        for i, eng in enumerate(engines):
            eng.depth = 0 if i == target_idx else 100
        router.poke(now=clock())

    def test_host_failure_retries_on_another_host(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=1)
        self._steer_to(router, (a, b), 0, clock)
        a.fail_next = 1
        assert router.output_async([0]).result(timeout=5) == "m:v1"
        assert len(a.calls) == 1 and len(b.calls) == 1
        c = router.metrics.snapshot()["counters"]
        assert c["retries"] == 1 and c["delivered"] == 1
        assert c["host_failures"] == 1 and c["failed"] == 0
        router.shutdown()

    def test_retry_budget_exhausted_fails_typed(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=1)
        a.fail_next = b.fail_next = 5
        fut = router.output_async([0])
        with pytest.raises(RuntimeError, match="scripted host failure"):
            fut.result(timeout=5)
        c = router.metrics.snapshot()["counters"]
        assert c["failed"] == 1 and c["retries"] == 1
        # both hosts tried exactly once: never the same host twice
        assert len(a.calls) == 1 and len(b.calls) == 1
        router.shutdown()

    def test_non_retryable_error_fails_fast(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=3)
        self._steer_to(router, (a, b), 0, clock)
        a.fail_next, a.exc_type = 1, ValueError
        fut = router.output_async([0])
        with pytest.raises(ValueError):
            fut.result(timeout=5)
        c = router.metrics.snapshot()["counters"]
        assert c["retries"] == 0 and len(b.calls) == 0
        # a deterministic request error says nothing about host health
        assert c["host_failures"] == 0
        router.shutdown()

    def test_overload_shed_retries_but_never_feeds_breaker(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=1,
                                 breaker_threshold=1)
        self._steer_to(router, (a, b), 0, clock)
        a.fail_next, a.exc_type = 1, OverloadedError
        assert router.output_async([0]).result(timeout=5) == "m:v1"
        c = router.metrics.snapshot()["counters"]
        assert c["retries"] == 1 and c["host_failures"] == 0
        assert router.hosts()["h0"] == "up"     # breaker untouched
        router.shutdown()

    def test_deadline_aware_retry_gives_up(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=3, manual=True)
        self._steer_to(router, (a, b), 0, clock)
        fut = router.output_async([0], slo_ms=100.0)
        clock.t += 1.0                          # deadline long gone
        a.pending[0].set_exception(RuntimeError("late failure"))
        with pytest.raises(RuntimeError, match="late failure"):
            fut.result(timeout=5)
        assert len(b.calls) == 0
        router.shutdown()

    def test_timeout_reroutes_and_late_result_is_discarded(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, manual=True,
                                 request_timeout_s=1.0, max_retries=1)
        self._steer_to(router, (a, b), 0, clock)
        b.manual = False
        fut = router.output_async([0])
        assert len(a.calls) == 1 and len(b.calls) == 0
        clock.t += 2.0
        router.poke(now=clock())                # expires the attempt
        assert fut.result(timeout=5) == "m:v1"  # delivered by h1
        assert len(b.calls) == 1
        c = router.metrics.snapshot()["counters"]
        assert c["timeouts"] == 1 and c["retries"] == 1
        # the straggler finishes AFTER the re-route: at-most-once means
        # its result is a counted discard, never a second delivery
        a.pending[0].set_result("late-from-h0")
        c = router.metrics.snapshot()["counters"]
        assert c["late_discards"] == 1 and c["delivered"] == 1
        assert fut.result() == "m:v1"
        snap = router.metrics_snapshot()
        assert snap["hosts"]["h0"]["inflight"] == 0
        router.shutdown()

    def test_breaker_trips_after_consecutive_failures(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=1,
                                 breaker_threshold=3)
        self._steer_to(router, (a, b), 0, clock)
        a.fail_next = 99
        for i in range(3):
            assert router.output_async([i]).result(timeout=5) == "m:v1"
            self._steer_to(router, (a, b), 0, clock)
        assert router.hosts()["h0"] == "down"
        assert router.metrics.snapshot()["counters"]["host_down"] == 1
        # traffic keeps flowing on the survivor without retries
        n_retries = router.metrics.snapshot()["counters"]["retries"]
        router.output_async([9]).result(timeout=5)
        assert router.metrics.snapshot()["counters"]["retries"] == n_retries
        router.mark_host_up("h0")
        assert router.hosts()["h0"] == "up"
        router.shutdown()

    def test_delivery_resets_failure_streak(self):
        clock = _Clock()
        router, (a, b) = _router(clock=clock, max_retries=1,
                                 breaker_threshold=3)
        for round_ in range(3):                 # fail, succeed, repeat
            self._steer_to(router, (a, b), 0, clock)
            a.fail_next = 1
            router.output_async([round_]).result(timeout=5)
            self._steer_to(router, (a, b), 0, clock)
            router.output_async([round_]).result(timeout=5)
        assert router.hosts()["h0"] == "up"     # streak never reached 3
        router.shutdown()


# ---------------------------------------------------------------------------
# drain, preemption, membership
# ---------------------------------------------------------------------------

class TestDrainAndMembership:
    def test_drain_host_waits_for_inflight(self):
        router, (a, b) = _router(manual=True)
        fut = router.output_async([0])
        busy = a if a.pending else b
        busy_id = "h0" if busy is a else "h1"
        done = threading.Event()
        result = {}

        def drain():
            result["ok"] = router.drain_host(busy_id, timeout_s=10.0)
            done.set()
        threading.Thread(target=drain, daemon=True).start()
        time.sleep(0.05)
        assert not done.is_set()                # still waiting on in-flight
        busy.pending[0].set_result("done")
        assert done.wait(timeout=5) and result["ok"]
        assert router.hosts()[busy_id] == "draining"
        assert fut.result(timeout=5) == "done"
        router.undrain_host(busy_id)
        assert router.hosts()[busy_id] == "up"
        router.shutdown()

    def test_draining_host_receives_no_new_dispatch(self):
        router, (a, b) = _router()
        router.drain_host("h0", timeout_s=1.0)
        for i in range(4):
            router.output_async([i]).result(timeout=5)
        assert len(a.calls) == 0 and len(b.calls) == 4
        router.shutdown()

    def test_notify_preemption_is_a_planned_leave(self):
        router, (a, b) = _router()
        assert router.notify_preemption("h0", grace_s=5.0) is True
        assert router.hosts()["h0"] == "down"
        snap = router.health_snapshot()
        assert snap["hosts"]["h0"]["planned"] is True
        assert (router.metrics.snapshot()["counters"]["preempt_drains"]
                == 1)
        router.output_async([0]).result(timeout=5)
        assert len(b.calls) == 1
        router.shutdown()

    def test_begin_drain_sheds_new_keeps_inflight(self):
        router, (a, b) = _router(manual=True)
        fut = router.output_async([0])
        router.begin_drain()
        assert router.draining()
        shed = router.output_async([1])
        with pytest.raises(OverloadedError, match="draining"):
            shed.result(timeout=5)
        (a.pending or b.pending)[0].set_result("finished")
        assert fut.result(timeout=5) == "finished"
        router.shutdown()

    def test_membership_ledger_drives_state(self):
        class _Ledger:
            def __init__(self):
                self.alive_ids = [0, 1]
                self.leaving_ids = {}

            def alive(self):
                return list(self.alive_ids)

            def leaving(self):
                return dict(self.leaving_ids)

        ledger = _Ledger()
        router = FleetRouter(start_watchdog=False, membership=ledger)
        a, b = _FakeEngine(), _FakeEngine()
        router.add_host("h0", engine=a, process_id=0)
        router.add_host("h1", engine=b, process_id=1)
        router.refresh_membership()
        assert router.hosts() == {"h0": "up", "h1": "up"}
        # PR-9 preemption notice lands in the ledger -> draining
        ledger.leaving_ids = {1: {"reason": "preempt"}}
        router.refresh_membership()
        assert router.hosts()["h1"] == "draining"
        # heartbeat stops -> down
        ledger.alive_ids = [0]
        ledger.leaving_ids = {}
        router.refresh_membership()
        assert router.hosts()["h1"] == "down"
        # the worker relaunches and beats again -> back up
        ledger.alive_ids = [0, 1]
        router.refresh_membership()
        assert router.hosts()["h1"] == "up"
        router.shutdown()

    def test_torn_ledger_read_is_counted_not_fatal(self):
        class _Broken:
            def alive(self):
                raise OSError("torn read")

            def leaving(self):
                return {}

        router = FleetRouter(start_watchdog=False, membership=_Broken())
        router.add_host("h0", engine=_FakeEngine(), process_id=0)
        router.refresh_membership()
        assert (router.metrics.snapshot()["counters"]
                .get("membership_errors") == 1)
        assert router.hosts()["h0"] == "up"
        router.shutdown()


# ---------------------------------------------------------------------------
# rolling swap / promote
# ---------------------------------------------------------------------------

class TestRollingSwap:
    def test_swap_walks_every_host_and_retags(self):
        router, (a, b) = _router()
        new = object()
        report = router.rolling_swap(new, "m:v2")
        assert report["ok"] and report["swapped"] == ["h0", "h1"]
        assert a.swaps == ["m:v2"] and b.swaps == ["m:v2"]
        assert router.current_tag == "m:v2"
        c = router.metrics.snapshot()["counters"]
        assert c["rolling_swaps"] == 1 and c["swap_hosts"] == 2
        assert router.hosts() == {"h0": "up", "h1": "up"}
        router.shutdown()

    def test_swap_under_traffic_never_drops_requests(self):
        router, engines = _router()
        stop = threading.Event()
        failures = []

        def pump():
            while not stop.is_set():
                try:
                    router.output_async([0]).result(timeout=5)
                except Exception as exc:   # noqa: BLE001 - recorded, asserted
                    failures.append(exc)
        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            report = router.rolling_swap(object(), "m:v2",
                                         drain_timeout_s=10.0)
        finally:
            stop.set()
            t.join(timeout=10)
        assert report["ok"] and failures == []
        router.shutdown()

    def test_mid_swap_host_death_rolls_back_survivors(self):
        router, (a, b) = _router()
        b.swap_exc = RuntimeError("host died mid-swap")
        report = router.rolling_swap(object(), "m:v2",
                                     rollback_model=object(),
                                     rollback_tag="m:v1")
        assert not report["ok"] and report["failed_host"] == "h1"
        assert report["rolled_back"] and report["swapped"] == ["h0"]
        # h0 went v2 then back; the fleet never serves v2 past the call
        assert a.swaps == ["m:v2", "m:v1"]
        assert router.current_tag == "m:v1"
        assert router.hosts() == {"h0": "up", "h1": "down"}
        assert router.metrics.snapshot()["counters"]["rollbacks"] == 1
        assert router.health_snapshot()["status"] == "degraded"
        router.shutdown()

    def test_promote_moves_alias_only_on_success(self):
        reg = ModelRegistry(device="cpu")
        v1 = reg.register("m", object())
        reg.set_alias("m", "prod", v1)
        v2 = reg.register("m", object())
        router, (a, b) = _router(tags=["m:v1", "m:v1"])
        report = router.promote(reg, "m")
        assert report["ok"] and report["version"] == v2
        assert reg.resolve("m", "prod")[0] == v2
        assert router.current_tag == "m:v2"
        # a sabotaged roll leaves the alias where it was
        reg.register("m", object())
        b.swap_exc = RuntimeError("dead")
        report = router.promote(reg, "m")
        assert not report["ok"] and report["rolled_back"]
        assert reg.resolve("m", "prod")[0] == v2
        assert router.current_tag == "m:v2"
        router.shutdown()


# ---------------------------------------------------------------------------
# lifecycle, metrics, chaos plumbing
# ---------------------------------------------------------------------------

class TestLifecycle:
    def test_shutdown_resolves_outstanding_and_rejects_new(self):
        router, (a, b) = _router(manual=True)
        fut = router.output_async([0])
        router.shutdown(shutdown_hosts=True)
        with pytest.raises(ServingUnavailableError):
            fut.result(timeout=5)
        late = router.output_async([1])
        with pytest.raises(ServingUnavailableError):
            late.result(timeout=5)
        assert a.shutdowns == 1 and b.shutdowns == 1

    def test_fleet_metrics_land_in_global_registry(self):
        from deeplearning4j_tpu_torch.obs.metrics import get_registry

        router, _ = _router()
        router.output_async([0]).result(timeout=5)
        name = router.metrics.global_name
        assert name.startswith("fleet")
        snap = get_registry().snapshot()
        fleet = snap["collected"][name]
        assert fleet["counters"]["delivered"] >= 1
        assert fleet["hosts_up"] == 2
        router.shutdown()

    def test_metrics_snapshot_shape(self):
        router, _ = _router()
        router.output_async([0]).result(timeout=5)
        snap = router.metrics_snapshot()
        assert snap["queue_depth"] == 0
        assert set(snap["hosts"]) == {"h0", "h1"}
        assert "fleet_e2e_ms" in snap and snap["model"] == "m:v1"
        m = FleetMetrics()
        m.inc("requests", 3)
        assert m.snapshot()["counters"]["requests"] == 3

    def test_watchdog_thread_expires_timeouts_without_poke(self):
        router = FleetRouter(request_timeout_s=0.05, max_retries=0,
                             watchdog_interval_s=0.01)
        slow = _FakeEngine(manual=True)
        router.add_host("slow", engine=slow)
        fut = router.output_async([0])
        with pytest.raises(FleetTimeoutError):
            fut.result(timeout=10)
        router.shutdown()


class TestFleetChaosPlumbing:
    def test_rejects_non_fleet_kinds(self):
        with pytest.raises(ValueError, match="fleet"):
            FleetChaos(FaultSchedule.scripted(
                {1: FaultKind.REPLICA_CRASH}))

    def test_pop_request_is_indexed_and_logged(self):
        chaos = FleetChaos(FaultSchedule.scripted(
            {2: FaultKind.HOST_KILL, 3: FaultKind.HOST_PREEMPT}))
        assert chaos.pop_request() == []
        assert chaos.pop_request() == [FaultKind.HOST_KILL]
        assert chaos.pop_request() == [FaultKind.HOST_PREEMPT]
        assert chaos.injected() == 2
        assert chaos.injected(FaultKind.HOST_KILL) == 1
        assert chaos.events[0]["request"] == 2


# ---------------------------------------------------------------------------
# HTTP surface: UIServer front, HttpHost remote, serve --fleet CLI
# ---------------------------------------------------------------------------

class TestFleetHttp:
    def test_ui_server_fronts_a_router(self):
        from deeplearning4j_tpu_torch.ui import UIServer

        router = FleetRouter(start_watchdog=False)
        for i in range(2):
            router.add_host(f"h{i}", engine=Engine(
                _mlp(), max_batch=4, slo_ms=10_000, replicas=1, device="cpu").load())
        server = UIServer(port=0).attach_engine(router).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            req = urllib.request.Request(
                base + "/predict",
                data=json.dumps({"inputs": [[0.1] * 12] * 2}).encode(),
                headers={"Content-Type": "application/json"})
            r = json.loads(urllib.request.urlopen(req, timeout=10).read())
            assert len(r["outputs"]) == 2 and len(r["outputs"][0]) == 3
            h = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=5).read())
            assert h["kind"] == "fleet" and h["ready"] is True
            assert set(h["hosts"]) == {"h0", "h1"}
            m = json.loads(urllib.request.urlopen(
                base + "/metrics", timeout=5).read())
            fleet_snaps = [s for s in m["serving"] if "hosts_up" in s]
            assert fleet_snaps and fleet_snaps[0]["hosts_up"] == 2
        finally:
            server.stop()
            router.shutdown(shutdown_hosts=True)

    def test_http_host_routes_through_a_remote_server(self):
        from deeplearning4j_tpu_torch.ui import UIServer

        eng = Engine(_mlp(), max_batch=4, slo_ms=10_000, replicas=1, device="cpu").load()
        server = UIServer(port=0).attach_engine(eng).start()
        router = FleetRouter(start_watchdog=False)
        try:
            remote = HttpHost(f"http://127.0.0.1:{server.port}",
                              timeout_s=10.0)
            router.add_host("remote", engine=remote)
            x = np.random.default_rng(0).normal(size=(2, 12)).astype(
                np.float32)
            got = router.output(x, slo_ms=10_000)
            np.testing.assert_allclose(got, np.asarray(eng.output(x)),
                                       rtol=1e-5)
            assert router.current_tag == eng.current_tag
            health = router.health_snapshot()
            assert health["ready"] is True
            depth = remote.metrics_snapshot()["queue_depth"]
            assert depth == 0
        finally:
            router.shutdown()
            server.stop()
            eng.shutdown()

    def test_http_host_unreachable_reports_unready(self):
        dead = HttpHost("http://127.0.0.1:9", timeout_s=0.5)
        snap = dead.health_snapshot()
        assert snap["ready"] is False
        dead.shutdown()


class TestServeCli:
    def test_fleet_flag_builds_a_router(self):
        from deeplearning4j_tpu_torch.cli import build_parser

        args = build_parser().parse_args(
            ["serve", "--fleet", "127.0.0.1:9001,127.0.0.1:9002",
             "--max-retries", "2"])
        assert args.fn.__name__ == "cmd_serve"
        assert args.fleet == "127.0.0.1:9001,127.0.0.1:9002"
        assert args.model is None

    def test_serve_without_model_or_fleet_rejected(self):
        from deeplearning4j_tpu_torch.cli import main

        with pytest.raises(SystemExit, match="--model"):
            main(["serve"])

    def test_launch_serve_flag_assigns_stable_ports(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel.distributed import ENV_SERVE_PORT
        from deeplearning4j_tpu_torch.parallel.launcher import PodLauncher

        launcher = PodLauncher(
            [sys.executable, "-c", "pass"], num_workers=2,
            run_dir=str(tmp_path), serve=True)
        eps = launcher.serve_endpoints()
        assert len(eps) == 2 and all(":" in e for e in eps)
        ports = [int(e.split(":")[1]) for e in eps]
        assert len(set(ports)) == 2

        class _H:
            process_id = 1
            incarnation = 0
        env = launcher._env_for(_H())
        assert env[ENV_SERVE_PORT] == str(ports[1])
        # no --serve: the env contract stays absent
        plain = PodLauncher([sys.executable, "-c", "pass"], num_workers=2,
                            run_dir=str(tmp_path))
        assert plain.serve_ports is None
        with pytest.raises(RuntimeError):
            plain.serve_endpoints()
        assert ENV_SERVE_PORT not in plain._env_for(_H())


# ---------------------------------------------------------------------------
# lockstep against the reference router
# ---------------------------------------------------------------------------

def _packages():
    from deeplearning4j_tpu import serving as jserving
    from deeplearning4j_tpu_torch import serving as tserving
    return [("port", tserving), ("reference", jserving)]


def _lockstep_script(serving):
    """One request script over four fake hosts: round robin, cached depth,
    sessions, retries (host fault, shed, non-retryable), the breaker, a
    timeout with a late straggler, a drain, decode routing, a rolling
    swap with roll-back.  Returns (log, counters, host states, tags)."""
    clock = _Clock()
    router = serving.FleetRouter(start_watchdog=False, clock=clock, max_retries=2,
                                 request_timeout_s=1.0, breaker_threshold=2)
    engines = [_FakeEngine(tag="m:v1") for _ in range(3)] + [_FakeDecode(tag="d:v1")]
    for i, eng in enumerate(engines[:3]):
        router.add_host(f"h{i}", engine=eng)
    router.add_host("d0", decode=engines[3])
    names = ["h0", "h1", "h2", "d0"]
    log = []

    def run(i, kind="predict", **kw):
        before = [len(e.calls) for e in engines]
        fut = (router.generate_async([i], **kw) if kind == "decode"
               else router.output_async([i], **kw))
        try:
            res = fut.result(timeout=5) if fut.done() else "pending"
        except Exception as exc:
            res = type(exc).__name__
        served = tuple(n for n, e, b in zip(names, engines, before) if len(e.calls) > b)
        log.append((i, kind, served, res))
        return fut

    for i in range(6):
        run(i)
    engines[0].depth = 5
    clock.t += 0.1
    router.poke(now=clock())
    for i in range(6, 10):
        run(i)
    engines[0].depth = 0
    clock.t += 0.1
    router.poke(now=clock())
    for k in range(10):
        run(100 + k, session=f"s{k}")
        run(200 + k, session=f"s{k}")
    def steer(target):
        for j, e in enumerate(engines[:3]):
            e.depth = 0 if j == target else 100
        clock.t += 0.1                     # past the depth-poll cadence
        router.poke(now=clock())

    steer(1)
    engines[1].fail_next = 1
    run(300)
    steer(2)
    engines[2].fail_next, engines[2].exc_type = 1, serving.OverloadedError
    run(301)
    steer(0)
    engines[0].fail_next, engines[0].exc_type = 1, ValueError
    run(302)
    engines[0].exc_type = RuntimeError
    engines[0].fail_next = 10
    for i in range(303, 306):
        steer(0)
        run(i)
    router.mark_host_up("h0")
    engines[0].fail_next = 0
    steer(1)
    engines[1].manual = True
    futs = [run(i) for i in range(400, 403)]
    clock.t += 2.0
    router.poke(now=clock())
    for p in engines[1].pending:
        p.set_result("late-from-h1")
    engines[1].manual = False
    log.append(("timeouts", tuple(f.result(timeout=5) for f in futs)))
    steer(-1)
    router.drain_host("h2", timeout_s=1.0)
    for i in range(500, 504):
        run(i)
    router.undrain_host("h2")
    for i in range(600, 603):
        run(i, kind="decode")
    engines[2].swap_exc = RuntimeError("host died mid-swap")
    report = router.rolling_swap(object(), "m:v2", rollback_model=object(),
                                 rollback_tag="m:v1")
    log.append(("swap", report["ok"], report["failed_host"], tuple(report["swapped"]),
                report["rolled_back"]))
    for i in range(700, 704):
        run(i)
    counters = router.metrics.snapshot()["counters"]
    states = router.hosts()
    tags = router.tags()
    traffic = router.model_traffic()
    router.shutdown()
    return log, counters, states, tags, traffic


def test_lockstep_dispatch_is_the_references():
    (_, port), (_, ref) = _packages()
    got, want = _lockstep_script(port), _lockstep_script(ref)
    for g, w in zip(got, want):
        assert g == w
    log, counters = got[0], got[1]
    assert counters["timeouts"] == counters["late_discards"] == 3
    assert counters["retries"] == 7 and counters["failed"] == 1
    assert counters["host_down"] == 3 and counters["host_up"] == 1
    assert counters["rollbacks"] == 1 and counters["affinity_routed"] == 20


def test_session_ring_is_the_references():
    (_, port), (_, ref) = _packages()
    routers = []
    for serving in (port, ref):
        r = serving.FleetRouter(start_watchdog=False)
        for i in range(5):
            r.add_host(f"host-{i}", engine=_FakeEngine())
        routers.append(r)
    try:
        assert routers[0]._ring == routers[1]._ring
        for k in range(300):
            key = f"session-{k}"
            a = routers[0]._ring_lookup_locked(key, "predict", set())
            b = routers[1]._ring_lookup_locked(key, "predict", set())
            assert a.host_id == b.host_id
    finally:
        for r in routers:
            r.shutdown()


def test_serving_exports_are_the_references_but_the_lifecycle():
    """``serving.__all__`` is the reference's; the promotion pipeline's
    names, once left out, are ported (``serving/lifecycle.py``)."""
    from deeplearning4j_tpu import serving as jserving
    from deeplearning4j_tpu_torch import serving as tserving

    lifecycle = {"EvalGate", "PipelineJournal", "PipelineStageError", "PromotionPipeline",
                 "StageDeadlineError", "data_fingerprint", "weights_sha"}
    assert set(tserving.__all__) == set(jserving.__all__)
    assert lifecycle <= set(tserving.__all__)
    assert all(hasattr(tserving, n) for n in tserving.__all__)
