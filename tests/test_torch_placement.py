"""Traffic-driven model placement in the port against the JAX package's
(``tests/test_placement.py``'s scenarios on ``deeplearning4j_tpu_torch``,
plus a lockstep test: both controllers make the same moves under one
demand script).

Duck-typed constant models (the response value is the model's identity,
so version or model mixing is visible) and injected clocks drive the
controller's widen / narrow / idle-evict / demand-reload decisions
deterministically.
"""

import time
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.serving import (
    Engine, FleetRouter, ModelNotLoadedError, ModelRegistry,
    PlacementController,
)


class _Conf:
    input_type = InputType.feed_forward(3)


class _ConstModel:
    """Output value identifies the model; the conf gives
    ``Engine.add_model`` its per-example shape."""

    conf = _Conf()

    def __init__(self, val):
        self.val = float(val)

    def output(self, x):
        return np.full((x.shape[0], 1), self.val, np.float32)


def _registry():
    reg = ModelRegistry(device="cpu")
    for name, val in (("m1", 1.0), ("m2", 2.0), ("m3", 3.0)):
        v = reg.register(name, _ConstModel(val))
        reg.set_alias(name, "prod", v)
    return reg


def _engine(reg, default="m1", **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("slo_ms", 10_000)
    kw.setdefault("replicas", 1)
    eng = Engine.from_registry(reg, default, device="cpu", **kw)
    eng.load(input_shape=(3,))
    return eng


X = np.zeros((1, 3), np.float32)


class TestRegistryInventory:
    def test_list_aliases_is_the_deployable_view(self):
        reg = _registry()
        aliases = reg.list_aliases()
        assert set(aliases) == {"m1", "m2", "m3"}
        assert aliases["m1"] == {"prod": 1}
        reg.register("m4", _ConstModel(4.0))    # no alias -> omitted
        assert "m4" not in reg.list_aliases()

    def test_models_snapshot_inventory(self):
        reg = _registry()
        reg.register("m1", _ConstModel(1.5))    # v2; prod stays at v1
        snap = reg.models_snapshot()
        assert set(snap) == {"m1", "m2", "m3"}
        assert snap["m1"]["versions"] == [1, 2]
        assert snap["m1"]["pinned"] == 1
        assert snap["m1"]["aliases"] == {"prod": 1}
        assert snap["m2"]["last_access"] is None   # never resolved
        reg.resolve("m2", "prod")
        assert reg.models_snapshot()["m2"]["last_access"] is not None


class TestMultiModelEngine:
    def test_add_model_places_and_routes(self):
        reg = _registry()
        eng = _engine(reg)
        eng.add_model_from_registry(reg, "m2", input_shape=(3,))
        assert eng.has_model("m2") and eng.has_model("m1")
        assert set(eng.placed_models()) == {"m1", "m2"}
        assert eng.placed_models()["m2"] == "m2:v1"
        out1 = eng.output_async(X).result(timeout=10)
        out2 = eng.output_async(X, model="m2").result(timeout=10)
        assert float(out1[0, 0]) == 1.0 and float(out2[0, 0]) == 2.0
        assert eng.model_last_used("m2") is not None
        eng.shutdown()

    def test_add_model_rejects_duplicates_and_default(self):
        reg = _registry()
        eng = _engine(reg)
        eng.add_model("m2", _ConstModel(2.0), input_shape=(3,))
        with pytest.raises(ValueError, match="already placed"):
            eng.add_model("m2", _ConstModel(9.0), input_shape=(3,))
        with pytest.raises(ValueError, match="already placed"):
            eng.add_model("m1", _ConstModel(9.0), input_shape=(3,))
        eng.shutdown()

    def test_remove_model_evicts_but_never_the_default(self):
        reg = _registry()
        eng = _engine(reg)
        eng.add_model("m2", _ConstModel(2.0), input_shape=(3,))
        assert eng.remove_model("m2") is True
        assert not eng.has_model("m2")
        assert eng.remove_model("m2") is False      # already gone
        with pytest.raises(ModelNotLoadedError):
            eng.output_async(X, model="m2").result(timeout=10)
        with pytest.raises(ValueError, match="default model"):
            eng.remove_model("m1")
        eng.shutdown()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestPlacementController:
    def _fleet(self, reg, n=2):
        router = FleetRouter(max_retries=2)
        engines = []
        for i in range(n):
            eng = _engine(reg)
            engines.append(eng)
            router.add_host(f"h{i}", engine=eng)
        return router, engines

    def test_widen_on_demand_then_idle_evict(self):
        reg = _registry()
        router, engines = self._fleet(reg)
        engines[0].add_model_from_registry(reg, "m2", input_shape=(3,))
        clk = _Clock()
        ctl = PlacementController(
            router, reg, models=["m2"], up_load=4.0, up_ticks=1,
            down_ticks=1000, cooldown_s=0.0, evict_idle_s=5.0,
            ewma_alpha=1.0, clock=clk)
        # hot: demand 20/tick over 1 holder >> up_load -> widen to h1
        for _ in range(20):
            router.output_async(X, model="m2").result(timeout=10)
        moves = ctl.tick()
        assert {"op": "add", "model": "m2", "host": "h1",
                "reason": "hot"} in moves
        assert sorted(ctl.placement()["m2"]) == ["h0", "h1"]
        assert engines[1].output_async(
            X, model="m2").result(timeout=10)[0, 0] == 2.0
        # idle: no traffic, last_used ages past evict_idle_s -> evicted
        # from EVERY holder (idle eviction bypasses min_hosts).  The
        # engines stamp last_used on THEIR clock (real monotonic), so
        # idle-age the controller clock past that.
        clk.t = time.monotonic() + 1000.0
        moves = ctl.tick()
        assert sorted(m["host"] for m in moves
                      if m["op"] == "evict") == ["h0", "h1"]
        assert ctl.placement()["m2"] == []
        router.shutdown(shutdown_hosts=True)

    def test_demand_reload_on_model_miss(self):
        """An evicted model's next request demand-reloads it through the
        router's miss hook — one latency bump, not an error."""
        reg = _registry()
        router, engines = self._fleet(reg)
        ctl = PlacementController(router, reg, models=["m3"],
                                  clock=_Clock())
        assert ctl.placement()["m3"] == []
        out = router.output_async(X, model="m3").result(timeout=10)
        assert float(out[0, 0]) == 3.0
        assert len(ctl.placement()["m3"]) == 1
        c = router.metrics_snapshot()["counters"]
        assert c.get("model_misses", 0) >= 1
        assert c.get("demand_loads", 0) == 1
        router.shutdown(shutdown_hosts=True)

    def test_unmanaged_model_miss_fails_typed(self):
        reg = _registry()
        router, _ = self._fleet(reg)
        PlacementController(router, reg, models=["m2"], clock=_Clock())
        with pytest.raises(ModelNotLoadedError):
            router.output_async(X, model="m3").result(timeout=10)
        router.shutdown(shutdown_hosts=True)

    def test_no_mixing_across_models_under_load(self):
        reg = _registry()
        router, engines = self._fleet(reg)
        engines[0].add_model_from_registry(reg, "m2", input_shape=(3,))
        engines[1].add_model_from_registry(reg, "m2", input_shape=(3,))
        futs = [(m, router.output_async(X, model=m if m != "m1" else None))
                for _ in range(50) for m in ("m1", "m2")]
        want = {"m1": 1.0, "m2": 2.0}
        for m, f in futs:
            assert float(f.result(timeout=30)[0, 0]) == want[m]
        router.shutdown(shutdown_hosts=True)

    def test_manage_and_snapshot(self):
        reg = _registry()
        router, _ = self._fleet(reg, n=1)
        ctl = PlacementController(router, reg, models=["m2"],
                                  clock=_Clock())
        assert ctl.managed_models() == ["m2"]
        ctl.manage("m3")
        assert "m3" in ctl.managed_models()
        snap = ctl.snapshot()
        assert set(snap) == {"placement", "demand_ewma", "recent_moves"}
        assert set(snap["placement"]) == {"m2", "m3"}
        router.shutdown(shutdown_hosts=True)


# ---------------------------------------------------------------------------
# lockstep against the reference controller
# ---------------------------------------------------------------------------

class _PlaceEngine:
    """A host engine that places named models instantly: enough for the
    router and the controller, and the same object for both packages."""

    def __init__(self):
        self.placed = {}

    def output_async(self, x, slo_ms=None, model=None, tenant=None):
        f = Future()
        f.set_result(self.placed.get(model, "default"))
        return f

    def has_model(self, name):
        return name is None or name in self.placed

    def placed_models(self):
        return dict(self.placed, **{"": "default"})

    def add_model(self, name, model, tag=None):
        self.placed[name] = tag or name

    def add_model_from_registry(self, registry, name, ref="prod"):
        version, model = registry.resolve(name, ref)
        self.add_model(name, model, tag=f"{name}:v{version}")

    def remove_model(self, name):
        return self.placed.pop(name, None) is not None

    def model_last_used(self, name):
        return 0.0 if name in self.placed else None

    @property
    def current_tag(self):
        return "default"

    def metrics_snapshot(self):
        return {"queue_depth": 0}

    def health_snapshot(self):
        return {"status": "ok", "ready": True}


def _placement_script(serving):
    reg = serving.ModelRegistry(**({"device": "cpu"} if serving.__name__.endswith(
        "_torch.serving") else {}))
    for name in ("m1", "m2", "m3"):
        reg.set_alias(name, "prod", reg.register(name, object()))
    router = serving.FleetRouter(start_watchdog=False, max_retries=2)
    engines = [_PlaceEngine() for _ in range(3)]
    for i, e in enumerate(engines):
        router.add_host(f"h{i}", engine=e)
    engines[0].add_model_from_registry(reg, "m2")
    clk = _Clock()
    ctl = serving.PlacementController(
        router, reg, models=["m2", "m3"], up_load=4.0, down_load=1.0, up_ticks=1,
        down_ticks=2, cooldown_s=0.0, evict_idle_s=50.0, ewma_alpha=0.5, clock=clk)
    log = []
    x = np.zeros((1, 3), np.float32)
    demand = [{"m2": 20}, {"m2": 20, "m3": 1}, {"m2": 12}, {"m2": 2}, {}, {}, {"m3": 9},
              {}, {}, {}]
    for t, round_ in enumerate(demand):
        clk.t = 10.0 * t
        for m, n in round_.items():
            for _ in range(n):
                log.append(("serve", m, router.output_async(x, model=m).result(timeout=5)))
        log.append(("tick", t, [sorted(mv.items()) for mv in ctl.tick()]))
        log.append(("placement", t, {m: sorted(h) for m, h in ctl.placement().items()}))
    counters = router.metrics_snapshot()["counters"]
    snap = ctl.snapshot()
    router.shutdown()
    return log, counters, snap["demand_ewma"]


def test_lockstep_moves_are_the_references():
    from deeplearning4j_tpu import serving as jserving
    from deeplearning4j_tpu_torch import serving as tserving

    got, want = _placement_script(tserving), _placement_script(jserving)
    assert got == want
    moves = [m for kind, _, ms in (e for e in got[0] if e[0] == "tick") for m in ms]
    ops = {dict(m)["op"] for m in moves}
    assert {"add", "evict"} <= ops
    assert got[1]["demand_loads"] == 2 and got[1]["placements"] == 3
    assert got[1]["placement_evictions"] >= 1
