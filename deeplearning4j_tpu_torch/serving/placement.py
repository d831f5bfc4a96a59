"""Traffic-driven model placement: which host serves which model
(mirrors ``deeplearning4j_tpu/serving/placement.py``).

With multi-model engines (``Engine.add_model`` / ``DecodeEngine.add_model``)
a model load is a cheap, bounded operation, so where a model runs is a
scheduling decision.  ``PlacementController`` closes that loop over one
``FleetRouter``:

* Demand: per-model submit counts drained from
  ``router.model_traffic(reset=True)`` each tick, folded into an EWMA.
* Control law: one ``ReplicaAutoscaler`` per model answers "+1 / 0 / -1
  hosts" from its EWMA demand against the hosts it has now, within
  ``[min_hosts, max_hosts]``.
* Actuation: widening picks the least-crowded up host not placing the
  model and calls ``add_model_from_registry``; narrowing evicts it from
  the most-crowded placing host through ``remove_model`` (which drains:
  nothing stranded, no version mixing).  A model idle longer than
  ``evict_idle_s`` is evicted everywhere.
* Demand reload: the router's ``set_model_miss_handler`` hook calls
  ``on_model_miss`` when a request names a model no up host places; the
  controller loads it on the best host and dispatch re-picks, so an
  evicted model costs its next request a load, not an error.

The controller owns no thread: call ``tick`` at any cadence.  Clocks
are injectable.  An engine's default model is outside its authority and
is never evicted.  Every move emits a ``tenant/placement`` instant (add
or evict, model, host); a demand reload also ``tenant/demand_load``.
Fleet counters: ``placements``, ``placement_evictions``,
``demand_loads``, ``model_misses``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import trace as obs_trace
from .autoscale import ReplicaAutoscaler


class PlacementController:
    """Maps (model, host) assignments from observed per-model traffic.

    ``registry`` supplies the inventory (``models_snapshot``) and the
    checkpoints/warm bundles; ``router`` supplies the fleet, the traffic
    signal, and the miss hook.  ``models`` restricts authority to an
    explicit set (default: every registry name) — the controller never
    touches a model it does not manage, and never an engine's default
    model.
    """

    def __init__(self, router, registry, *,
                 models: Optional[List[str]] = None,
                 kind: str = "predict",
                 ref: str = "prod",
                 min_hosts: int = 1,
                 max_hosts: Optional[int] = None,
                 up_load: float = 8.0,
                 down_load: float = 1.0,
                 up_ticks: int = 2,
                 down_ticks: int = 4,
                 cooldown_s: float = 2.0,
                 evict_idle_s: Optional[float] = None,
                 ewma_alpha: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        if kind not in ("predict", "decode"):
            raise ValueError(f"kind must be predict or decode, got {kind!r}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.router = router
        self.registry = registry
        self.kind = kind
        self.ref = ref
        self.min_hosts = int(min_hosts)
        self.max_hosts = max_hosts
        self.evict_idle_s = evict_idle_s
        self.ewma_alpha = float(ewma_alpha)
        self.clock = clock
        self._lock = threading.Lock()
        self._managed: List[str] = list(
            models if models is not None else registry.names())
        self._ewma: Dict[str, float] = {}
        self._scalers: Dict[str, ReplicaAutoscaler] = {}
        self._scaler_kw = dict(up_load=up_load, down_load=down_load,
                               up_ticks=up_ticks, down_ticks=down_ticks,
                               cooldown_s=cooldown_s)
        self._log: List[dict] = []
        router.set_model_miss_handler(self.on_model_miss)

    # -- views -----------------------------------------------------------

    def managed_models(self) -> List[str]:
        with self._lock:
            return list(self._managed)

    def manage(self, name: str) -> None:
        """Bring a (new) registry model under placement authority."""
        with self._lock:
            if name not in self._managed:
                self._managed.append(name)

    def placement(self) -> Dict[str, List[str]]:
        """model -> [host_id] for every managed model (live view from
        the fleet, not a shadow copy — restarts and manual add_model
        calls are always reflected)."""
        mm = self.router.model_map()
        with self._lock:
            managed = list(self._managed)
        out: Dict[str, List[str]] = {m: [] for m in managed}
        for hid, placed in mm.items():
            for m in placed:
                if m in out:
                    out[m].append(hid)
        return out

    def snapshot(self) -> dict:
        """Controller state for /metrics."""
        with self._lock:
            ewma = dict(self._ewma)
            log = list(self._log[-16:])
        return {"placement": self.placement(), "demand_ewma": ewma,
                "recent_moves": log}

    # -- control ---------------------------------------------------------

    def _scaler_for(self, name: str, n_hosts_up: int) -> ReplicaAutoscaler:
        s = self._scalers.get(name)
        cap = (self.max_hosts if self.max_hosts is not None
               else max(1, n_hosts_up))
        if s is None or s.max_replicas != cap:
            s = ReplicaAutoscaler(min_replicas=self.min_hosts,
                                  max_replicas=cap, clock=self.clock,
                                  **self._scaler_kw)
            self._scalers[name] = s
        return s

    def tick(self) -> List[dict]:
        """One control round: fold fresh traffic into the EWMA, run each
        managed model's control law, actuate at most one move per model.
        Returns the moves made (also kept in :meth:`snapshot`)."""
        traffic = self.router.model_traffic(reset=True)
        placement = self.placement()
        hosts_up = [hid for hid, st in self.router.hosts().items()
                    if st == "up"]
        now = self.clock()
        moves: List[dict] = []
        with self._lock:
            managed = list(self._managed)
            for m in managed:
                prev = self._ewma.get(m, 0.0)
                self._ewma[m] = (self.ewma_alpha * traffic.get(m, 0)
                                 + (1.0 - self.ewma_alpha) * prev)
        for m in managed:
            holders = placement.get(m, [])
            with self._lock:
                demand = self._ewma[m]
                scaler = self._scaler_for(m, len(hosts_up))
            if self._idle_evictable(m, holders, now):
                for hid in holders:
                    if self._evict(m, hid, reason="idle"):
                        moves.append({"op": "evict", "model": m,
                                      "host": hid, "reason": "idle"})
                continue
            # demand is request-rate-shaped; replicas = current holders.
            # queue_depth=demand / inflight=0 reuses the autoscaler's
            # (queue+inflight)/replicas law unchanged.
            verdict = scaler.observe(int(demand), 0, max(1, len(holders)))
            if verdict > 0 and len(holders) < len(hosts_up):
                hid = self._pick_target(m, holders, hosts_up)
                if hid is not None and self._load(m, hid):
                    moves.append({"op": "add", "model": m, "host": hid,
                                  "reason": "hot"})
            elif verdict < 0 and len(holders) > self.min_hosts:
                hid = self._pick_victim(m, holders)
                if hid is not None and self._evict(m, hid, reason="cool"):
                    moves.append({"op": "evict", "model": m, "host": hid,
                                  "reason": "cool"})
        if moves:
            with self._lock:
                self._log.extend(moves)
                if len(self._log) > 256:
                    del self._log[:128]
        return moves

    def _idle_evictable(self, m: str, holders: List[str],
                        now: float) -> bool:
        if self.evict_idle_s is None or not holders:
            return False
        with self._lock:
            if self._ewma.get(m, 0.0) > 0.5:
                return False
        for hid in holders:
            eng = self._engine_on(hid)
            lu = getattr(eng, "model_last_used", None)
            t = lu(m) if lu is not None else None
            if t is not None and now - t < self.evict_idle_s:
                return False
        return True

    # -- actuation -------------------------------------------------------

    def _engine_on(self, host_id: str):
        h = self.router.host(host_id)
        return h.engine_for(self.kind) if h is not None else None

    def _pick_target(self, m: str, holders: List[str],
                     hosts_up: List[str]) -> Optional[str]:
        """Least-crowded up host that supports the kind and does not
        already place the model."""
        best, best_n = None, None
        mm = self.router.model_map()
        for hid in hosts_up:
            if hid in holders:
                continue
            eng = self._engine_on(hid)
            if eng is None or not hasattr(eng, "add_model"):
                continue
            n = len(mm.get(hid, {}))
            if best_n is None or n < best_n:
                best, best_n = hid, n
        return best

    def _pick_victim(self, m: str, holders: List[str]) -> Optional[str]:
        """Most-crowded placing host gives the model up first."""
        mm = self.router.model_map()
        ranked = sorted(holders, key=lambda h: -len(mm.get(h, {})))
        return ranked[0] if ranked else None

    def _load(self, m: str, host_id: str, demand: bool = False) -> bool:
        eng = self._engine_on(host_id)
        if eng is None:
            return False
        try:
            if hasattr(eng, "add_model_from_registry"):
                eng.add_model_from_registry(self.registry, m, self.ref)
            else:
                _, model = self.registry.resolve(m, self.ref)
                eng.add_model(m, model)
        # graftcheck: disable=GC403 (registry.resolve is a model-version lookup, not a future resolution; a failed load is logged and the tick/miss path degrades typed)
        except Exception as exc:
            with self._lock:
                self._log.append({"op": "add_failed", "model": m,
                                  "host": host_id,
                                  "error": f"{type(exc).__name__}: {exc}"})
            return False
        self.router.metrics.inc("demand_loads" if demand else "placements")
        obs_trace.instant("tenant/placement", cat="fleet", op="add",
                          model=m, host=host_id, demand=demand)
        return True

    def _evict(self, m: str, host_id: str, reason: str = "cool") -> bool:
        eng = self._engine_on(host_id)
        if eng is None or not hasattr(eng, "remove_model"):
            return False
        try:
            ok = bool(eng.remove_model(m))
        except Exception as exc:
            with self._lock:
                self._log.append({"op": "evict_failed", "model": m,
                                  "host": host_id,
                                  "error": f"{type(exc).__name__}: {exc}"})
            return False
        if ok:
            self.router.metrics.inc("placement_evictions")
            obs_trace.instant("tenant/placement", cat="fleet", op="evict",
                              model=m, host=host_id, reason=reason)
        return ok

    # -- demand reload ----------------------------------------------------

    def on_model_miss(self, model: str, kind: str) -> bool:
        """Router hook: a request named a model no up host places.
        Load it on the best host now and return True so dispatch
        re-picks.
        Unmanaged/unknown models return False — the request fails typed
        rather than side-loading something placement does not own."""
        if kind != self.kind:
            return False
        with self._lock:
            if model not in self._managed:
                return False
        holders = self.placement().get(model, [])
        if holders:
            return True     # raced a concurrent load: just re-pick
        hosts_up = [hid for hid, st in self.router.hosts().items()
                    if st == "up"]
        hid = self._pick_target(model, holders, hosts_up)
        if hid is None:
            return False
        t0 = self.clock()
        if not self._load(model, hid, demand=True):
            return False
        obs_trace.instant("tenant/demand_load", cat="fleet", model=model,
                          host=hid, load_ms=(self.clock() - t0) * 1e3)
        with self._lock:
            self._log.append({"op": "demand_load", "model": model,
                              "host": hid})
        return True
