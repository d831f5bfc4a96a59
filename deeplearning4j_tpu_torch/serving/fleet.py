"""Fleet-level serving router: cross-host dispatch, failover, and
rolling swap under live traffic (mirrors
``deeplearning4j_tpu/serving/fleet.py``).

  FleetRouter   the serving-engine duck type (``output`` /
                ``output_async`` / ``generate_async`` / ``current_tag`` /
                ``metrics_snapshot`` / ``health_snapshot``), so
                ``UIServer.attach_engine(router)`` puts a whole fleet
                behind one ``POST /predict``.
  FleetHost     one host: an ``Engine`` and/or a ``DecodeEngine`` plus the
                router's view of it (up / draining / down), its live load
                and its run of consecutive failures.
  HttpHost      the same duck type over a remote ``UIServer`` (``serve
                --fleet host:port,...``): POST /predict on a small worker
                pool, /metrics and /healthz proxied.

Routing is least-loaded: the router's own in-flight count per host plus
the host's ``queue_depth`` from its metrics snapshot, polled on a
cadence; ties go round-robin.  A request with a ``session`` key rides a
consistent-hash ring (64 virtual nodes a host, blake2b-64 of
``"<host>#<i>"``), so a session's KV pages stay on one host while it
lives.  Decode requests route in two stages when the fleet has
decode-role hosts: a prompt goes to a prefill or unified host, and a
``PrefillHandoff`` it returns goes on to a decode-role sink scored by its
free slots and pages.

Failover: a host fault (a crash surfacing through the engine's future,
an admission shed, a per-request timeout, a dead heartbeat) retries the
request on another host, bounded by ``max_retries`` and the request's
deadline, preferring hosts not yet tried.  Delivery is at most once: the
caller's future is resolved first-writer-wins, so a straggler that
completes after its request was rerouted is a counted
``late_discards``, never a second delivery.  Every future resolves.
Deterministic request errors (poison, deadline, bad input, a tenant's own
quota) fail fast without a retry.  Consecutive faults trip a host's
circuit breaker.

Hosts go down three ways: their futures failing, the watchdog's
per-request timeouts (the only signal an unreachable HTTP host gives),
and the heartbeat ledger (``membership=``): a process that stops beating
is down, one marked leaving is drained first.  ``rolling_swap`` /
``promote`` walk the fleet host by host (drain, ``swap_model``,
undrain); a host that dies mid-swap is marked down and the hosts already
swapped roll back, so the fleet never serves two versions past the
call.  ``promote`` moves the registry alias only after every host
swapped.

Clocks are injectable (``clock=``, monotonic seconds); tests drive the
watchdog synchronously with ``poke(now=...)`` and
``start_watchdog=False``.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as obs_trace
from .batcher import DeadlineExceededError, OverloadedError
from .decode import PrefillHandoff
from .engine import (ModelNotLoadedError, PoisonInputError,
                     ServingUnavailableError, _fail_safe, _set_safe)
from .metrics import FleetMetrics
from .tenancy import TenantOverloadedError


class FleetTimeoutError(RuntimeError):
    """A dispatched attempt exceeded the per-request host timeout; the
    router re-routed it (or failed it typed if retries were spent)."""


# deterministic request errors: the same input fails the same way on any
# host, so a retry would only spend a peer's capacity.  A tenant's own
# quota is back-pressure on the tenant, not host capacity: retrying it on
# a peer would let a bursting tenant pass its shed traffic through the
# retry budget.
_NON_RETRYABLE = (PoisonInputError, DeadlineExceededError, ValueError,
                  TypeError, KeyError, TenantOverloadedError)


def _hash64(s: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


def _tag_of(engine) -> str:
    try:
        return str(engine.current_tag)
    except Exception:
        return ""


class FleetHost:
    """One serving host and the router's view of it.  ``engine`` handles
    predict traffic, ``decode`` generation; a host may carry either or
    both.  ``process_id`` links the host to a heartbeat-ledger row so
    the router can watch its liveness."""

    def __init__(self, host_id: str, engine=None, decode=None,
                 process_id: Optional[int] = None):
        if engine is None and decode is None:
            raise ValueError("FleetHost needs an engine and/or a decode "
                             "engine")
        self.host_id = str(host_id)
        self.engine = engine
        self.decode = decode
        self.process_id = process_id
        self.state = "up"              # up | draining | down
        self.planned = False           # down was a planned leave
        self.inflight = 0              # router-dispatched, not yet resolved
        self.failures = 0              # consecutive host faults
        self.last_error: Optional[str] = None
        self.cached_queue_depth = 0    # from the host's /metrics snapshot
        self.depth_read_at: Optional[float] = None
        self.cached_free_slots: Optional[int] = None   # decode-pool gauges,
        self.cached_free_pages: Optional[int] = None   # same poll cadence
        self.cached_pps = 0            # pages a full-length request needs

    def supports(self, kind: str) -> bool:
        return (self.decode if kind == "decode" else self.engine) is not None

    def places(self, model: Optional[str], kind: str = "predict") -> bool:
        """True when the host's engine for ``kind`` currently serves
        ``model`` (None = the default model, always placed).  Engines
        without a ``has_model`` (HTTP hosts on an old build, test
        fakes) place everything — routing degrades to pre-placement
        behavior instead of blackholing."""
        if model is None:
            return True
        eng = self.engine_for(kind)
        has = getattr(eng, "has_model", None)
        if has is None:
            return True
        try:
            return bool(has(model))
        except Exception:
            return False

    def placed_models(self) -> Dict[str, str]:
        """Union of placed model names -> tag over both engines."""
        out: Dict[str, str] = {}
        for eng in (self.engine, self.decode):
            pm = getattr(eng, "placed_models", None)
            if pm is None:
                continue
            try:
                out.update(pm())
            except (OSError, ValueError, KeyError, RuntimeError):
                # a dead/remote engine's view is just absent; the
                # router's health machinery owns reporting that host
                pass
        return out

    def engine_for(self, kind: str):
        return self.decode if kind == "decode" else self.engine

    def decode_role(self) -> str:
        """``unified`` | ``prefill`` | ``decode`` — engines predating
        disaggregation default to unified."""
        if self.decode is None:
            return "unified"
        return getattr(self.decode, "role", "unified")

    def read_decode_pressure(self) -> None:
        """Refresh the decode engine's free-capacity gauges (free slots
        + free KV pages) from its own /metrics snapshot."""
        if self.decode is None:
            return
        try:
            snap = self.decode.metrics_snapshot()
        except Exception as exc:
            self.last_error = f"{type(exc).__name__}: {exc}"
            return
        fs, fp = snap.get("free_slots"), snap.get("free_pages")
        self.cached_free_slots = int(fs) if fs is not None else None
        self.cached_free_pages = int(fp) if fp is not None else None
        self.cached_pps = int(snap.get("pages_per_slot", 0) or 0)

    def decode_pressure(self) -> int:
        """Score penalty from the host's own pool gauges: +1 when no
        decode slot is free (the next admit waits a step), +1 when the
        free list cannot hold one more full-length request.  Hosts that
        never reported gauges (HTTP hosts on an old build) score 0 —
        the pre-disaggregation ordering is unchanged."""
        p = 0
        if self.cached_free_slots is not None and self.cached_free_slots <= 0:
            p += 1
        if (self.cached_free_pages is not None and self.cached_pps
                and self.cached_free_pages < self.cached_pps):
            p += 1
        return p

    def read_queue_depth(self) -> int:
        """The host's own occupancy signal: ``queue_depth`` out of its
        /metrics snapshot (both engine kinds export it)."""
        depth = 0
        for eng in (self.engine, self.decode):
            if eng is None:
                continue
            try:
                depth += int(eng.metrics_snapshot().get("queue_depth", 0))
            except Exception as exc:  # unreachable host: stale depth kept
                self.last_error = f"{type(exc).__name__}: {exc}"
        return depth


class _FleetRequest:
    __slots__ = ("kind", "payload", "session", "slo_ms", "deadline",
                 "future", "tried", "retries", "t_submit", "model",
                 "tenant")

    def __init__(self, kind, payload, session, slo_ms, deadline, future,
                 t_submit, model=None, tenant=None):
        self.kind = kind
        self.payload = payload
        self.session = session
        self.slo_ms = slo_ms
        self.deadline = deadline
        self.future = future
        self.tried: set = set()
        self.retries = 0
        self.t_submit = t_submit
        self.model = model
        self.tenant = tenant


class _Attempt:
    __slots__ = ("aid", "spec", "host", "t_dispatch", "timeout_at",
                 "settled")

    def __init__(self, aid, spec, host, t_dispatch, timeout_at):
        self.aid = aid
        self.spec = spec
        self.host = host
        self.t_dispatch = t_dispatch
        self.timeout_at = timeout_at
        self.settled = False


class FleetRouter:
    """Cross-host router over ``FleetHost``s (see the module docstring
    for routing, failover and swaps)."""

    def __init__(self, hosts: Sequence[FleetHost] = (), *,
                 max_retries: int = 1,
                 request_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 membership=None,
                 metrics: Optional[FleetMetrics] = None,
                 metrics_refresh_s: float = 0.05,
                 membership_refresh_s: float = 0.5,
                 virtual_nodes: int = 64,
                 watchdog_interval_s: float = 0.01,
                 start_watchdog: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.max_retries = int(max_retries)
        self.request_timeout_s = request_timeout_s
        self.breaker_threshold = int(breaker_threshold)
        self.metrics_refresh_s = float(metrics_refresh_s)
        self.membership_refresh_s = float(membership_refresh_s)
        self.virtual_nodes = int(virtual_nodes)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.clock = clock
        self.metrics = metrics or FleetMetrics()
        self._membership = membership
        self._lock = threading.Lock()
        self._idle_cv = threading.Condition(self._lock)
        self._hosts: Dict[str, FleetHost] = {}
        self._ring: List[Tuple[int, str]] = []
        self._outstanding: Dict[int, _Attempt] = {}
        self._aid = 0
        self._rr = 0
        self._shutdown = False
        self._draining = False
        self._last_depth_poll: Optional[float] = None
        self._last_member_poll: Optional[float] = None
        # per-model submit counts since the last drain ("" = default
        # model) — the placement controller's traffic signal
        self._model_traffic: Dict[str, int] = {}
        # placement hook: called (model, kind) when no up host places a
        # requested model — the controller demand-loads, then dispatch
        # re-picks once (serving/placement.py)
        self._on_model_miss: Optional[Callable[[str, str], bool]] = None
        self._stop = threading.Event()
        self._watchdog_thread: Optional[threading.Thread] = None
        for h in hosts:
            self.add_host(h)
        if start_watchdog:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="fleet-watchdog",
                daemon=True)
            self._watchdog_thread.start()

    # -- membership of the fleet itself ---------------------------------

    def add_host(self, host, engine=None, decode=None,
                 process_id: Optional[int] = None) -> FleetHost:
        if not isinstance(host, FleetHost):
            host = FleetHost(host, engine=engine, decode=decode,
                             process_id=process_id)
        with self._lock:
            if host.host_id in self._hosts:
                raise ValueError(f"duplicate host_id {host.host_id!r}")
            self._hosts[host.host_id] = host
            self._rebuild_ring_locked()
            self._gauge_hosts_locked()
        return host

    def remove_host(self, host_id: str,
                    drain_timeout_s: Optional[float] = 5.0) -> None:
        self.drain_host(host_id, timeout_s=drain_timeout_s)
        with self._lock:
            self._hosts.pop(host_id, None)
            self._rebuild_ring_locked()
            self._gauge_hosts_locked()

    def hosts(self) -> Dict[str, str]:
        with self._lock:
            return {hid: h.state for hid, h in self._hosts.items()}

    def host(self, host_id: str) -> Optional[FleetHost]:
        """The live FleetHost record (None if unknown) — the placement
        controller's actuation handle."""
        with self._lock:
            return self._hosts.get(host_id)

    def mark_host_down(self, host_id: str, reason: str = "manual",
                       planned: bool = False) -> None:
        with self._lock:
            host = self._hosts.get(host_id)
            if host is None or host.state == "down":
                return
            host.state = "down"
            host.planned = planned
            self._gauge_hosts_locked()
            self._idle_cv.notify_all()   # unblock a drain waiting on it
        self.metrics.inc("host_down")
        obs_trace.instant("fleet/host_down", cat="fleet", host=host_id,
                          reason=reason, planned=planned)

    def mark_host_up(self, host_id: str) -> None:
        with self._lock:
            host = self._hosts.get(host_id)
            if host is None or host.state == "up":
                return
            host.state = "up"
            host.planned = False
            host.failures = 0
            host.last_error = None
            self._gauge_hosts_locked()
        self.metrics.inc("host_up")
        obs_trace.instant("fleet/host_up", cat="fleet", host=host_id)

    def _gauge_hosts_locked(self) -> None:
        self.metrics.hosts_total.set(len(self._hosts))
        self.metrics.hosts_up.set(
            sum(1 for h in self._hosts.values() if h.state == "up"))

    def _rebuild_ring_locked(self) -> None:
        ring = []
        for hid in self._hosts:
            for i in range(self.virtual_nodes):
                ring.append((_hash64(f"{hid}#{i}"), hid))
        ring.sort()
        self._ring = ring

    # -- the engine duck type -------------------------------------------

    def output(self, x, slo_ms: Optional[float] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        return self.output_async(x, slo_ms=slo_ms, model=model,
                                 tenant=tenant).result()

    def output_async(self, x, slo_ms: Optional[float] = None,
                     session=None, model: Optional[str] = None,
                     tenant: Optional[str] = None) -> Future:
        return self._submit("predict", np.asarray(x), session, slo_ms,
                            model=model, tenant=tenant)

    def generate_async(self, prompt_ids, *, session=None,
                       slo_ms: Optional[float] = None,
                       model: Optional[str] = None,
                       tenant: Optional[str] = None, **kw) -> Future:
        payload = dict(kw)
        payload["prompt_ids"] = prompt_ids
        return self._submit("decode", payload, session, slo_ms,
                            model=model, tenant=tenant)

    def generate(self, prompt_ids, **kw):
        return self.generate_async(prompt_ids, **kw).result()

    @property
    def current_tag(self) -> str:
        with self._lock:
            for h in self._hosts.values():
                if h.state != "down":
                    return _tag_of(h.engine or h.decode)
        return ""

    def tags(self, kind: str = "predict") -> Dict[str, str]:
        """Current model tag per non-down host — the fleet-consistency
        view (``current_tag`` reads only the FIRST up host, which lies
        mid-roll or after a canary host self-swapped ahead of the
        fleet).  A promotion controller re-rolls exactly when some up
        host's tag differs from the target."""
        with self._lock:
            hosts = [h for h in self._hosts.values()
                     if h.state != "down" and h.supports(kind)]
        return {h.host_id: _tag_of(h.engine_for(kind)) for h in hosts}

    def health_snapshot(self) -> dict:
        with self._lock:
            hosts = list(self._hosts.values())
        per: Dict[str, dict] = {}
        dispatchable = 0
        all_ok = bool(hosts)
        for h in hosts:
            if h.state == "down":
                per[h.host_id] = {"state": "down", "planned": h.planned,
                                  "last_error": h.last_error}
                all_ok = False
                continue
            entry: Dict[str, Any] = {"state": h.state,
                                     "inflight": h.inflight}
            ready = False
            for kind, eng in (("predict", h.engine), ("decode", h.decode)):
                if eng is None:
                    continue
                try:
                    snap = eng.health_snapshot()
                except Exception as exc:
                    snap = {"status": "unready", "ready": False,
                            "error": f"{type(exc).__name__}: {exc}"}
                entry[kind] = snap
                ready = ready or bool(snap.get("ready"))
                if snap.get("status") != "ok":
                    all_ok = False
            if h.state != "up":
                all_ok = False
            if ready and h.state == "up":
                dispatchable += 1
            per[h.host_id] = entry
        status = ("ok" if all_ok and dispatchable
                  else "degraded" if dispatchable else "unready")
        return {"status": status, "ready": dispatchable > 0,
                "kind": "fleet", "hosts": per,
                "model": self.current_tag}

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        with self._lock:
            snap["hosts"] = {
                hid: {"state": h.state, "inflight": h.inflight,
                      "queue_depth": h.cached_queue_depth,
                      "failures": h.failures,
                      "role": h.decode_role(),
                      "free_slots": h.cached_free_slots,
                      "free_pages": h.cached_free_pages}
                for hid, h in self._hosts.items()}
            snap["queue_depth"] = sum(
                h.inflight for h in self._hosts.values())
            snap["model_traffic"] = dict(self._model_traffic)
        snap["model"] = self.current_tag
        snap["models"] = self.model_map()
        return snap

    # -- dispatch --------------------------------------------------------

    def _submit(self, kind, payload, session, slo_ms,
                model=None, tenant=None) -> Future:
        fut: Future = Future()
        now = self.clock()
        deadline = (now + slo_ms / 1000.0) if slo_ms else None
        spec = _FleetRequest(kind, payload, session, slo_ms, deadline, fut,
                             now, model=model, tenant=tenant)
        self.metrics.inc("requests", tenant=tenant)
        with self._lock:
            key = model if model is not None else ""
            self._model_traffic[key] = self._model_traffic.get(key, 0) + 1
        if self._shutdown:
            _fail_safe(fut, ServingUnavailableError(
                "fleet router is shut down"))
            return fut
        if self._draining:
            self.metrics.inc("shed", tenant=tenant)
            _fail_safe(fut, OverloadedError(
                "admission stopped: fleet is draining (preemption notice)"))
            return fut
        self._dispatch(spec)
        return fut

    def _pick_host_locked(self, spec,
                          sink: bool = False) -> Optional[FleetHost]:
        # disaggregated decode routes in two stages: a raw prompt goes
        # to a prefill/unified host (sink=False — decode-role hosts
        # cannot prefill), a PrefillHandoff to a decode-role sink
        cands = [h for h in self._hosts.values()
                 if h.state == "up" and h.supports(spec.kind)
                 and h.places(spec.model, spec.kind)
                 and (spec.kind != "decode"
                      or (h.decode_role() == "decode") == sink)]
        if not cands:
            return None
        if spec.session is not None:
            host = self._ring_lookup_locked(spec.session, spec.kind,
                                            spec.tried, sink,
                                            model=spec.model)
            if host is not None:
                self.metrics.inc("affinity_routed")
                return host
        fresh = [h for h in cands if h.host_id not in spec.tried] or cands
        score = {h.host_id: h.inflight + h.cached_queue_depth
                 + (h.decode_pressure() if spec.kind == "decode" else 0)
                 for h in fresh}
        best = min(score[h.host_id] for h in fresh)
        tied = [h for h in fresh if score[h.host_id] == best]
        self._rr += 1
        return tied[self._rr % len(tied)]

    def _ring_lookup_locked(self, key, kind, tried,
                            sink: bool = False,
                            model: Optional[str] = None
                            ) -> Optional[FleetHost]:
        if not self._ring:
            return None
        h = _hash64(str(key))
        idx = bisect.bisect_left(self._ring, (h, ""))
        n = len(self._ring)
        for allow_tried in (False, True):
            seen: set = set()
            for off in range(n):
                _, hid = self._ring[(idx + off) % n]
                if hid in seen:
                    continue
                seen.add(hid)
                host = self._hosts[hid]
                if (host.state == "up" and host.supports(kind)
                        and host.places(model, kind)
                        and (kind != "decode"
                             or (host.decode_role() == "decode") == sink)
                        and (allow_tried or hid not in tried)):
                    return host
        return None

    def set_model_miss_handler(
            self, handler: Optional[Callable[[str, str], bool]]) -> None:
        """Placement hook: ``handler(model, kind)`` runs (outside the
        router lock) when a request names a model no up host places.
        Return True to have dispatch re-pick once — the demand-reload
        path: eviction makes a cold model a routing miss, not an
        error."""
        with self._lock:
            self._on_model_miss = handler

    def model_traffic(self, reset: bool = False) -> Dict[str, int]:
        """Per-model submit counts since the last reset ("" = the
        default model) — the placement controller's demand signal."""
        with self._lock:
            out = dict(self._model_traffic)
            if reset:
                self._model_traffic = {}
            return out

    def model_map(self) -> Dict[str, Dict[str, str]]:
        """host_id -> {model name -> tag} over non-down hosts — the
        fleet's live placement view."""
        with self._lock:
            return {hid: h.placed_models()
                    for hid, h in self._hosts.items() if h.state != "down"}

    def _dispatch(self, spec) -> None:
        if self._shutdown:
            _fail_safe(spec.future, ServingUnavailableError(
                "fleet router is shut down"))
            return
        attempt = None
        for round_no in (0, 1):
            with self._lock:
                host = self._pick_host_locked(spec)
                if host is not None:
                    host.inflight += 1
                    self._aid += 1
                    timeout_at = (self.clock() + self.request_timeout_s
                                  if self.request_timeout_s else None)
                    attempt = _Attempt(self._aid, spec, host, self.clock(),
                                       timeout_at)
                    self._outstanding[attempt.aid] = attempt
                    break
                miss_cb = self._on_model_miss
            if (round_no == 0 and spec.model is not None
                    and miss_cb is not None):
                # no up host places this model: give the placement
                # controller one shot at a demand reload, then re-pick
                self.metrics.inc("model_misses")
                try:
                    if not miss_cb(spec.model, spec.kind):
                        break
                except Exception:
                    # a crashing miss handler degrades to the typed
                    # ModelNotLoadedError below, visibly
                    self.metrics.inc("model_miss_cb_errors")
                    break
            else:
                break
        if host is None:
            self.metrics.inc("shed", tenant=spec.tenant)
            if spec.model is not None:
                _fail_safe(spec.future, ModelNotLoadedError(
                    f"no up fleet host places model {spec.model!r} "
                    f"(kind={spec.kind!r})"))
            else:
                _fail_safe(spec.future, OverloadedError(
                    f"no dispatchable fleet host for kind={spec.kind!r}"))
            return
        self.metrics.inc("dispatched")
        try:
            eng = host.engine_for(spec.kind)
            kw = {}
            if spec.model is not None:
                kw["model"] = spec.model
            if spec.tenant is not None:
                kw["tenant"] = spec.tenant
            if spec.kind == "decode":
                try:
                    inner = eng.generate_async(slo_ms=spec.slo_ms, **kw,
                                               **spec.payload)
                except TypeError:
                    if not kw:
                        raise
                    # pre-tenancy engine (or a test fake): routing
                    # already honored placement; drop the tags
                    inner = eng.generate_async(slo_ms=spec.slo_ms,
                                               **spec.payload)
            else:
                try:
                    inner = eng.output_async(spec.payload,
                                             slo_ms=spec.slo_ms, **kw)
                except TypeError:
                    if not kw:
                        raise
                    inner = eng.output_async(spec.payload,
                                             slo_ms=spec.slo_ms)
        except BaseException as exc:
            # synchronous failure (admission shed, validation, shut-down
            # host): the attempt never reached the host's queue
            with self._lock:
                host.inflight = max(0, host.inflight - 1)
                attempt.settled = True
                self._outstanding.pop(attempt.aid, None)
                self._idle_cv.notify_all()
            self._handle_failure(spec, host, exc)
            return
        inner.add_done_callback(
            lambda f, a=attempt: self._on_inner_done(a, f))

    def _on_inner_done(self, attempt, inner: Future) -> None:
        try:
            host = attempt.host
            with self._lock:
                host.inflight = max(0, host.inflight - 1)
                won = not attempt.settled
                attempt.settled = True
                self._outstanding.pop(attempt.aid, None)
                self._idle_cv.notify_all()
            exc = inner.exception()
            if not won:
                # a timeout already re-routed this attempt — the late
                # result is discarded, never double-delivered
                if exc is None:
                    self.metrics.inc("late_discards")
                return
            if exc is None:
                result = inner.result()
                if (attempt.spec.kind == "decode"
                        and isinstance(result, PrefillHandoff)):
                    # stage 1 of a disaggregated generation: the
                    # prefill host handed back KV pages, not tokens
                    self._dispatch_decode_stage(attempt, result)
                else:
                    self._deliver(attempt, result)
            else:
                self._handle_failure(attempt.spec, host, exc)
        except BaseException as exc:
            _fail_safe(attempt.spec.future, exc)

    def _dispatch_decode_stage(self, attempt, handoff) -> None:
        """Stage 2 of a disaggregated generation: transfer the
        ``PrefillHandoff``'s packed KV pages to a ``role="decode"`` sink
        and chain its future to the caller's.  A failed (or absent) sink
        re-enters ``_handle_failure``, whose retry restarts from stage 1
        — seeded counter-based sampling makes the re-run bit-identical,
        so at-most-once delivery still holds via ``_set_safe``."""
        spec = attempt.spec
        t0 = self.clock()
        with self._lock:
            attempt.host.failures = 0      # stage 1 succeeded
            sink = self._pick_host_locked(spec, sink=True)
            if sink is not None:
                sink.inflight += 1
                self._aid += 1
                timeout_at = (self.clock() + self.request_timeout_s
                              if self.request_timeout_s else None)
                a2 = _Attempt(self._aid, spec, sink, self.clock(),
                              timeout_at)
                self._outstanding[a2.aid] = a2
        if sink is None:
            self.metrics.inc("shed")
            _fail_safe(spec.future, OverloadedError(
                "no decode-role sink host up for the prefill handoff"))
            return
        self.metrics.inc("dispatched")
        try:
            inner = sink.decode.continue_async(handoff, slo_ms=spec.slo_ms)
        except BaseException as exc:
            with self._lock:
                sink.inflight = max(0, sink.inflight - 1)
                a2.settled = True
                self._outstanding.pop(a2.aid, None)
                self._idle_cv.notify_all()
            self._handle_failure(spec, sink, exc)
            return
        self.metrics.inc("disagg_requests")
        self.metrics.inc("page_transfers")
        self.metrics.inc("transfer_bytes", len(handoff.pages))
        obs_trace.complete_at(
            "fleet/page_transfer", t0, self.clock(), cat="fleet",
            src=attempt.host.host_id, dst=sink.host_id,
            pages=int(handoff.n_pages), nbytes=len(handoff.pages))
        inner.add_done_callback(
            lambda f, a=a2: self._on_inner_done(a, f))

    def _deliver(self, attempt, result) -> None:
        spec, host = attempt.spec, attempt.host
        with self._lock:
            host.failures = 0
        if _set_safe(spec.future, result):
            done = self.clock()
            self.metrics.inc("delivered", tenant=spec.tenant)
            self.metrics.e2e.record((done - spec.t_submit) * 1000.0)
            obs_trace.complete_at("fleet/request", spec.t_submit, done,
                                  cat="fleet", host=host.host_id,
                                  kind=spec.kind, retries=spec.retries)
        else:
            self.metrics.inc("late_discards")

    def _handle_failure(self, spec, host, exc) -> None:
        try:
            retryable = not isinstance(exc, _NON_RETRYABLE)
            # an admission shed is back-pressure, not a sick host —
            # likewise a model the host merely doesn't place: route
            # around them but don't feed the circuit breaker
            if retryable and not isinstance(
                    exc, (OverloadedError, ModelNotLoadedError)):
                self._note_host_failure(host, exc)
            if spec.future.done():
                return
            if (retryable and spec.retries < self.max_retries
                    and not self._shutdown
                    and (spec.deadline is None
                         or self.clock() < spec.deadline)):
                spec.retries += 1
                spec.tried.add(host.host_id)
                self.metrics.inc("retries")
                obs_trace.instant("fleet/retry", cat="fleet",
                                  host=host.host_id, kind=spec.kind,
                                  retries=spec.retries,
                                  error=type(exc).__name__)
                self._dispatch(spec)
                return
            self.metrics.inc("failed", tenant=spec.tenant)
            _fail_safe(spec.future, exc)
        except BaseException as e:
            _fail_safe(spec.future, e)

    def _note_host_failure(self, host, exc) -> None:
        with self._lock:
            host.failures += 1
            host.last_error = f"{type(exc).__name__}: {exc}"
            trip = (self.breaker_threshold > 0
                    and host.failures >= self.breaker_threshold
                    and host.state != "down")
        self.metrics.inc("host_failures")
        if trip:
            self.mark_host_down(host.host_id, reason="breaker")

    # -- watchdog: timeouts, /metrics polls, heartbeat watch -------------

    def _watchdog_loop(self) -> None:
        while not self._stop.wait(self.watchdog_interval_s):
            try:
                self.poke()
            except Exception:
                # the watchdog must survive anything; count, don't die
                self.metrics.inc("watchdog_errors")

    def poke(self, now: Optional[float] = None) -> None:
        """One watchdog tick, callable synchronously from tests with an
        injected ``now``: expire per-request timeouts, refresh host
        queue-depth snapshots, reconcile the heartbeat ledger."""
        now = self.clock() if now is None else now
        expired: List[_Attempt] = []
        with self._lock:
            for a in list(self._outstanding.values()):
                if (a.timeout_at is not None and now >= a.timeout_at
                        and not a.settled):
                    a.settled = True
                    self._outstanding.pop(a.aid, None)
                    expired.append(a)
        for a in expired:
            self.metrics.inc("timeouts")
            self._handle_failure(
                a.spec, a.host,
                FleetTimeoutError(
                    f"host {a.host.host_id} exceeded "
                    f"{self.request_timeout_s}s for request dispatched at "
                    f"t={a.t_dispatch:.3f}"))
        if (self._last_depth_poll is None
                or now - self._last_depth_poll >= self.metrics_refresh_s):
            self._last_depth_poll = now
            self._poll_depths(now)
        if (self._membership is not None
                and (self._last_member_poll is None
                     or now - self._last_member_poll
                     >= self.membership_refresh_s)):
            self._last_member_poll = now
            self.refresh_membership()

    def _poll_depths(self, now: float) -> None:
        with self._lock:
            hosts = [h for h in self._hosts.values() if h.state != "down"]
        for h in hosts:
            depth = h.read_queue_depth()
            h.read_decode_pressure()
            with self._lock:
                h.cached_queue_depth = depth
                h.depth_read_at = now

    def refresh_membership(self) -> None:
        """Reconcile host state against the heartbeat ledger: a process
        marked leaving (a preemption notice) is drained (no new dispatch,
        in-flight work finishes); one that stopped beating is down."""
        if self._membership is None:
            return
        try:
            alive = set(self._membership.alive())
            leaving = set(self._membership.leaving())
        except Exception:
            # a torn ledger read: skip this tick, count it
            self.metrics.inc("membership_errors")
            return
        with self._lock:
            rows = [(h.host_id, h.process_id, h.state)
                    for h in self._hosts.values()
                    if h.process_id is not None]
        for hid, pid, state in rows:
            if state == "down":
                if pid in alive:
                    self.mark_host_up(hid)
                continue
            if pid in leaving:
                if state == "up":
                    with self._lock:
                        host = self._hosts.get(hid)
                        if host is not None and host.state == "up":
                            host.state = "draining"
                            self._gauge_hosts_locked()
                    self.metrics.inc("preempt_drains")
                    obs_trace.instant("fleet/drain", cat="fleet", host=hid,
                                      reason="leaving")
            elif pid not in alive:
                self.mark_host_down(hid, reason="heartbeat")

    # -- drain / preemption ----------------------------------------------

    def drain_host(self, host_id: str,
                   timeout_s: Optional[float] = None) -> bool:
        """Stop dispatching to ``host_id`` and wait until its in-flight
        count reaches zero (True) or ``timeout_s`` passes (False).  The
        host stays ``draining`` either way; ``undrain_host`` or
        ``mark_host_down`` decides its fate."""
        with obs_trace.span("fleet/drain", cat="fleet", host=host_id):
            deadline = (self.clock() + timeout_s
                        if timeout_s is not None else None)
            with self._lock:
                host = self._hosts.get(host_id)
                if host is None:
                    raise KeyError(f"unknown host {host_id!r}")
                if host.state == "up":
                    host.state = "draining"
                    self._gauge_hosts_locked()
                while host.inflight > 0 and host.state != "down":
                    remaining = (None if deadline is None
                                 else deadline - self.clock())
                    if remaining is not None and remaining <= 0:
                        return False
                    self._idle_cv.wait(
                        timeout=0.05 if remaining is None
                        else min(0.05, remaining))
            self.metrics.inc("drains")
            return True

    def undrain_host(self, host_id: str) -> None:
        with self._lock:
            host = self._hosts.get(host_id)
            if host is not None and host.state == "draining":
                host.state = "up"
                self._gauge_hosts_locked()

    def begin_drain(self) -> None:
        """Stop admission fleet-wide: every later submission is shed with
        :class:`OverloadedError` while already-dispatched requests keep
        running to completion.  The ``serve`` CLI calls this on a SIGTERM
        preemption notice so the router empties within the grace budget.
        Idempotent."""
        if self._draining:
            return
        self._draining = True
        self.metrics.inc("drains")
        obs_trace.instant("fleet/drain", cat="fleet", scope="router")

    def draining(self) -> bool:
        return self._draining

    def notify_preemption(self, host_id: str,
                          grace_s: Optional[float] = None) -> bool:
        """A host took a SIGTERM preemption notice: drain it within the
        grace budget, then take it out of rotation as a planned leave.  Its traffic is re-placed on the surviving hosts
        by the normal dispatch path."""
        drained = self.drain_host(host_id, timeout_s=grace_s)
        self.metrics.inc("preempt_drains")
        self.mark_host_down(host_id, reason="preempt", planned=True)
        return drained

    # -- rolling swap -----------------------------------------------------

    def rolling_swap(self, model, tag: str, *, rollback_model=None,
                     rollback_tag: Optional[str] = None,
                     kind: str = "predict",
                     drain_timeout_s: float = 30.0,
                     warm_bundle: Optional[str] = None) -> dict:
        """Swap every up host to (``model``, ``tag``) one at a time under
        live traffic: drain the host (peers absorb its load), swap,
        undrain, move on.  If a host dies mid-swap it is marked down and
        the already-swapped survivors roll back to
        (``rollback_model``, ``rollback_tag``) — the fleet never serves
        two versions past the end of this call.

        ``warm_bundle`` is handed to each host's ``swap_model``
        (``serving/warmcache.py``); an engine that does not take the
        keyword (a decode engine, a remote ``HttpHost``) gets the plain
        swap."""
        self.metrics.inc("rolling_swaps")
        report: Dict[str, Any] = {"ok": True, "tag": tag, "swapped": [],
                                  "rolled_back": False,
                                  "failed_host": None, "error": None}
        with obs_trace.span("fleet/rolling_swap", cat="fleet", tag=tag):
            with self._lock:
                order = [h for h in self._hosts.values()
                         if h.state == "up" and h.supports(kind)]
            swapped: List[FleetHost] = []
            for host in order:
                try:
                    if not self.drain_host(host.host_id,
                                           timeout_s=drain_timeout_s):
                        raise FleetTimeoutError(
                            f"drain of {host.host_id} timed out after "
                            f"{drain_timeout_s}s")
                    eng = host.engine_for(kind)
                    if warm_bundle is not None:
                        try:
                            eng.swap_model(model, tag,
                                           warm_bundle=warm_bundle)
                        except TypeError:
                            eng.swap_model(model, tag)
                    else:
                        eng.swap_model(model, tag)
                    swapped.append(host)
                    self.metrics.inc("swap_hosts")
                    obs_trace.instant("fleet/swap_host", cat="fleet",
                                      host=host.host_id, tag=tag)
                    self.undrain_host(host.host_id)
                except Exception as exc:
                    report["ok"] = False
                    report["failed_host"] = host.host_id
                    report["error"] = f"{type(exc).__name__}: {exc}"
                    self.mark_host_down(host.host_id, reason="swap_failed")
                    if rollback_model is not None and swapped:
                        self._rollback(swapped, rollback_model,
                                       rollback_tag or "rollback", kind,
                                       drain_timeout_s)
                        report["rolled_back"] = True
                    break
            report["swapped"] = [h.host_id for h in swapped]
        return report

    def _rollback(self, swapped, model, tag, kind,
                  drain_timeout_s) -> None:
        self.metrics.inc("rollbacks")
        obs_trace.instant("fleet/rollback", cat="fleet", tag=tag,
                          hosts=[h.host_id for h in swapped])
        for host in swapped:
            with self._lock:
                gone = host.state == "down"
            if gone:
                continue
            try:
                self.drain_host(host.host_id, timeout_s=drain_timeout_s)
                host.engine_for(kind).swap_model(model, tag)
                self.undrain_host(host.host_id)
            except Exception as exc:
                with self._lock:
                    host.last_error = f"{type(exc).__name__}: {exc}"
                self.mark_host_down(host.host_id,
                                    reason="rollback_failed")

    def promote(self, registry, name: str, version=None,
                alias: str = "prod", kind: str = "predict",
                drain_timeout_s: float = 30.0,
                warm_bundle: Optional[str] = None) -> dict:
        """Roll a registry promote through the fleet: resolve the new
        version once, remember the current alias target for rollback,
        swap host-by-host, and move the alias ONLY after every host
        swapped — a failed roll leaves both the fleet and the alias on
        the old version.

        ``warm_bundle`` names the incoming version's warm bundle; without
        it, a version ``registry.load`` read from disk finds its
        ``<checkpoint>.warm`` inside each engine's swap."""
        new_version, new_model = registry.resolve(
            name, "latest" if version is None else version)
        try:
            old_version, old_model = registry.resolve(name, alias)
        except Exception:
            old_version, old_model = None, None
        report = self.rolling_swap(
            new_model, f"{name}:v{new_version}",
            rollback_model=old_model,
            rollback_tag=(f"{name}:v{old_version}"
                          if old_version is not None else None),
            kind=kind, drain_timeout_s=drain_timeout_s,
            warm_bundle=warm_bundle)
        report["version"] = new_version
        if report["ok"]:
            registry.set_alias(name, alias, new_version)
        return report

    # -- lifecycle --------------------------------------------------------

    def shutdown(self, timeout: float = 5.0,
                 shutdown_hosts: bool = False) -> None:
        """Deterministic shutdown: no new submissions, watchdog joined,
        every outstanding fleet future resolves (late host results become
        counted discards) — nothing is ever stranded."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        self._stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=timeout)
        if shutdown_hosts:
            with self._lock:
                hosts = list(self._hosts.values())
            for h in hosts:
                for eng in (h.engine, h.decode):
                    if eng is None or not hasattr(eng, "shutdown"):
                        continue
                    try:
                        eng.shutdown()
                    except Exception as exc:
                        with self._lock:
                            h.last_error = f"{type(exc).__name__}: {exc}"
        with self._lock:
            pending = [a for a in self._outstanding.values()]
            self._outstanding.clear()
        for a in pending:
            _fail_safe(a.spec.future, ServingUnavailableError(
                "fleet router shut down"))


class HttpHost:
    """The engine duck type over a remote ``UIServer``: the client half of
    ``serve --fleet host:port,...``.  ``output_async`` POSTs /predict on
    a small worker pool; /metrics and /healthz are proxied.  HTTP errors
    map back onto the typed serving exceptions so the router's retry
    classification is identical for local and remote hosts; transport
    failures (connection refused, read timeout) surface as retryable
    host faults."""

    _ERROR_CLASSES = {
        "overloaded": OverloadedError,
        "deadline_exceeded": DeadlineExceededError,
        "poison_input": PoisonInputError,
        "unavailable": ServingUnavailableError,
        "model_not_loaded": ModelNotLoadedError,
    }

    def __init__(self, base_url: str, timeout_s: float = 5.0,
                 workers: int = 4):
        if "://" not in base_url:
            base_url = "http://" + base_url
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._pool = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix=f"fleet-http-{self.base_url.split('//')[-1]}")

    def _get_json(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def _predict(self, x, slo_ms, model=None, tenant=None):
        doc = {"inputs": np.asarray(x).tolist(), "slo_ms": slo_ms}
        if model is not None:
            doc["model"] = model
        if tenant is not None:
            doc["tenant"] = tenant
        body = json.dumps(doc).encode()
        req = urllib.request.Request(
            self.base_url + "/predict", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                out = json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except Exception:
                payload = {}
            kind = payload.get("error_class")
            msg = payload.get("error", f"HTTP {e.code}")
            if kind == "tenant_overloaded":
                # rebuild the typed error so per-tenant attribution
                # survives the HTTP seam (429 body carries the fields)
                raise TenantOverloadedError(
                    msg, payload.get("tenant", tenant or ""),
                    payload.get("shed_count", 0),
                    reason=payload.get("reason", "quota")) from None
            cls = self._ERROR_CLASSES.get(kind, RuntimeError)
            raise cls(msg) from None
        return np.asarray(out["outputs"])

    def output_async(self, x, slo_ms: Optional[float] = None,
                     model: Optional[str] = None,
                     tenant: Optional[str] = None) -> Future:
        return self._pool.submit(self._predict, x, slo_ms, model, tenant)

    def output(self, x, slo_ms: Optional[float] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None):
        return self._predict(x, slo_ms, model, tenant)

    @property
    def current_tag(self) -> str:
        try:
            return str(self._get_json("/healthz").get("model", ""))
        except Exception:
            return ""

    def metrics_snapshot(self) -> dict:
        try:
            snap = self._get_json("/metrics")
        except Exception as exc:
            return {"queue_depth": 0,
                    "error": f"{type(exc).__name__}: {exc}"}
        depth = 0
        for s in snap.get("serving", []):
            d = s.get("queue_depth")
            if isinstance(d, (int, float)):
                depth += int(d)
        return {"queue_depth": depth, "remote": snap}

    def health_snapshot(self) -> dict:
        try:
            return self._get_json("/healthz")
        except Exception as exc:
            return {"status": "unready", "ready": False,
                    "error": f"{type(exc).__name__}: {exc}"}

    def shutdown(self, timeout: float = 5.0) -> None:
        self._pool.shutdown(wait=False)
