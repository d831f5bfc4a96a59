"""Deadline-aware dynamic micro-batcher and the decode engine's admission
queue (mirrors ``deeplearning4j_tpu/serving/batcher.py``).

``DynamicBatcher`` closes a batch the moment

  * queued rows reach ``max_batch`` (never overshooting it: a drain is
    split at ``max_batch`` before it is bucketed, and one request larger
    than that goes alone), or
  * waiting longer would eat into the oldest request's deadline: close
    time = earliest deadline − the EMA device time of the bucket the
    batch would run in (seeded by the engine's warm-up), or the oldest
    request has waited ``max_wait_ms``.

Requests carry their own deadline (default: submit + the SLO budget); a
request whose deadline passes while queued fails fast with
``DeadlineExceededError``.  The queue is bounded (``max_queue``) with a
``block`` (backpressure the caller) or ``shed`` (raise
``OverloadedError``) policy; ``begin_drain`` sheds every later submit.
``close`` fails every pending future.  ``clock`` is injectable.

``ContinuousBatcher`` is its subclass for the decode engine: instead of
``next_batch`` the decode loop calls ``admit(limit)`` at each step
boundary, so a new request joins the running batch at the next step.

Multi-tenancy (``serving/tenancy.py``): requests carry a tenant, and the
queue is a set of per-tenant lanes drained by stride scheduling (the
non-empty lane with the smallest virtual time ``served_rows / weight``
goes next), so a bursting tenant's backlog queues behind its own lane,
never in front of another tenant's requests.  Per-tenant quotas (a
concurrent cap, a QPS bucket) are checked and charged in one critical
section at submit; a tenant over quota sheds with
``TenantOverloadedError``.  Untagged traffic rides the anonymous lane
(weight 1) and behaves as a plain FIFO.  Requests also carry an optional
``model``; a batch never mixes models.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from ..obs import trace as obs_trace

ADMISSION_POLICIES = ("block", "shed")

_ANY_MODEL = object()      # lane selection unconstrained by model


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before a device slot freed up."""


class OverloadedError(RuntimeError):
    """The admission queue is full and the policy is ``shed`` (or the
    engine is draining)."""


class _Request:
    __slots__ = ("x", "rows", "future", "t_submit", "deadline",
                 "retries", "tried", "payload", "tenant", "model")

    def __init__(self, x: Any, future: Future, t_submit: float,
                 deadline: float, tenant: str = "", model: Optional[str] = None):
        self.x = x
        self.rows = int(x.shape[0])
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline
        self.retries = 0          # failure-isolation retries consumed
        self.tried = set()        # replica indices that failed this request
        self.payload = None       # the decode path's request spec
        self.tenant = tenant      # "" = the anonymous lane
        self.model = model        # None = the engine's default model


def pow2_buckets(max_batch: int) -> List[int]:
    """1, 2, 4, ... up to and including ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


def _shut_down() -> RuntimeError:
    return RuntimeError("serving engine is shut down")


class DynamicBatcher:
    """Bounded request queue and deadline-aware batch former: any number
    of caller threads ``submit``; a dispatcher thread calls
    ``next_batch``.  ``tenants`` (a ``tenancy.TenantTable``) arms
    per-tenant quotas and weighted-fair lanes; without it every request
    rides the anonymous lane."""

    def __init__(self, max_batch: int = 32, slo_ms: float = 50.0,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 max_queue: int = 1024, admission: str = "block",
                 max_wait_ms: Optional[float] = None,
                 metrics=None, clock=time.monotonic, tenants=None):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        if max_batch < 1 or max_queue < 1 or slo_ms <= 0:
            raise ValueError("max_batch/max_queue must be >=1, slo_ms > 0")
        self.max_batch = int(max_batch)
        self.slo_ms = float(slo_ms)
        # at low load the oldest request waits at most this long for
        # companions; the deadline-slack close binds when it is tighter
        self.max_wait_ms = (float(max_wait_ms) if max_wait_ms is not None
                            else min(5.0, self.slo_ms / 10.0))
        self.buckets = (sorted(set(int(b) for b in bucket_sizes))
                        if bucket_sizes else pow2_buckets(max_batch))
        self.max_queue = int(max_queue)
        self.admission = admission
        self.metrics = metrics
        self.clock = clock
        self.tenants = tenants
        # tenant -> FIFO lane, drained by stride scheduling over _pass
        # (rows served / weight); a new lane joins at the minimum live
        # pass, so it neither starves nor is starved
        self._lanes: Dict[str, Deque[_Request]] = {}
        self._pass: Dict[str, float] = {}
        self._n_pending = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._closed = False
        self._draining = False
        # bucket -> EMA device ms, the slack kept when a batch may fill
        self._exec_ema_ms = {}

    # -- shape buckets -----------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n; a request larger than the
        largest bucket gets the next power of two (it runs unwarmed)."""
        for b in self.buckets:
            if n <= b:
                return b
        b = self.buckets[-1]
        while b < n:
            b *= 2
        return b

    def observe_exec_ms(self, bucket: int, ms: float, alpha: float = 0.3) -> None:
        prev = self._exec_ema_ms.get(bucket)
        self._exec_ema_ms[bucket] = (ms if prev is None
                                     else alpha * ms + (1 - alpha) * prev)

    def _exec_budget_ms(self, rows: int) -> float:
        """Expected device time of a batch of ``rows``; an unmeasured
        bucket assumes a quarter of the SLO."""
        ema = self._exec_ema_ms.get(self.bucket_for(min(rows, self.max_batch)))
        return ema if ema is not None else self.slo_ms * 0.25

    # -- tenant lanes ------------------------------------------------------

    def _weight_of(self, tenant: str) -> float:
        if not tenant or self.tenants is None:
            return 1.0
        return self.tenants.weight(tenant)

    def _append_locked(self, r: _Request, front: bool = False) -> None:
        lane = self._lanes.get(r.tenant)
        if lane is None:
            lane = self._lanes[r.tenant] = deque()
            live = [p for t, p in self._pass.items() if self._lanes.get(t)]
            self._pass[r.tenant] = max(self._pass.get(r.tenant, 0.0),
                                       min(live, default=0.0))
        if front:
            lane.appendleft(r)
        else:
            lane.append(r)
        self._n_pending += 1

    def _iter_pending(self):
        for lane in self._lanes.values():
            yield from lane

    def _next_lane_locked(self, model=_ANY_MODEL) -> Optional[str]:
        """Stride scheduling: the non-empty lane with the smallest virtual
        time whose head is of ``model`` (a batch never mixes models)."""
        best, best_pass = None, None
        for t, lane in self._lanes.items():
            if not lane or (model is not _ANY_MODEL and lane[0].model != model):
                continue
            p = self._pass.get(t, 0.0)
            if best_pass is None or p < best_pass:
                best, best_pass = t, p
        return best

    def _pop_one_locked(self, tenant: str) -> _Request:
        r = self._lanes[tenant].popleft()
        self._n_pending -= 1
        self._pass[tenant] = self._pass.get(tenant, 0.0) + r.rows / self._weight_of(tenant)
        return r

    # -- submission --------------------------------------------------------

    def _count_shed(self, tenant: str) -> None:
        if self.metrics:
            self.metrics.inc("shed", tenant=tenant or None)

    def _admission_locked(self, fut: Future, tenant: str, model: Optional[str]) -> bool:
        """Every admission gate, under the lock: closed fails the future
        (False: do not enqueue); draining and a full ``shed`` queue raise
        ``OverloadedError``; a full ``block`` queue waits for space.  A
        tenant's quota is checked and charged here too: over it, a
        ``shed`` tenant raises ``TenantOverloadedError`` and a ``block``
        one waits; once charged, the slot's release rides the future's
        done-callback (every future resolves, so it runs exactly once)."""
        if self._closed:
            fut.set_exception(_shut_down())
            return False
        if self._draining:
            self._count_shed(tenant)
            raise OverloadedError(
                "admission stopped: engine is draining (preemption notice)")
        if self._n_pending >= self.max_queue:
            if self.admission == "shed":
                self._count_shed(tenant)
                raise OverloadedError(
                    f"admission queue full ({self.max_queue} requests); "
                    "policy=shed")
            while (self._n_pending >= self.max_queue
                   and not self._closed and not self._draining):
                self._space.wait(timeout=0.1)
            if self._closed:
                fut.set_exception(_shut_down())
                return False
            if self._draining:
                self._count_shed(tenant)
                raise OverloadedError(
                    "admission stopped: engine is draining (preemption notice)")
        if self.tenants is not None and tenant:
            if not self.tenants.try_admit(tenant, model, now=self.clock()):
                if self.tenants.admission_for(tenant, model) != "block":
                    self._count_shed(tenant)
                    raise self.tenants.shed(tenant, model)
                # releases run on other threads' done-callbacks, which
                # cannot notify this condition: poll every 50 ms
                while (not self._closed and not self._draining
                       and not self.tenants.try_admit(tenant, model, now=self.clock())):
                    self._space.wait(timeout=0.05)
                if self._closed:
                    fut.set_exception(_shut_down())
                    return False
                if self._draining:
                    self._count_shed(tenant)
                    raise OverloadedError(
                        "admission stopped: engine is draining (preemption notice)")
            fut.add_done_callback(lambda f, t=tenant: self.tenants.release(t))
        return True

    def _resolve_deadline(self, now: float, slo_ms: Optional[float],
                          deadline: Optional[float], tenant: str = "",
                          model: Optional[str] = None) -> float:
        if deadline is not None:
            return deadline
        if slo_ms is None and tenant and self.tenants is not None:
            slo_ms = self.tenants.slo_ms_for(tenant, model)
        return now + (slo_ms if slo_ms is not None else self.slo_ms) / 1000.0

    def submit(self, x, slo_ms: Optional[float] = None,
               deadline: Optional[float] = None, tenant: Optional[str] = None,
               model: Optional[str] = None) -> Future:
        """Enqueue one request (a leading batch axis) in ``tenant``'s lane
        for ``model``; returns its Future.  Shedding raises
        ``OverloadedError`` (``TenantOverloadedError`` over a tenant's
        quota) synchronously; a closed batcher fails the future."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request must have a leading batch axis, "
                             f"got shape {x.shape}")
        tenant = tenant or ""
        fut: Future = Future()
        now = self.clock()
        dl = self._resolve_deadline(now, slo_ms, deadline, tenant, model)
        with self._lock:
            if not self._admission_locked(fut, tenant, model):
                return fut
            self._append_locked(_Request(x, fut, now, dl, tenant, model))
            self._nonempty.notify()
        return fut

    def qsize(self) -> int:
        with self._lock:
            return self._n_pending

    def tenant_qsize(self, tenant: str) -> int:
        with self._lock:
            lane = self._lanes.get(tenant or "")
            return len(lane) if lane else 0

    # -- batch formation ---------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        """Fail-fast every queued request whose deadline already passed."""
        expired = 0
        for t, lane in self._lanes.items():
            if not any(r.deadline < now for r in lane):
                continue
            keep: Deque[_Request] = deque()
            lane_expired = 0
            for r in lane:
                if r.deadline < now:
                    lane_expired += 1
                    if not r.future.done():
                        r.future.set_exception(DeadlineExceededError(
                            f"request waited {(now - r.t_submit) * 1e3:.1f}ms in "
                            f"queue, past its "
                            f"{(r.deadline - r.t_submit) * 1e3:.0f}ms deadline"))
                else:
                    keep.append(r)
            self._lanes[t] = keep
            expired += lane_expired
            if self.metrics:
                self.metrics.inc("deadline_missed", lane_expired, tenant=t or None)
        if expired:
            self._n_pending -= expired
            self._space.notify_all()

    def _pop_batch_locked(self) -> List[_Request]:
        batch: List[_Request] = []
        rows = 0
        model = _ANY_MODEL
        while self._n_pending:
            t = self._next_lane_locked(model)
            if t is None:          # only other models' lanes remain
                break
            head = self._lanes[t][0]
            # split at max_batch before bucketing; one oversized request
            # still goes alone (it cannot be split)
            if batch and rows + head.rows > self.max_batch:
                break
            batch.append(self._pop_one_locked(t))
            rows += head.rows
            model = head.model     # the batch never mixes models
            if rows >= self.max_batch:
                break
        self._space.notify_all()
        if batch:
            # batch formation ran from the oldest member's submit until
            # this close decision
            obs_trace.complete_at(
                "serve/batch_form", min(r.t_submit for r in batch),
                self.clock(), cat="serve", rows=rows, n_requests=len(batch))
        return batch

    def next_batch(self) -> Optional[List[_Request]]:
        """Block until a batch closes; None once closed and drained."""
        with self._lock:
            while True:
                now = self.clock()
                self._expire_locked(now)
                if not self._n_pending:
                    if self._closed:
                        return None
                    self._nonempty.wait(timeout=0.5)
                    continue
                total = sum(r.rows for r in self._iter_pending())
                if total >= self.max_batch or self._closed:
                    return self._pop_batch_locked()
                earliest = min(r.deadline for r in self._iter_pending())
                oldest = min(r.t_submit for r in self._iter_pending())
                t_close = min(oldest + self.max_wait_ms / 1000.0,
                              earliest - self._exec_budget_ms(total) / 1000.0)
                if now >= t_close:
                    return self._pop_batch_locked()
                # capped so expiry scans run even if nothing new arrives
                self._nonempty.wait(timeout=min(t_close - now, 0.05))

    # -- shutdown ----------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admission without failing anything queued: every later
        submit sheds (``OverloadedError``, HTTP 429), block-policy callers
        waiting for space are woken and shed too, queued requests keep
        draining.  Idempotent."""
        with self._lock:
            self._draining = True
            self._space.notify_all()

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def close(self, fail_pending: bool = True) -> None:
        """Idempotent; with ``fail_pending`` every queued request resolves
        with the shut-down error."""
        with self._lock:
            self._closed = True
            if fail_pending:
                for lane in self._lanes.values():
                    while lane:
                        r = lane.popleft()
                        if not r.future.done():
                            r.future.set_exception(_shut_down())
                self._n_pending = 0
            self._nonempty.notify_all()
            self._space.notify_all()


class ContinuousBatcher(DynamicBatcher):
    """Iteration-level admission for the decode engine: callers
    ``submit_request``; the decode loop calls ``admit(limit)`` at every
    step boundary.  The parent's admission control (bounded queue,
    block/shed, drain) and queued-deadline fail-fast apply; requests
    carry an opaque ``payload`` (the generation spec) instead of an
    input array."""

    def submit_request(self, payload, slo_ms: Optional[float] = None,
                       deadline: Optional[float] = None, tenant: Optional[str] = None,
                       model: Optional[str] = None) -> Future:
        """Enqueue one decode request; the admission semantics of
        ``DynamicBatcher.submit``."""
        tenant = tenant or ""
        fut: Future = Future()
        now = self.clock()
        dl = self._resolve_deadline(now, slo_ms, deadline, tenant, model)
        with self._lock:
            if not self._admission_locked(fut, tenant, model):
                return fut
            r = _Request(np.empty((1, 0), np.float32), fut, now, dl, tenant, model)
            r.payload = payload
            self._append_locked(r)
            self._nonempty.notify()
        return fut

    def admit(self, limit: int,
              token_budget: Optional[int] = None) -> List[_Request]:
        """Pop up to ``limit`` queued requests (none when idle).

        ``token_budget`` is the chunked-prefill admission rule: stop
        before the popped payloads' prompt tokens (``len(payload.prompt)``
        where a payload has one) would pass the budget, so one round never
        takes in more prefill work than the engine interleaves per step.
        The head request is always admitted, even when it alone passes
        the budget (the engine chunks its prefill), so nothing starves."""
        if limit <= 0:
            return []

        def cost(r: _Request) -> int:
            p = getattr(r.payload, "prompt", None)
            return 0 if p is None else len(p)

        with self._lock:
            self._expire_locked(self.clock())
            out: List[_Request] = []
            spent = 0
            while self._n_pending and len(out) < limit:
                t = self._next_lane_locked()
                if (token_budget is not None and out
                        and spent + cost(self._lanes[t][0]) > token_budget):
                    break
                r = self._pop_one_locked(t)
                spent += cost(r)
                out.append(r)
            if out:
                self._space.notify_all()
            return out

    def requeue_front(self, r: _Request) -> None:
        """Put a request back at the head of its lane: admission raced
        ahead of capacity (no free pages or slot yet), or its batch crashed
        and it has retries left.  The lane's charge for the pop is
        refunded."""
        with self._lock:
            if self._closed:
                if not r.future.done():
                    r.future.set_exception(_shut_down())
                return
            self._pass[r.tenant] = (self._pass.get(r.tenant, 0.0)
                                    - r.rows / self._weight_of(r.tenant))
            self._append_locked(r, front=True)
            self._nonempty.notify()

    def wait_for_work(self, timeout: float = 0.05) -> bool:
        """Park the decode loop until a request is queued (or timeout /
        close).  True when work is pending."""
        with self._lock:
            if self._n_pending or self._closed:
                return bool(self._n_pending)
            self._nonempty.wait(timeout=timeout)
            return bool(self._n_pending)
