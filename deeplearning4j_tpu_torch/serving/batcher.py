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

One FIFO lane: the reference's per-tenant fair-share lanes, quotas and
model tags are later work.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, List, Optional, Sequence

import numpy as np

ADMISSION_POLICIES = ("block", "shed")


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before a device slot freed up."""


class OverloadedError(RuntimeError):
    """The admission queue is full and the policy is ``shed`` (or the
    engine is draining)."""


class _Request:
    __slots__ = ("x", "rows", "future", "t_submit", "deadline",
                 "retries", "tried", "payload")

    def __init__(self, x: Any, future: Future, t_submit: float,
                 deadline: float):
        self.x = x
        self.rows = int(x.shape[0])
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline
        self.retries = 0          # failure-isolation retries consumed
        self.tried = set()        # replica indices that failed this request
        self.payload = None       # the decode path's request spec


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
    ``next_batch``."""

    def __init__(self, max_batch: int = 32, slo_ms: float = 50.0,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 max_queue: int = 1024, admission: str = "block",
                 max_wait_ms: Optional[float] = None,
                 metrics=None, clock=time.monotonic):
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
        self._q: Deque[_Request] = deque()
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

    # -- submission --------------------------------------------------------

    def _count_shed(self) -> None:
        if self.metrics:
            self.metrics.inc("shed")

    def _admission_locked(self, fut: Future) -> bool:
        """Every admission gate, under the lock: closed fails the future
        (False: do not enqueue); draining and a full ``shed`` queue raise
        ``OverloadedError``; a full ``block`` queue waits for space."""
        if self._closed:
            fut.set_exception(_shut_down())
            return False
        if self._draining:
            self._count_shed()
            raise OverloadedError(
                "admission stopped: engine is draining (preemption notice)")
        if len(self._q) >= self.max_queue:
            if self.admission == "shed":
                self._count_shed()
                raise OverloadedError(
                    f"admission queue full ({self.max_queue} requests); "
                    "policy=shed")
            while (len(self._q) >= self.max_queue
                   and not self._closed and not self._draining):
                self._space.wait(timeout=0.1)
            if self._closed:
                fut.set_exception(_shut_down())
                return False
            if self._draining:
                self._count_shed()
                raise OverloadedError(
                    "admission stopped: engine is draining (preemption notice)")
        return True

    def _resolve_deadline(self, now: float, slo_ms: Optional[float],
                          deadline: Optional[float]) -> float:
        if deadline is not None:
            return deadline
        return now + (slo_ms if slo_ms is not None else self.slo_ms) / 1000.0

    def submit(self, x, slo_ms: Optional[float] = None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one request (a leading batch axis); returns its Future.
        Shedding raises ``OverloadedError`` synchronously; a closed
        batcher fails the future."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request must have a leading batch axis, "
                             f"got shape {x.shape}")
        fut: Future = Future()
        now = self.clock()
        dl = self._resolve_deadline(now, slo_ms, deadline)
        with self._lock:
            if not self._admission_locked(fut):
                return fut
            self._q.append(_Request(x, fut, now, dl))
            self._nonempty.notify()
        return fut

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    # -- batch formation ---------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        """Fail-fast every queued request whose deadline already passed."""
        if not any(r.deadline < now for r in self._q):
            return
        keep: Deque[_Request] = deque()
        expired = 0
        for r in self._q:
            if r.deadline < now:
                expired += 1
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        f"request waited {(now - r.t_submit) * 1e3:.1f}ms in "
                        f"queue, past its "
                        f"{(r.deadline - r.t_submit) * 1e3:.0f}ms deadline"))
            else:
                keep.append(r)
        self._q = keep
        if self.metrics:
            self.metrics.inc("deadline_missed", expired)
        self._space.notify_all()

    def _pop_batch_locked(self) -> List[_Request]:
        batch: List[_Request] = []
        rows = 0
        while self._q:
            head = self._q[0]
            # split at max_batch before bucketing; one oversized request
            # still goes alone (it cannot be split)
            if batch and rows + head.rows > self.max_batch:
                break
            batch.append(self._q.popleft())
            rows += head.rows
            if rows >= self.max_batch:
                break
        self._space.notify_all()
        return batch

    def next_batch(self) -> Optional[List[_Request]]:
        """Block until a batch closes; None once closed and drained."""
        with self._lock:
            while True:
                now = self.clock()
                self._expire_locked(now)
                if not self._q:
                    if self._closed:
                        return None
                    self._nonempty.wait(timeout=0.5)
                    continue
                total = sum(r.rows for r in self._q)
                if total >= self.max_batch or self._closed:
                    return self._pop_batch_locked()
                earliest = min(r.deadline for r in self._q)
                oldest = min(r.t_submit for r in self._q)
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
                while self._q:
                    r = self._q.popleft()
                    if not r.future.done():
                        r.future.set_exception(_shut_down())
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
                       deadline: Optional[float] = None) -> Future:
        """Enqueue one decode request; the admission semantics of
        ``DynamicBatcher.submit``."""
        fut: Future = Future()
        now = self.clock()
        dl = self._resolve_deadline(now, slo_ms, deadline)
        with self._lock:
            if not self._admission_locked(fut):
                return fut
            r = _Request(np.empty((1, 0), np.float32), fut, now, dl)
            r.payload = payload
            self._q.append(r)
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
            while self._q and len(out) < limit:
                if (token_budget is not None and out
                        and spent + cost(self._q[0]) > token_budget):
                    break
                r = self._q.popleft()
                spent += cost(r)
                out.append(r)
            if out:
                self._space.notify_all()
            return out

    def requeue_front(self, r: _Request) -> None:
        """Put a request back at the head: admission raced ahead of
        capacity (no free pages or slot yet), or its batch crashed and it
        has retries left."""
        with self._lock:
            if self._closed:
                if not r.future.done():
                    r.future.set_exception(_shut_down())
                return
            self._q.appendleft(r)
            self._nonempty.notify()

    def wait_for_work(self, timeout: float = 0.05) -> bool:
        """Park the decode loop until a request is queued (or timeout /
        close).  True when work is pending."""
        with self._lock:
            if self._q or self._closed:
                return bool(self._q)
            self._nonempty.wait(timeout=timeout)
            return bool(self._q)
