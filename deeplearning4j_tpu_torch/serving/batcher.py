"""Admission queue of the decode engine (mirrors
``deeplearning4j_tpu/serving/batcher.py``: the ``ContinuousBatcher``
surface the plain ``DecodeEngine`` uses, plus ``pow2_buckets`` and the
admission errors).

One FIFO lane: per-tenant fair-share lanes, quotas and model routing
are later work.  ``admit`` takes the reference's chunked-prefill token
budget.  The queue is bounded (``max_queue``) with a ``block``
(backpressure the caller) or ``shed`` (raise ``OverloadedError``)
policy, and a request whose deadline passes while still queued fails
fast with ``DeadlineExceededError``.  ``clock`` is injectable.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, List, Optional

ADMISSION_POLICIES = ("block", "shed")


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before a slot freed up."""


class OverloadedError(RuntimeError):
    """The admission queue is full and the policy is ``shed``."""


class _Request:
    __slots__ = ("payload", "future", "t_submit", "deadline", "retries")

    def __init__(self, payload: Any, future: Future, t_submit: float,
                 deadline: float):
        self.payload = payload
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline
        self.retries = 0        # crash-retries so far (the decode engine)


def pow2_buckets(max_batch: int) -> List[int]:
    """1, 2, 4, ... up to and including ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


class ContinuousBatcher:
    """Iteration-level admission: callers ``submit_request``; the decode
    loop calls ``admit(limit)`` at every step boundary, so a new request
    joins the running batch at the next step."""

    def __init__(self, max_batch: int = 32, slo_ms: float = 50.0,
                 max_queue: int = 1024, admission: str = "block",
                 metrics=None, clock=time.monotonic):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        if max_batch < 1 or max_queue < 1 or slo_ms <= 0:
            raise ValueError("max_batch/max_queue must be >=1, slo_ms > 0")
        self.max_batch = int(max_batch)
        self.slo_ms = float(slo_ms)
        self.max_queue = int(max_queue)
        self.admission = admission
        self.metrics = metrics
        self.clock = clock
        self._q: Deque[_Request] = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._closed = False

    def submit_request(self, payload, slo_ms: Optional[float] = None,
                       deadline: Optional[float] = None) -> Future:
        """Enqueue one request; shedding raises ``OverloadedError``
        synchronously, a closed batcher fails the future."""
        fut: Future = Future()
        now = self.clock()
        dl = deadline if deadline is not None else now + (
            slo_ms if slo_ms is not None else self.slo_ms) / 1000.0
        with self._lock:
            if not self._closed and len(self._q) >= self.max_queue:
                if self.admission == "shed":
                    if self.metrics:
                        self.metrics.inc("shed")
                    raise OverloadedError(
                        f"admission queue full ({self.max_queue} requests); "
                        "policy=shed")
                while len(self._q) >= self.max_queue and not self._closed:
                    self._space.wait(timeout=0.1)
            if self._closed:
                fut.set_exception(RuntimeError("serving engine is shut down"))
                return fut
            self._q.append(_Request(payload, fut, now, dl))
            self._nonempty.notify()
        return fut

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    def _expire_locked(self, now: float) -> None:
        """Fail-fast every queued request whose deadline already passed."""
        if not any(r.deadline < now for r in self._q):
            return
        keep: Deque[_Request] = deque()
        for r in self._q:
            if r.deadline < now:
                if self.metrics:
                    self.metrics.inc("deadline_missed")
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        f"request waited {(now - r.t_submit) * 1e3:.1f}ms in "
                        f"queue, past its "
                        f"{(r.deadline - r.t_submit) * 1e3:.0f}ms deadline"))
            else:
                keep.append(r)
        self._q = keep
        self._space.notify_all()

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
        """Put a request back at the head — admission raced ahead of
        capacity (no free pages or slot yet), or its batch crashed and it
        has retries left."""
        with self._lock:
            if self._closed:
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError("serving engine is shut down"))
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

    def close(self, fail_pending: bool = True) -> None:
        """Idempotent; with ``fail_pending`` every queued future fails."""
        with self._lock:
            self._closed = True
            if fail_pending:
                while self._q:
                    r = self._q.popleft()
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError("serving engine is shut down"))
            self._nonempty.notify_all()
            self._space.notify_all()
