"""Load-driven replica autoscaling: the control law, nothing else (a copy
of ``deeplearning4j_tpu/serving/autoscale.py``).

``ReplicaAutoscaler`` is a pure controller — it observes load signals
(queue depth, in-flight count, shed-counter delta) and answers
"+1 / 0 / -1 replicas".  It owns no threads and touches no engine state,
so it unit-tests with a fake clock and the Engine/DecodeEngine supervisor
loops can tick it from their existing cadence.  Actuation (replica
birth/retire) lives in the engines, which reuse the respawn
machinery.  In the port a replica born on a card captures its CUDA
graphs of every warmed (bucket, dtype) pair before it becomes routable,
so no request pays a capture (``serving/engine.py``).

Control law (classic hysteresis + cooldown):

* load = (queue_depth + inflight) / replicas; a shed in the last tick
  counts as high load regardless (shedding means admission is already
  failing users — queue depth alone can look calm under ``shed`` mode).
* ``up_ticks`` consecutive high ticks → +1 (bounded by ``max_replicas``);
  ``down_ticks`` consecutive low ticks → -1 (bounded by
  ``min_replicas``).  Mid-band ticks reset both streaks.
* After any action, ``cooldown_s`` of enforced silence lets the new
  replica count actually absorb/free load before the next decision —
  without it a burst triggers a scale-up stampede and the tail of the
  burst immediately flaps back down.
"""
from __future__ import annotations

import time
from typing import Callable, Optional


class ReplicaAutoscaler:
    """Hysteresis + cooldown controller over serving load signals.

    The clock is injectable: tests drive cooldown with a fake
    monotonic clock instead of sleeping.
    """

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 4,
        up_load: float = 2.0,
        down_load: float = 0.25,
        up_ticks: int = 2,
        down_ticks: int = 5,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if down_load >= up_load:
            raise ValueError("down_load must be < up_load (hysteresis band)")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_load = up_load
        self.down_load = down_load
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._hi = 0
        self._lo = 0
        self._last_action_t: Optional[float] = None

    def load(self, queue_depth: int, inflight: int, replicas: int) -> float:
        return (queue_depth + inflight) / max(1, replicas)

    def observe(
        self,
        queue_depth: int,
        inflight: int,
        replicas: int,
        shed_delta: int = 0,
    ) -> int:
        """One control tick.  Returns +1 (add a replica), -1 (retire one),
        or 0 (hold)."""
        now = self._clock()
        load = self.load(queue_depth, inflight, replicas)
        if shed_delta > 0 or load >= self.up_load:
            self._hi += 1
            self._lo = 0
        elif load <= self.down_load:
            self._lo += 1
            self._hi = 0
        else:
            self._hi = 0
            self._lo = 0
        if (
            self._last_action_t is not None
            and now - self._last_action_t < self.cooldown_s
        ):
            return 0
        if self._hi >= self.up_ticks and replicas < self.max_replicas:
            self._hi = self._lo = 0
            self._last_action_t = now
            return 1
        if self._lo >= self.down_ticks and replicas > self.min_replicas:
            self._hi = self._lo = 0
            self._last_action_t = now
            return -1
        return 0

    def reset(self) -> None:
        """Forget streaks and cooldown (e.g. after a model swap)."""
        self._hi = self._lo = 0
        self._last_action_t = None
