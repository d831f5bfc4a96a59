"""Announced failures: preemption notices + grace-window emergency exit
(mirrors ``deeplearning4j_tpu/parallel/preemption.py``).

The chaos stack (chaos.py / launcher.py) models UNANNOUNCED death —
SIGKILL, SIGSTOP, torn writes.  Real pods mostly die the other way: the
scheduler *announces* maintenance/preemption and grants a grace window
(PAPERS.md: the TPU-supercomputer retrospective frames surviving these
announced events as the headline production problem).  Before this
module, a planned preemption was handled as a crash: full
heartbeat-timeout detection latency, a burned restart-budget slot, and
every step since the last interval checkpoint lost.

:class:`PreemptionHandler` is the announced path:

- ``install()`` catches SIGTERM/SIGUSR1 (the notice).  The signal
  handler only flips a flag and stamps the deadline — everything heavy
  runs at the next STEP BOUNDARY, where model state is consistent.
  A second notice is idempotent (schedulers re-signal).
- On notice it marks this worker **leaving** in the shared
  :class:`~.launcher.Membership` ledger, so survivors observe a fast
  LEAVE instead of waiting out the heartbeat timeout.
- ``check(trainer)`` — called by ``ElasticTrainer`` at every step
  boundary — runs the deadline-bounded **emergency checkpoint**: the
  in-memory :class:`~.elastic._HostSnapshot` is captured immediately
  (host RAM is safe even if devices are reclaimed mid-write), then
  written deflate-compressed when the remaining grace affords it, or
  uncompressed (``ZIP_STORED``) when it doesn't — a torn emergency
  checkpoint is worthless, a fat one is fine.  Then it raises
  :class:`PreemptedError`.
- The CLI/worker entry points convert ``PreemptedError`` into the
  distinct :data:`~.distributed.PREEMPTED_EXIT_CODE` so the launcher
  can tell a planned leave (relaunch WITHOUT consuming the restart
  budget) from a crash.

The grace budget comes from ``DL4J_TPU_GRACE_S`` (exported by the
launcher, overridable per worker) or the CLI ``--grace`` flag.

On several ranks the snapshot is a collective (``elastic._HostSnapshot``
of a ``ShardedTrainer``): ``ElasticTrainer`` agrees a notice across the
ranks at the step boundary, so every rank runs ``check`` together and
only the writer writes.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Callable, Optional

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from .distributed import (
    ENV_GRACE_S, ENV_RUN_DIR, PREEMPTED_EXIT_CODE, resolve_process_index,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: default grace budget when neither env nor caller specifies one —
#: cloud preemption notices commonly grant 30s
DEFAULT_GRACE_S = 30.0


class PreemptedError(RuntimeError):
    """This worker received a preemption notice and has written its
    emergency checkpoint — the process must now exit with
    :data:`PREEMPTED_EXIT_CODE`.  ``recoverable = False`` tells the
    elastic FailureDetector this is NOT a failure to retry: the host is
    going away and recovery belongs to the launcher (fast LEAVE +
    relaunch + ``ElasticTrainer.resume``)."""

    recoverable = False
    exit_code = PREEMPTED_EXIT_CODE

    def __init__(self, step: int, checkpoint_path: Optional[str] = None,
                 stored: bool = False, seconds: Optional[float] = None):
        where = (f"emergency checkpoint {os.path.basename(checkpoint_path)}"
                 f" ({'stored' if stored else 'deflate'}, {seconds:.2f}s)"
                 if checkpoint_path else "no emergency checkpoint "
                 "(non-writer host — state is replicated)")
        super().__init__(
            f"preempted at step {step}: {where}; exiting "
            f"{PREEMPTED_EXIT_CODE} (planned leave)")
        self.step = step
        self.checkpoint_path = checkpoint_path
        self.stored = stored
        self.seconds = seconds


class PreemptionHandler:
    """Catch preemption notices and drive the grace-window emergency
    checkpoint.  See the module docstring for the lifecycle.

    ``grace_s`` — seconds between notice and the host going away
    (default: ``DL4J_TPU_GRACE_S`` env, else 30).  ``membership`` /
    ``process_id`` — when set (or resolvable from the launcher env),
    the notice marks this worker *leaving* in the shared ledger.
    ``stored_floor_s`` and ``deflate_margin`` tune the codec decision:
    the deflate path is taken only when the remaining grace exceeds
    ``max(deflate_margin * last_save_seconds, stored_floor_s)`` — with
    no prior save measurement the floor alone decides.  ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, grace_s: Optional[float] = None,
                 signals=(signal.SIGTERM, signal.SIGUSR1),
                 membership=None, process_id: Optional[int] = None,
                 stored_floor_s: float = 1.0,
                 deflate_margin: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        if grace_s is None:
            grace_s = float(os.environ.get(ENV_GRACE_S, DEFAULT_GRACE_S))
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.grace_s = grace_s
        self.signals = tuple(signals)
        self.membership = membership
        self.process_id = resolve_process_index(process_id)
        self.stored_floor_s = stored_floor_s
        self.deflate_margin = deflate_margin
        self.clock = clock
        self.notice_count = 0
        self._notice_t: Optional[float] = None
        self._prev_handlers: dict = {}
        reg = get_registry()
        self._m_notices = reg.counter("preemption_notices_total")
        self._m_emergency = reg.counter("emergency_checkpoints_total")

    # -- signal plumbing ---------------------------------------------------

    def install(self) -> "PreemptionHandler":
        """Register the signal handlers (main thread only — Python's
        constraint); previous handlers are saved for ``uninstall``."""
        for sig in self.signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers.clear()

    @classmethod
    def install_from_env(cls, grace_s: Optional[float] = None,
                         **kw) -> "PreemptionHandler":
        """The worker entry point's one-liner: grace from the env
        contract, leaving-marker wired to the launcher's run dir when
        present (standalone runs simply skip the ledger)."""
        membership = kw.pop("membership", None)
        if membership is None:
            run_dir = os.environ.get(ENV_RUN_DIR)
            if run_dir:
                from .launcher import Membership
                membership = Membership(run_dir)
        return cls(grace_s=grace_s, membership=membership, **kw).install()

    def _on_signal(self, signum, frame) -> None:
        self.notice(signum)

    # -- notice ------------------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._notice_t is not None

    @property
    def remaining_s(self) -> float:
        """Grace budget left (full budget before any notice)."""
        if self._notice_t is None:
            return self.grace_s
        return self.grace_s - (self.clock() - self._notice_t)

    def notice(self, signum: Optional[int] = None) -> None:
        """Record a preemption notice.  Idempotent: the FIRST notice
        stamps the deadline and marks the ledger; repeats only count
        (schedulers re-signal, and the launcher may forward its own
        SIGTERM on top of the scheduler's)."""
        self.notice_count += 1
        if self._notice_t is not None:
            logger.info("preemption notice repeated (%d) — deadline "
                        "unchanged, %.1fs remaining", self.notice_count,
                        self.remaining_s)
            return
        self._notice_t = self.clock()
        self._m_notices.inc()
        obs_trace.instant("preempt/notice", cat="preempt",
                          signum=signum, grace_s=self.grace_s,
                          process=self.process_id)
        logger.warning("preemption notice (signal %s): %.1fs grace — "
                       "emergency checkpoint at the next step boundary",
                       signum, self.grace_s)
        if self.membership is not None:
            try:
                self.membership.mark_leaving(self.process_id,
                                             grace_s=self.grace_s)
            except OSError as exc:   # ledger gone — notice still stands
                logger.debug("leaving marker write failed: %s", exc)

    # -- the grace-window exit ---------------------------------------------

    def check(self, trainer) -> None:
        """Step-boundary hook (``ElasticTrainer`` calls this before every
        step): no-op until a notice arrived, then emergency-checkpoint
        and raise :class:`PreemptedError`."""
        if self._notice_t is None:
            return
        path, stored, seconds = self.emergency_checkpoint(
            trainer.ckpt, getattr(trainer, "_snapshot_source", trainer.net),
            trainer.global_step)
        if hasattr(trainer, "_record_durable"):
            trainer._record_durable(trainer.global_step, path)
        raise PreemptedError(trainer.global_step, path, stored, seconds)

    def emergency_checkpoint(self, ckpt, net, step: int):
        """Deadline-bounded checkpoint: snapshot NOW (``net``: a network,
        or a trainer whose snapshot is a collective), then pick the codec
        the remaining grace affords.  → (path | None, used_stored,
        seconds)."""
        from .elastic import _HostSnapshot

        t0 = self.clock()
        with obs_trace.span("ckpt/emergency", cat="ckpt", step=step,
                            grace_s=self.grace_s) as sp:
            # host copy first: device buffers may be reclaimed any moment
            snap = _HostSnapshot(net)
            remaining = self.remaining_s
            deflate_cost = max(
                self.deflate_margin * (ckpt.last_save_seconds or 0.0),
                self.stored_floor_s)
            stored = remaining < deflate_cost
            path = ckpt.save_snapshot(snap, step, compressed=not stored,
                                      prune=False)
            seconds = self.clock() - t0
            self._m_emergency.inc()
            sp.set(stored=stored, seconds=round(seconds, 3),
                   within_grace=seconds <= self.grace_s,
                   path=os.path.basename(path) if path else None)
        logger.warning(
            "emergency checkpoint @%d: %s in %.2fs (%.1fs of grace left)",
            step, (os.path.basename(path) if path
                   else "skipped (non-writer)"), seconds,
            self.remaining_s)
        return path, stored, seconds
