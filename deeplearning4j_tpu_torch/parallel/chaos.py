"""Deterministic fault injection for the training stack (chaos testing;
mirrors ``deeplearning4j_tpu/parallel/chaos.py``: the same fault menu,
schedules drawn from the same ``np.random.default_rng`` stream, the same
bit-flip offsets).

The recovery loop around :class:`~.elastic.ElasticTrainer` — failure
detection, checkpoint restore, mesh rebuild, divergence guard — is exactly
the code that never runs in a healthy CI pass, yet at pod scale device
loss, torn checkpoint writes, hung collectives, and NaN-poisoned steps are
routine events (PAPERS.md: the TPU-supercomputer retrospective names
resilience, not peak FLOPs, as the availability lever).  This module makes
those events *scriptable and reproducible*:

- :class:`FaultSchedule` — a seeded/scripted map of step → fault kinds.
- :class:`ChaosInjector` — wraps a trainer (and optionally its
  CheckpointManager) and injects each scheduled fault at the scripted
  step: recoverable device errors, checkpoint-write crashes mid-zip,
  truncated / bit-flipped checkpoint files, hung steps, NaN gradients.

Usage:

    schedule = FaultSchedule.scripted({5: [FaultKind.DEVICE_LOSS],
                                       9: [FaultKind.NAN_GRADS]})
    inj = ChaosInjector(trainer, schedule)
    et = ElasticTrainer(inj, ckpt_dir, step_timeout=30.0, backoff_base=0.1)
    inj.attach_checkpoints(et.ckpt)      # arm the I/O faults too
    et.fit(data, epochs=1)               # faults fire; recovery must hold

Every fault is injected exactly once (consumed from the schedule), at a
deterministic step index, with any randomness (bit-flip offsets, random
schedules) drawn from seeded generators — a failing chaos run replays
bit-for-bit.  Injection happens INSIDE the ElasticTrainer's try block, so
a fault the stack cannot recover from fails the run loudly instead of
flaking.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs import trace as obs_trace

logger = logging.getLogger("deeplearning4j_tpu_torch")


class FaultKind:
    """The fault menu.  String constants (not an enum) so schedules stay
    JSON/CLI-friendly — ``--chaos device_loss@5,nan_grads@9``."""

    #: recoverable infra error raised from the step (device loss)
    DEVICE_LOSS = "device_loss"
    #: the next checkpoint write crashes mid-zip, leaving a stale .tmp
    CKPT_WRITE_CRASH = "ckpt_write_crash"
    #: truncate the newest on-disk checkpoint (torn write after rename)
    CKPT_TRUNCATE = "ckpt_truncate"
    #: flip bits in the middle of the newest on-disk checkpoint
    CKPT_BITFLIP = "ckpt_bitflip"
    #: the step blocks for ``hang_seconds`` (hung collective/dispatch)
    HUNG_STEP = "hung_step"
    #: the step's batch is poisoned with NaN features → NaN gradients
    NAN_GRADS = "nan_grads"
    #: SIGKILL this worker PROCESS at the scheduled step (host loss /
    #: preemption) — recovery is the LAUNCHER's job: it observes the
    #: death, bumps the membership epoch, and relaunches the worker,
    #: which resumes from the newest checkpoint (ElasticTrainer.resume)
    PROC_KILL = "proc_kill"
    #: SIGSTOP this worker — the process stays alive but its heartbeats
    #: stop, exercising the heartbeat-expiry path: the launcher must
    #: declare it dead, SIGKILL it, and relaunch
    PROC_HANG = "proc_hang"
    #: ANNOUNCED preemption: SIGTERM this worker at the scheduled step —
    #: its PreemptionHandler flips the notice flag, the step completes,
    #: and the next step boundary writes the grace-window emergency
    #: checkpoint and exits PREEMPTED (planned leave: the launcher
    #: relaunches WITHOUT consuming the restart budget)
    PREEMPT_NOTICE = "preempt_notice"
    #: SIGKILL the COORDINATOR process (legal only on the worker hosting
    #: the coordinator role, i.e. process 0) — recovery is coordinator
    #: restart: the launcher relaunches it, survivors re-initialize (or,
    #: if it never comes back, elect the lowest alive id from the ledger
    #: — launcher.elect_coordinator)
    COORD_KILL = "coord_kill"
    #: make THIS worker a straggler: every step from the scheduled one on
    #: is slowed by ``slow_seconds`` — the launcher must flag it (step
    #: time > k x the peer median for m consecutive beats) and, under the
    #: opt-in policy, kill-and-relaunch it
    SLOW_WORKER = "slow_worker"
    #: a serving replica THREAD dies mid-batch (uncaught exception) —
    #: the engine supervisor must complete the stranded futures, retry
    #: them on another replica, and respawn the thread (re-warmed)
    REPLICA_CRASH = "replica_crash"
    #: a serving replica's forward blocks past forward_timeout_s — the
    #: supervisor must abandon the hung incarnation, redispatch its
    #: batch, and respawn; the late wake-up's results are discarded
    REPLICA_HANG = "replica_hang"
    #: a serving request whose features are all-NaN — the batch's
    #: forward goes non-finite and the engine must bisect to isolate the
    #: poison request so co-batched requests still succeed (workload-side:
    #: the workload submits the poisoned request itself)
    POISON_INPUT = "poison_input"
    #: a regressed model version is canary-promoted — the registry's
    #: shadow-traffic comparison must auto-roll-back (workload-side: the
    #: workload registers the bad version and calls set_alias(canary=))
    BAD_VERSION = "bad_version"
    #: a whole serving HOST dies under live traffic (engine shutdown /
    #: process kill) — the fleet router must fail it over: in-flight
    #: futures resolve, survivors absorb the retries, nothing stranded
    HOST_KILL = "host_kill"
    #: a serving host takes an ANNOUNCED preemption notice — the router
    #: drains it within the grace budget (peers absorb the load) and
    #: takes it out of rotation as a planned leave
    HOST_PREEMPT = "host_preempt"
    #: a serving host turns straggler: every request it serves from the
    #: scheduled one on is slowed — least-loaded routing plus per-request
    #: timeouts must steer traffic away without failing the fleet SLO
    HOST_STRAGGLE = "host_straggle"

    ALL = (DEVICE_LOSS, CKPT_WRITE_CRASH, CKPT_TRUNCATE, CKPT_BITFLIP,
           HUNG_STEP, NAN_GRADS, PROC_KILL, PROC_HANG,
           PREEMPT_NOTICE, COORD_KILL, SLOW_WORKER,
           REPLICA_CRASH, REPLICA_HANG, POISON_INPUT, BAD_VERSION,
           HOST_KILL, HOST_PREEMPT, HOST_STRAGGLE)

    #: kinds that take down the whole PROCESS — only meaningful under a
    #: multi-process launcher (in-process soaks must not schedule them).
    #: preempt_notice is announced (SIGTERM -> graceful exit), coord_kill
    #: and proc_kill are unannounced (SIGKILL), proc_hang is a wedge.
    PROCESS_KINDS = (PROC_KILL, PROC_HANG, COORD_KILL, PREEMPT_NOTICE)

    #: kinds the TRAINING ChaosInjector can act on (FaultSchedule.random's
    #: default pool — serving kinds would be silent no-ops in a trainer)
    TRAINER_KINDS = (DEVICE_LOSS, CKPT_WRITE_CRASH, CKPT_TRUNCATE,
                     CKPT_BITFLIP, HUNG_STEP, NAN_GRADS, PROC_KILL,
                     PROC_HANG)

    #: serving-engine fault kinds;
    #: the first two are ENGINE-side (ServingChaos, armed on an Engine),
    #: the last two are WORKLOAD-side (the workload injects them)
    SERVING_KINDS = (REPLICA_CRASH, REPLICA_HANG, POISON_INPUT, BAD_VERSION)
    SERVING_ENGINE_KINDS = (REPLICA_CRASH, REPLICA_HANG)

    #: fleet-level fault kinds — all
    #: WORKLOAD-side: the load harness pops them per submitted request and
    #: acts on the fleet (kill/preempt/slow a host); the router under
    #: test only sees the consequences
    FLEET_KINDS = (HOST_KILL, HOST_PREEMPT, HOST_STRAGGLE)


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate ``path`` to ``keep_fraction`` of its bytes — a torn write."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_fraction)))


def bitflip_file(path: str, n_flips: int = 8, seed: int = 0) -> None:
    """Flip ``n_flips`` random bits in the middle half of ``path`` —
    deterministic for a given seed.  The middle half targets entry
    payloads (zip magic at the start and the central directory at the end
    fail loudly on their own; payload corruption is what only the v4
    integrity digests catch)."""
    rng = np.random.default_rng(seed)
    size = os.path.getsize(path)
    lo, hi = size // 4, max(size // 4 + 1, (3 * size) // 4)
    with open(path, "r+b") as f:
        for off in rng.integers(lo, hi, size=n_flips):
            f.seek(int(off))
            b = f.read(1)
            if not b:
                continue
            f.seek(int(off))
            f.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))


class FaultSchedule:
    """step index → list of fault kinds, deterministic and replayable.

    Steps are 1-based *injector call* indices (the first ``fit_batch`` the
    injector sees is step 1), counted across retries — a fault consumed at
    step k is not re-injected when recovery replays that step.
    """

    def __init__(self, faults: Optional[Dict[int, List[str]]] = None):
        self.faults: Dict[int, List[str]] = {
            int(k): list(v) for k, v in (faults or {}).items()}
        for kinds in self.faults.values():
            for kind in kinds:
                if kind not in FaultKind.ALL:
                    raise ValueError(f"unknown fault kind {kind!r} — one of "
                                     f"{FaultKind.ALL}")

    @classmethod
    def scripted(cls, faults: Dict[int, Any]) -> "FaultSchedule":
        """{step: kind or [kinds]} → schedule."""
        return cls({s: ([k] if isinstance(k, str) else list(k))
                    for s, k in faults.items()})

    @classmethod
    def random(cls, seed: int, n_steps: int, rate: float = 0.05,
               kinds: Optional[List[str]] = None) -> "FaultSchedule":
        """Seeded random schedule: each step draws a fault with probability
        ``rate``, kind uniform over ``kinds`` (default: the trainer-
        injectable kinds).  Same seed → same schedule, so a failing soak
        replays exactly."""
        kinds = list(kinds or FaultKind.TRAINER_KINDS)
        rng = np.random.default_rng(seed)
        faults: Dict[int, List[str]] = {}
        for step in range(1, n_steps + 1):
            if rng.random() < rate:
                faults[step] = [kinds[int(rng.integers(0, len(kinds)))]]
        return cls(faults)

    def pop(self, step: int) -> List[str]:
        """Faults scheduled at ``step``, consumed (injected once)."""
        return self.faults.pop(step, [])

    def pending(self) -> int:
        return sum(len(v) for v in self.faults.values())

    def __repr__(self) -> str:
        return f"FaultSchedule({self.faults!r})"


class ChaosInjector:
    """Wraps a trainer-like object (``fit_batch`` + ``net``) and injects
    scheduled faults.  Sits BETWEEN the ElasticTrainer and the real
    trainer, so every injected fault exercises the real recovery path::

        ElasticTrainer(ChaosInjector(trainer, schedule), ckpt_dir, ...)

    Checkpoint-I/O faults (write crash, corrupt-on-disk) additionally need
    ``attach_checkpoints(et.ckpt)`` to arm the manager wrappers.
    """

    def __init__(self, trainer, schedule: FaultSchedule,
                 hang_seconds: float = 0.0,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 seed: int = 0,
                 slow_seconds: Optional[float] = None):
        self.trainer = trainer
        self.schedule = schedule
        self.hang_seconds = hang_seconds
        self.sleep_fn = sleep_fn
        self.seed = seed
        # slow_worker persistent per-step drag (defaults to hang_seconds
        # so a bare 'slow_worker@k' spec still slows something)
        self.slow_seconds = (hang_seconds if slow_seconds is None
                             else slow_seconds)
        self._slow_s = 0.0
        self.step = 0              # injector call index (1-based in events)
        self.events: List[dict] = []   # (step, kind) log, replayable
        self._ckpt = None
        self._crash_next_write = False

    # -- trainer protocol --------------------------------------------------

    @property
    def net(self):
        return getattr(self.trainer, "net", self.trainer)

    def _place_model(self) -> None:
        if hasattr(self.trainer, "_place_model"):
            self.trainer._place_model()

    # -- checkpoint I/O faults ---------------------------------------------

    def attach_checkpoints(self, ckpt) -> None:
        """Arm checkpoint-write faults on a CheckpointManager: its ``save``
        / ``save_async`` are wrapped so a scheduled CKPT_WRITE_CRASH makes
        the NEXT write die mid-zip — a partial ``.tmp`` is left behind
        (the stale-tmp leak CheckpointManager.__init__ cleans) and the
        final rename never happens, exactly a crash between write and
        rename."""
        self._ckpt = ckpt
        real_save, real_save_async = ckpt.save, ckpt.save_async

        def save(net, step):
            self._maybe_crash_write(step)
            return real_save(net, step)

        def save_async(net, step):
            self._maybe_crash_write(step)
            return real_save_async(net, step)

        ckpt.save, ckpt.save_async = save, save_async

    def _maybe_crash_write(self, step: int) -> None:
        if not self._crash_next_write:
            return
        self._crash_next_write = False
        tmp = self._ckpt._path(step) + ".tmp"
        with open(tmp, "wb") as f:        # the torn half-written zip
            f.write(b"PK\x03\x04 chaos: torn checkpoint write")
        self._log(self.step, FaultKind.CKPT_WRITE_CRASH,
                  f"crashed write of step {step}, stale tmp left")
        raise RuntimeError(
            "DATA_LOSS: chaos — checkpoint write crashed mid-zip")

    def _corrupt_latest(self, kind: str) -> None:
        if self._ckpt is None:
            raise RuntimeError(f"{kind} scheduled but no CheckpointManager "
                               "attached (call attach_checkpoints)")
        latest = self._ckpt.latest()
        if latest is None:
            self._log(self.step, kind, "no checkpoint on disk yet — no-op")
            return
        path, step = latest
        if kind == FaultKind.CKPT_TRUNCATE:
            truncate_file(path)
        else:
            bitflip_file(path, n_flips=16, seed=self.seed + self.step)
        self._log(self.step, kind, f"corrupted {os.path.basename(path)}")

    # -- the wrapped step --------------------------------------------------

    def _log(self, step: int, kind: str, detail: str = "") -> None:
        self.events.append({"step": step, "kind": kind, "detail": detail})
        obs_trace.instant("fault", cat="chaos", kind=kind, step=step,
                          detail=detail)
        logger.warning("chaos @%d: %s %s", step, kind, detail)

    def injected(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.events)
        return sum(1 for e in self.events if e["kind"] == kind)

    def fit_batch(self, ds):
        self.step += 1
        faults = self.schedule.pop(self.step)
        for kind in faults:
            if kind == FaultKind.DEVICE_LOSS:
                self._log(self.step, kind)
                raise RuntimeError("UNAVAILABLE: chaos — device lost")
            if kind == FaultKind.CKPT_WRITE_CRASH:
                self._crash_next_write = True   # fires inside the manager
            elif kind in (FaultKind.CKPT_TRUNCATE, FaultKind.CKPT_BITFLIP):
                self._corrupt_latest(kind)
            elif kind == FaultKind.HUNG_STEP:
                self._log(self.step, kind, f"sleeping {self.hang_seconds}s")
                self.sleep_fn(self.hang_seconds)
            elif kind == FaultKind.NAN_GRADS:
                self._log(self.step, kind, "poisoning batch features")
                ds = _poison_dataset(ds)
            elif kind == FaultKind.SLOW_WORKER:
                self._log(self.step, kind,
                          f"+{self.slow_seconds}s per step from here on")
                self._slow_s = self.slow_seconds
            elif kind == FaultKind.PREEMPT_NOTICE:
                self._announce_preemption()
            elif kind in FaultKind.PROCESS_KINDS:
                self._kill_self(kind)
        out = self.trainer.fit_batch(ds)
        if self._slow_s:
            # the straggler drag: stretch THIS worker's step wall time
            # (never the math) so the launcher's peer-median detection
            # has a real slow host to flag
            self.sleep_fn(self._slow_s)
        return out

    def _announce_preemption(self) -> None:
        """SIGTERM self at the scheduled step — the ANNOUNCED failure:
        unlike _kill_self the process survives the signal; the installed
        PreemptionHandler flips its flag, this step completes normally,
        and the next step boundary runs the grace-window emergency
        checkpoint and exits PREEMPTED."""
        import signal
        self._log(self.step, FaultKind.PREEMPT_NOTICE,
                  f"SIGTERM (notice) pid {os.getpid()}")
        os.kill(os.getpid(), signal.SIGTERM)

    def _kill_self(self, kind: str) -> None:
        """Take down THIS worker process — SIGKILL (proc_kill/coord_kill)
        or SIGSTOP (proc_hang).  Self-injection makes the death exactly
        step-deterministic (no launcher-side polling race): the schedule
        says step k, the process is gone before step k runs.  The signal
        fires before any file I/O of the step, so checkpoints on disk stay
        atomic-rename-clean.  coord_kill is proc_kill aimed at the
        COORDINATOR process (process 0) — the distinct kind keeps the
        event log honest about WHAT died, because recovery differs:
        survivors must re-initialize against the restarted (or re-elected)
        coordinator, not just keep training."""
        import signal
        if kind == FaultKind.COORD_KILL:
            from .distributed import resolve_process_index
            if resolve_process_index() != 0:
                raise RuntimeError(
                    "coord_kill scheduled on a non-coordinator worker "
                    f"(process {resolve_process_index()}) — aim it at "
                    "process 0, the coordinator host")
        sig = (getattr(signal, "SIGSTOP", None)
               if kind == FaultKind.PROC_HANG else signal.SIGKILL)
        if sig is None:
            raise RuntimeError(f"{kind} unsupported on this platform "
                               "(no SIGSTOP)")
        self._log(self.step, kind,
                  f"{'SIGSTOP' if kind == FaultKind.PROC_HANG else 'SIGKILL'}"
                  f" pid {os.getpid()}")
        # flush logging AND the trace ring before the process vanishes
        # mid-statement — the proc_kill instant must survive into the
        # worker's trace file so the merged pod timeline shows the death
        for h in logging.getLogger().handlers + logger.handlers:
            try:
                h.flush()
            except (OSError, ValueError):
                pass   # closed/broken stream — the process dies next line
        obs_trace.flush()
        os.kill(os.getpid(), sig)
        # SIGSTOP parks the process here until the launcher SIGKILLs (or
        # SIGCONTs) it; SIGKILL never returns


class ServingChaos:
    """Deterministic fault injection for the serving engine — the
    serving analog of :class:`ChaosInjector`.

    The schedule is keyed by the engine's GLOBAL batch-execution index
    (1-based: the first batch any replica dequeues is 1, counted across
    all replicas under a lock, so a schedule replays deterministically
    for a deterministic workload).  Only ENGINE-side kinds are legal
    here (``replica_crash``, ``replica_hang``); workload-side kinds
    (``poison_input``, ``bad_version``) are injected by the workload
    itself.

    The predict engine takes it as ``Engine(chaos=)``.  A
    ``replica_crash`` raises out of the replica loop so the thread
    genuinely dies with its batch in limbo; a ``replica_hang`` parks the
    replica thread in a sleep longer than the engine's
    ``forward_timeout_s`` — both must be recovered by the supervisor.
    """

    def __init__(self, schedule: FaultSchedule, hang_seconds: float = 2.0,
                 sleep_fn: Callable[[float], None] = time.sleep):
        for kinds in schedule.faults.values():
            for kind in kinds:
                if kind not in FaultKind.SERVING_ENGINE_KINDS:
                    raise ValueError(
                        f"{kind!r} is not an engine-side serving fault — "
                        f"ServingChaos takes {FaultKind.SERVING_ENGINE_KINDS}"
                        "; poison_input/bad_version are injected by the "
                        "workload")
        self.schedule = schedule
        self.hang_seconds = hang_seconds
        self.sleep_fn = sleep_fn
        self.batch_index = 0
        self.events: List[dict] = []
        self._lock = threading.Lock()

    def pop_batch(self, replica_idx: int) -> List[str]:
        """Faults scheduled for the next global batch index, consumed.
        Called by every replica thread as it dequeues a batch."""
        with self._lock:
            self.batch_index += 1
            kinds = self.schedule.pop(self.batch_index)
            for kind in kinds:
                self.events.append({"batch": self.batch_index, "kind": kind,
                                    "replica": replica_idx,
                                    "t": time.monotonic()})
                obs_trace.instant("fault", cat="chaos", kind=kind,
                                  batch=self.batch_index,
                                  replica=replica_idx)
                logger.warning("serving chaos @batch %d: %s (replica %d)",
                               self.batch_index, kind, replica_idx)
        return kinds

    def injected(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is None:
                return len(self.events)
            return sum(1 for e in self.events if e["kind"] == kind)


class FleetChaos:
    """Deterministic fault injection for a serving FLEET — the fleet
    analog of :class:`ServingChaos`, keyed by the 1-based index of
    requests SUBMITTED to the router (not batches executed: the load
    harness is open-loop, so submission order is the deterministic,
    replayable axis — execution order under failover is not).

    All fleet kinds are workload-side: the load harness calls
    ``pop_request()`` before each submission and acts on what comes back
    (kill a host's engine, deliver a preemption notice, slow a host) —
    the :class:`~..serving.fleet.FleetRouter` under test only observes
    the consequences.  The fleet is not ported yet (ROADMAP queue 1
    item 8.2).
    """

    def __init__(self, schedule: FaultSchedule,
                 clock: Callable[[], float] = time.monotonic):
        for kinds in schedule.faults.values():
            for kind in kinds:
                if kind not in FaultKind.FLEET_KINDS:
                    raise ValueError(
                        f"{kind!r} is not a fleet fault — FleetChaos takes "
                        f"{FaultKind.FLEET_KINDS}")
        self.schedule = schedule
        self.clock = clock
        self.request_index = 0
        self.events: List[dict] = []
        self._lock = threading.Lock()

    def pop_request(self) -> List[str]:
        """Faults scheduled for the next request index, consumed.
        Called by the load harness once per submitted request."""
        with self._lock:
            self.request_index += 1
            kinds = self.schedule.pop(self.request_index)
            for kind in kinds:
                self.events.append({"request": self.request_index,
                                    "kind": kind, "t": self.clock()})
                obs_trace.instant("fault", cat="chaos", kind=kind,
                                  request=self.request_index)
                logger.warning("fleet chaos @request %d: %s",
                               self.request_index, kind)
        return kinds

    def injected(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is None:
                return len(self.events)
            return sum(1 for e in self.events if e["kind"] == kind)


def _poison_dataset(ds):
    """A copy of ``ds`` whose features are all-NaN: the forward and
    backward then give non-finite gradients, which drive the real
    divergence guard."""
    import torch

    f = ds.features
    feats = (torch.full_like(f, float("nan"), dtype=torch.float32)
             if isinstance(f, torch.Tensor)
             else np.full_like(np.asarray(f, dtype=np.float32), np.nan))
    return type(ds)(feats, ds.labels, ds.features_mask, ds.labels_mask)
