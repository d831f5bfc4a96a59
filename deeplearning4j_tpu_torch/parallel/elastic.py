"""Elastic training: checkpoint-resume and failure recovery (mirrors
``deeplearning4j_tpu/parallel/elastic.py``).

The recovery loop: (1) detect a failed step, (2) rebuild over what is
still healthy (``rebuild_fn``: a new process group and mesh), (3)
restore the newest intact checkpoint, (4) continue.  Checkpoints are the
framework's own zips (``utils/serializer.py``), so a restored model is a
plain checkpoint either package reads.

``ElasticTrainer`` wraps any trainer-like object with ``fit_batch(ds)``
and a ``net`` (a network, a ``ShardedTrainer``, a ``ChaosInjector``).

What differs from the reference, and why:

- The snapshot is taken on EVERY rank.  A ``ShardedTrainer`` holds
  parameter slices (a ``model`` axis) and its slice's residual; its
  ``_snapshot_state`` gathers them, a collective.  So ``save`` /
  ``save_async`` / the emergency checkpoint take the snapshot on every
  rank and only the writer writes it (a gather behind the writer check
  would leave rank 0 waiting forever).
- The snapshot is a copy: ``.to("cpu", copy=True)`` of every tensor (on
  the CPU ``.detach()`` alone shares the live parameter's memory, and an
  async write would serialize weights later steps moved).  Tensors keep
  their dtype, so bfloat16 moments are written bit for bit.
- A collective blocks the caller's thread, so the watchdog cannot bound
  it: the process group's own timeout does (``distributed.initialize
  (collective_timeout_s=)``), and gloo's and NCCL's timeout and
  peer-loss texts are in ``RECOVERABLE_MARKERS``.  A sticky CUDA error is
  never recoverable in-process: it propagates and the launcher relaunches
  the process.
- ``fit`` replays the data from the restored step: after a restore to
  step s the next batch is the one at position s (the reference retries
  the batch that failed), so a recovered run's trajectory is the
  fault-free one.  It streams the iterator as the reference does and
  holds only the batches a restore can go back to: those since the
  oldest of the last ``keep_last`` checkpoints it took.  With
  ``skip_done=True`` a resumed run starts at the restored step's
  position too.
- Ranks that step together (a collective trainer on several ranks)
  restore one step: the writer waits for its write in flight, picks the
  newest intact checkpoint and broadcasts its step, and every other rank
  loads exactly that step (alone, a non-writer would restore whatever was
  on disk, possibly an older step).
- On such ranks a preemption notice any rank took is agreed every
  ``sync_every`` steps, at the boundaries after a step whose loss was
  read (one MAX all-reduce of a flag there only): every rank then takes
  the collective emergency snapshot and leaves together.
"""

from __future__ import annotations

import collections
import logging
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from .distributed import resolve_process_index

logger = logging.getLogger("deeplearning4j_tpu_torch")


class RecoverableInfraError(RuntimeError):
    """Base class of failures the elastic stack recovers from by
    construction (host lost, membership change, hung step)."""


def _host_copy(tree):
    """A tree of tensors copied to host memory (always a copy, dtype kept)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _state_source(obj):
    """The innermost object of a trainer chain (``.trainer``) that takes a
    collective snapshot (``_snapshot_state``), else the network."""
    seen = obj
    while seen is not None:
        if hasattr(seen, "_snapshot_state"):
            return seen
        seen = getattr(seen, "trainer", None)
    return getattr(obj, "net", obj)


class _HostSnapshot:
    """A host copy of a model's persistent state that quacks like the
    network for ``serializer.save_model``, so the write can run on a
    background thread while training goes on.  ``source`` is a network,
    or a trainer with ``_snapshot_state()`` (a collective: every rank
    constructs the snapshot)."""

    def __init__(self, source):
        src = _state_source(source)
        net = getattr(src, "net", src)
        if hasattr(src, "_snapshot_state"):
            params, state, opt_state, residual = src._snapshot_state()
        else:
            params, state, opt_state = net.params, net.state, net.opt_state
            residual = getattr(net, "grad_residual", None)
        self.conf = net.conf
        self.params = _host_copy(params)
        self.state = _host_copy(state)
        self.opt_state = _host_copy(opt_state)
        self.grad_residual = None if residual is None else _host_copy(residual)
        self.iteration = net.iteration
        self.epoch = getattr(net, "epoch", 0)
        self._model_class = type(net).__name__

    def save(self, path: str, save_updater: bool = True,
             compression: Optional[int] = None) -> None:
        import zipfile

        from ..utils.serializer import save_model

        save_model(self, path, save_updater=save_updater,
                   compression=(zipfile.ZIP_DEFLATED if compression is None
                                else compression))


def _is_collective(obj) -> bool:
    return hasattr(_state_source(obj), "_snapshot_state")


def _group():
    """The default process group's ``torch.distributed`` when it spans
    several ranks, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist
    return None


class CheckpointManager:
    """Rolling checkpoint store (the reference's CheckpointListener
    semantics: keep the last N; zip format of utils/serializer).

    ``save_async`` takes the host snapshot on the caller's thread and
    writes it (deflate, atomic rename) on one background thread.

    Every process of a job shares one directory; ``role`` decides who
    writes: ``"auto"`` (process index 0: an explicit ``process_id``, the
    launcher's ``DL4J_TPU_PROCESS_ID``, or the rank), ``"writer"`` /
    ``"reader"``, or ``"per_host"`` (each process its own
    ``checkpoint_X.h<process>.zip``).  Restore and list work everywhere."""

    _NAME_RE = re.compile(r"^checkpoint_(\d+)(?:\.h(\d+))?\.zip$")

    def __init__(self, directory: str, keep_last: int = 3,
                 role: str = "auto", process_id: Optional[int] = None):
        if role not in ("auto", "writer", "reader", "per_host"):
            raise ValueError(f"role must be auto/writer/reader/per_host, "
                             f"got {role!r}")
        self.directory = directory
        self.keep_last = keep_last
        self.role = role
        self.process_id = resolve_process_index(process_id)
        self._suffix = f".h{self.process_id}" if role == "per_host" else ""
        self._executor = None
        self._pending = None
        #: checkpoint → (registry name, version) it was registered as
        self.registered: Dict[str, Tuple[str, int]] = {}
        #: wall seconds of the most recent completed write (the preemption
        #: handler's estimate of whether a deflate still fits its grace)
        self.last_save_seconds: Optional[float] = None
        os.makedirs(directory, exist_ok=True)
        if self.is_writer:
            self._clean_stale_tmp()
        self._load_provenance()

    @property
    def is_writer(self) -> bool:
        if self.role == "reader":
            return False
        if self.role in ("writer", "per_host"):
            return True
        return self.process_id == 0

    def _clean_stale_tmp(self) -> None:
        """Remove this manager's own ``checkpoint_*.zip.tmp`` left by a
        crash mid-write (the atomic rename means a .tmp is never the newest
        valid state)."""
        for fn in os.listdir(self.directory):
            if not (fn.startswith("checkpoint_") and fn.endswith(".zip.tmp")):
                continue
            m = self._NAME_RE.match(fn[:-len(".tmp")])
            if m is None:
                continue
            host = m.group(2)
            own = (host is not None and int(host) == self.process_id
                   if self.role == "per_host" else host is None)
            if own:
                try:
                    os.remove(os.path.join(self.directory, fn))
                    logger.info("removed stale checkpoint temp file %s", fn)
                except OSError:
                    pass

    def _path(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"checkpoint_{step:010d}{self._suffix}.zip")

    # -- checkpoint -> registry provenance ---------------------------------

    _PROVENANCE_FILE = "registry_provenance.json"

    def _provenance_path(self) -> str:
        return os.path.join(self.directory, self._PROVENANCE_FILE)

    def _load_provenance(self) -> None:
        import json

        prov = self._provenance_path()
        if not os.path.exists(prov):
            return
        try:
            with open(prov) as f:
                raw = json.load(f)
            self.registered = {k: (str(v[0]), int(v[1])) for k, v in raw.items()}
        except Exception as exc:   # advisory metadata: never fatal
            logger.warning("unreadable %s (%s) — starting with empty "
                           "registry provenance", self._PROVENANCE_FILE, exc)
            self.registered = {}

    def note_registered(self, path: str, name: str, version: int) -> None:
        """Record that checkpoint ``path`` was registered as ``(name,
        version)``, in an atomic sidecar (``registry_provenance.json``)."""
        import json

        self.registered[os.path.basename(str(path))] = (str(name), int(version))
        prov = self._provenance_path()
        tmp = f"{prov}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({k: list(v) for k, v in self.registered.items()}, f,
                      indent=2, sort_keys=True)
        os.replace(tmp, prov)

    def registered_version(self, path: str) -> Optional[Tuple[str, int]]:
        return self.registered.get(os.path.basename(str(path)))

    # -- writes --------------------------------------------------------------

    def _write(self, snap: _HostSnapshot, step: int,
               compression: Optional[int] = None, prune: bool = True) -> str:
        path = self._path(step)
        tmp = path + ".tmp"       # a crash mid-write never leaves a torn latest
        t0 = time.monotonic()
        snap.save(tmp, compression=compression)
        seconds = time.monotonic() - t0
        os.replace(tmp, path)
        if compression is None:
            self.last_save_seconds = seconds
        if prune:
            self._prune()
        return path

    def save(self, net, step: int) -> Optional[str]:
        """Snapshot ``net`` (a network or a trainer) and write it; ``None``
        on a non-writer, which still joins a collective snapshot."""
        if not self.is_writer and not _is_collective(net):
            logger.debug("checkpoint save @%d skipped on non-writer host %d",
                         step, self.process_id)
            return None
        snap = _HostSnapshot(net)
        if not self.is_writer:
            return None
        return self._write(snap, step)

    def save_snapshot(self, snap: _HostSnapshot, step: int,
                      compressed: bool = True,
                      prune: bool = True) -> Optional[str]:
        """Write an already taken snapshot (the emergency checkpoint):
        ``compressed=False`` writes ZIP_STORED, ``prune=False`` skips the
        keep-last sweep."""
        import zipfile

        if not self.is_writer:
            logger.debug("emergency checkpoint @%d skipped on non-writer "
                         "host %d", step, self.process_id)
            return None
        return self._write(snap, step, None if compressed else zipfile.ZIP_STORED,
                           prune=prune)

    def save_async(self, net, step: int):
        """Snapshot now, write in the background → a Future of the path
        (None on a non-writer).  At most one write is in flight."""
        from concurrent.futures import ThreadPoolExecutor

        if not self.is_writer and not _is_collective(net):
            return None
        if self._pending is not None:
            # cleared before result(): a failed write raises once
            pending, self._pending = self._pending, None
            pending.result()
        snap = _HostSnapshot(net)
        if not self.is_writer:
            return None
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt-writer")
        self._pending = self._executor.submit(self._write, snap, step)
        return self._pending

    def wait(self) -> None:
        """Block until an in-flight async write has landed (its failure
        propagates here, once)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _prune(self) -> None:
        if not self.is_writer:
            return
        for path, _ in self.list_checkpoints()[:-self.keep_last]:
            try:
                os.remove(path)
            except OSError:
                pass

    def list_checkpoints(self) -> List:
        out = []
        for fn in sorted(os.listdir(self.directory)):
            if not (fn.startswith("checkpoint_") and fn.endswith(".zip")):
                continue
            m = self._NAME_RE.match(fn)
            if m is None:
                logger.warning("skipping unparsable checkpoint filename %s", fn)
                continue
            step, host = int(m.group(1)), m.group(2)
            if self.role == "per_host":
                if host is None or int(host) != self.process_id:
                    continue
            elif host is not None:
                continue
            out.append((os.path.join(self.directory, fn), step))
        return out

    def latest(self) -> Optional[Any]:
        ckpts = self.list_checkpoints()
        return ckpts[-1] if ckpts else None

    def _quarantine(self, path: str) -> None:
        """Rename a checkpoint that failed to load to ``<path>.corrupt``."""
        try:
            os.replace(path, path + ".corrupt")
            logger.warning("quarantined corrupt checkpoint as %s.corrupt",
                           os.path.basename(path))
        except OSError:
            pass

    def restore_latest(self, loader: Callable[[str], Any]):
        """→ (model, step) from the newest INTACT checkpoint, or (None, -1).
        Waits for an in-flight write first (a failed one is skipped); a
        checkpoint that fails to load is quarantined and the next older one
        tried."""
        try:
            self.wait()
        except Exception as exc:
            logger.warning("in-flight async checkpoint write failed (%s) — "
                           "restoring from the newest on-disk checkpoint", exc)
        candidates = list(reversed(self.list_checkpoints()))
        for path, step in candidates:
            try:
                return loader(path), step
            except Exception as exc:
                logger.error("checkpoint %s failed to load (%s: %s) — falling "
                             "back to the next older checkpoint",
                             os.path.basename(path), type(exc).__name__, exc)
                self._quarantine(path)
        if candidates:
            logger.error("all %d checkpoints failed to load — restarting from "
                         "current in-memory params", len(candidates))
        return None, -1


class StepHangError(RecoverableInfraError):
    """The step watchdog fired: a step took longer than ``step_timeout``."""

    def __init__(self, elapsed: float, timeout: float):
        super().__init__(
            f"DEADLINE_EXCEEDED: step watchdog — dispatch took "
            f"{elapsed:.1f}s (> step_timeout={timeout:.1f}s); treating the "
            "step as hung and recovering from checkpoint")
        self.elapsed = elapsed
        self.timeout = timeout


class FailureDetector:
    """Decides whether an exception is a recoverable infrastructure failure
    (device loss, a dead or timed-out peer) or an error that must
    propagate."""

    #: the reference's markers, and gloo's and NCCL's texts for a peer
    #: that left and a collective that timed out
    RECOVERABLE_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "DATA_LOSS",
                           "ABORTED", "device halted", "device lost",
                           "connection reset", "socket closed",
                           "non-finite gradient",
                           "Connection closed by peer", "Broken pipe",
                           "Timed out waiting", "collective operation timeout",
                           "communicator was aborted")
    #: a CUDA error is sticky: the context is unusable in this process, so
    #: recovery belongs to the launcher (a relaunch)
    STICKY_MARKERS = ("CUDA error", "AcceleratorError", "CUBLAS_STATUS",
                      "CUDNN_STATUS")

    def is_recoverable(self, exc: Exception) -> bool:
        if getattr(exc, "recoverable", None) is False:
            return False   # a preemption notice: the host is going away
        text = f"{type(exc).__name__}: {exc}"
        if any(m in text for m in self.STICKY_MARKERS):
            return False
        if isinstance(exc, RecoverableInfraError):
            return True
        if isinstance(exc, (ValueError, TypeError, KeyError)):
            return False   # programming errors propagate
        return any(m.lower() in text.lower() for m in self.RECOVERABLE_MARKERS)

    def on_failure(self, exc: Exception, attempt: int) -> None:
        logger.warning("step failure (attempt %d): %s", attempt, exc)


class ElasticTrainer:
    """Checkpoint-resume training loop with failure recovery.

    >>> et = ElasticTrainer(trainer, ckpt_dir, checkpoint_every=100)
    >>> et.fit(batches, epochs=3)

    On a recoverable failure: back off, rebuild (``rebuild_fn``), restore
    the newest checkpoint, continue.  ``max_restarts`` bounds consecutive
    failures.  ``backoff_base > 0`` sleeps ``min(backoff_max, backoff_base
    * 2**(restarts-1))`` scaled by a seeded jitter factor.
    ``step_timeout`` arms the wall-clock watchdog (a step slower than it
    is a recoverable ``StepHangError``).  ``sleep_fn`` / ``clock`` are
    injectable for fake-clock tests.  ``loader`` reads a checkpoint (default:
    ``load_model`` onto the network's device).  On ranks that step
    together a preemption notice waits at most ``sync_every`` steps for
    its emergency checkpoint.
    """

    def __init__(self, trainer, checkpoint_dir: str,
                 checkpoint_every: int = 100,
                 keep_last: int = 3,
                 max_restarts: int = 3,
                 failure_detector: Optional[FailureDetector] = None,
                 rebuild_fn: Optional[Callable[[], Any]] = None,
                 loader: Optional[Callable[[str], Any]] = None,
                 sync_every: int = 10,
                 restart_reset_after: Optional[int] = None,
                 async_checkpoints: bool = False,
                 backoff_base: float = 0.0,
                 backoff_max: float = 30.0,
                 backoff_jitter: float = 0.5,
                 jitter_seed: Optional[int] = None,
                 step_timeout: Optional[float] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 membership_check: Optional[Callable[[], None]] = None,
                 checkpoint_role: str = "auto",
                 preemption=None,
                 run_id: Optional[str] = None):
        import random
        import uuid

        self.trainer = trainer
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.ckpt = CheckpointManager(checkpoint_dir, keep_last, role=checkpoint_role)
        self.checkpoint_every = max(1, checkpoint_every)
        self.max_restarts = max_restarts
        self.detector = failure_detector or FailureDetector()
        self.rebuild_fn = rebuild_fn
        self.loader = loader or self._default_loader
        self.sync_every = max(1, sync_every)
        self.async_checkpoints = async_checkpoints
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self._jitter_rng = random.Random(jitter_seed)
        self.step_timeout = step_timeout
        self.sleep_fn = sleep_fn
        self.clock = clock
        self.membership_check = membership_check
        self.preemption = preemption
        #: newest checkpoint step known durable on disk (-1: none) and its path
        self.last_checkpoint_step = -1
        self.last_checkpoint_path: Optional[str] = None
        self.restarts = 0           # consecutive failures (resets)
        self.total_restarts = 0     # lifetime count
        self.recovery_seconds = 0.0
        self.backoff_sleeps: List[float] = []
        #: (global step, loss) of every completed step, replays included
        self.step_losses: List[Tuple[int, Any]] = []
        #: steps the last restore went back to (one entry per restore)
        self.restored_steps: List[int] = []
        # armed after one step completes since the last (re)start: the
        # first step builds kernels and graphs, a restore re-places
        self._watchdog_armed = False
        self.global_step = 0
        self._saved_step = -1       # the step this run last checkpointed
        self.restart_reset_after = (restart_reset_after
                                    if restart_reset_after is not None
                                    else checkpoint_every)
        self._ok_steps = 0
        reg = get_registry()
        self._m_restarts = reg.counter("elastic_restarts_total")
        self._m_recovery_s = reg.counter("elastic_recovery_seconds_total")
        self._m_backoff = reg.counter("elastic_backoff_sleeps_total")
        reg.register_collector("elastic", self.recovery_stats, unique=True)

    def recovery_stats(self) -> dict:
        """Structured recovery counters (the registry collector view)."""
        return {"run_id": self.run_id,
                "global_step": self.global_step,
                "restarts": self.restarts,
                "total_restarts": self.total_restarts,
                "recovery_seconds": round(self.recovery_seconds, 3),
                "backoff_sleeps": len(self.backoff_sleeps),
                "last_checkpoint_step": self.last_checkpoint_step}

    def _record_durable(self, step: int, path) -> None:
        if path is not None and step > self.last_checkpoint_step:
            self.last_checkpoint_step = step
            self.last_checkpoint_path = str(path)

    @property
    def final_checkpoint_path(self) -> Optional[str]:
        return self.last_checkpoint_path

    def _default_loader(self, path: str):
        from ..utils.serializer import load_model

        return load_model(path, device=getattr(self.net, "device", None))

    @property
    def net(self):
        return getattr(self.trainer, "net", self.trainer)

    @property
    def _snapshot_source(self):
        return _state_source(self.trainer)

    @property
    def _lockstep(self):
        """The process group when this trainer's ranks step together (a
        collective trainer on several ranks), else None."""
        return _group() if _is_collective(self.trainer) else None

    def _flag_device(self, dist):
        """Where a collective's small tensor lives: NCCL's on the card."""
        if dist.get_backend() == "nccl":
            return getattr(self.net, "device", None) or "cpu"
        return "cpu"

    def _restore_agreed(self):
        """→ (model, step) of the newest intact checkpoint, the same step
        on every rank that steps together: the lowest writing rank (rank 0
        when none writes) waits for its write in flight, picks the step
        (quarantining what fails to load) and broadcasts it; every other
        rank loads exactly that step."""
        dist = self._lockstep
        if dist is None:
            return self.ckpt.restore_latest(self.loader)
        dev = self._flag_device(dist)
        world, rank = dist.get_world_size(), dist.get_rank()
        who = torch.tensor([rank if self.ckpt.is_writer else world], dtype=torch.int64,
                           device=dev)
        dist.all_reduce(who, op=dist.ReduceOp.MIN)
        decider = int(who[0]) % world
        if rank == decider:
            model, step = self.ckpt.restore_latest(self.loader)
        else:
            self.ckpt.wait()        # a per-host writer's own write in flight
            model, step = None, -1
        agreed = torch.tensor([step], dtype=torch.int64, device=dev)
        dist.broadcast(agreed, src=decider)
        step = int(agreed[0])
        if rank != decider and step >= 0:
            model = self.loader(self.ckpt._path(step))
        return model, step

    def _restore(self, fresh_ok: bool = False) -> None:
        with obs_trace.span("ckpt/restore", cat="ckpt"):
            model, step = self._restore_agreed()
        if model is None:
            if not fresh_ok:
                logger.warning("no checkpoint to restore — restarting from current params")
            return
        net = self.net
        net.params = model.params
        net.state = model.state
        net.opt_state = model.opt_state
        # None when the checkpoint has no residual: _place_residual zeros it
        net.grad_residual = getattr(model, "grad_residual", None)
        net.iteration = model.iteration
        if hasattr(net, "epoch"):
            net.epoch = getattr(model, "epoch", net.epoch)
        self.global_step = step
        self._saved_step = step
        self.restored_steps.append(step)
        if step >= self.last_checkpoint_step:
            self.last_checkpoint_step = step
            self.last_checkpoint_path = self.ckpt._path(step)
        logger.info("restored checkpoint @ step %d", step)

    def _place(self) -> None:
        """A sharded trainer re-slices the restored whole parameters for its
        mesh and re-adopts the residual."""
        if hasattr(self.trainer, "_place_model"):
            self.trainer._place_model()

    def resume(self) -> int:
        """Restore the newest intact checkpoint before training starts →
        the restored global step (0 for an empty store)."""
        # ranks that step together agree even on an empty-looking store:
        # a peer's write may be in flight
        if self._lockstep is None and self.ckpt.latest() is None:
            return 0
        with obs_trace.span("elastic/resume", cat="elastic") as sp:
            self._restore(fresh_ok=True)
            if self.global_step > 0:
                self._place()
            sp.set(step=self.global_step)
        self._watchdog_armed = False
        return self.global_step

    def _materialize(self, loss) -> None:
        """Read the loss (a device sync), under the watchdog when armed: a
        read that never returns is abandoned on its daemon thread and the
        step surfaces as a ``StepHangError``."""
        if self.step_timeout is None or not self._watchdog_armed:
            loss.value()
            return
        import threading

        box: dict = {}

        def read():
            try:
                box["v"] = loss.value()
            except Exception as exc:
                box["e"] = exc

        t = threading.Thread(target=read, daemon=True, name="step-watchdog")
        t.start()
        t.join(self.step_timeout)
        if t.is_alive():
            raise StepHangError(self.step_timeout, self.step_timeout)
        if "e" in box:
            raise box["e"]

    def _backoff_delay(self) -> float:
        if self.backoff_base <= 0:
            return 0.0
        base = min(self.backoff_max, self.backoff_base * (2.0 ** (self.restarts - 1)))
        return base * (1.0 + self.backoff_jitter * self._jitter_rng.random())

    def _check_preemption(self) -> None:
        """The step boundary's preemption check.  Ranks that step together
        act on a notice only every ``sync_every`` steps, where a notice
        any rank took becomes every rank's (one MAX all-reduce of a flag),
        so they all take the collective emergency snapshot at the same
        boundary."""
        dist = self._lockstep
        if dist is not None:
            if self.global_step % self.sync_every:
                return
            flag = torch.tensor([1 if self.preemption.requested else 0], dtype=torch.int32,
                                device=self._flag_device(dist))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if not int(flag[0]):
                return
            if not self.preemption.requested:
                self.preemption.notice(None)
        self.preemption.check(self)

    def _checkpoint(self) -> None:
        with obs_trace.span("ckpt/save", cat="ckpt", step=self.global_step,
                            is_async=self.async_checkpoints):
            self._saved_step = self.global_step
            src = self._snapshot_source
            if self.async_checkpoints:
                fut = self.ckpt.save_async(src, self.global_step)
                if fut is not None:
                    s = self.global_step
                    fut.add_done_callback(
                        lambda f, s=s: self._record_durable(
                            s, None if f.exception() else f.result()))
            else:
                self._record_durable(self.global_step, self.ckpt.save(src, self.global_step))

    def fit_batch(self, ds) -> Any:
        """One step with checkpoint and recovery: a failed step is retried
        on ``ds`` after the restore (``fit`` replays from the restored
        step instead)."""
        return self._run_step(lambda: ds)

    def _run_step(self, batch_at: Callable[[], Any]) -> Any:
        while True:
            t_start = self.clock()
            try:
                if self.preemption is not None:
                    # the step boundary: a notice writes the emergency
                    # checkpoint and raises PreemptedError, which is not
                    # recoverable and so leaves this loop
                    self._check_preemption()
                if self.membership_check is not None:
                    self.membership_check()
                loss = self.trainer.fit_batch(batch_at())
                self.global_step += 1
                saving = self.global_step % self.checkpoint_every == 0
                if (saving or self.global_step % self.sync_every == 0) \
                        and hasattr(loss, "value"):
                    # surfaces an async failure before a checkpoint write
                    self._materialize(loss)
                if self.step_timeout is not None:
                    elapsed = self.clock() - t_start
                    if self._watchdog_armed and elapsed > self.step_timeout:
                        raise StepHangError(elapsed, self.step_timeout)
                    self._watchdog_armed = True
                if saving:
                    self._checkpoint()
                self.step_losses.append((self.global_step, loss))
                self._ok_steps += 1
                if self._ok_steps >= self.restart_reset_after and self.restarts:
                    logger.info("%d successful steps since last failure — "
                                "resetting restart counter", self._ok_steps)
                    self.restarts = 0
                return loss
            except Exception as exc:
                if not self.detector.is_recoverable(exc):
                    raise
                self._recover(exc)

    def _recover(self, exc: Exception) -> None:
        t_fail = self.clock()
        self._ok_steps = 0
        self.restarts += 1
        self.total_restarts += 1
        obs_trace.instant("fault", cat="elastic", kind=type(exc).__name__,
                          step=self.global_step, restart=self.restarts)
        self._m_restarts.inc()
        self.detector.on_failure(exc, self.restarts)
        if self.restarts > self.max_restarts:
            raise RuntimeError(f"exceeded max_restarts={self.max_restarts}") from exc
        with obs_trace.span("elastic/recovery", cat="elastic",
                            kind=type(exc).__name__, step=self.global_step):
            delay = self._backoff_delay()
            if delay > 0:
                logger.info("backing off %.2fs before restart %d "
                            "(exponential + jitter)", delay, self.restarts)
                self.backoff_sleeps.append(delay)
                self._m_backoff.inc()
                self.sleep_fn(delay)
            if self.rebuild_fn is not None:
                self.trainer = self.rebuild_fn()
            self._restore()
            self._place()
        self._watchdog_armed = False
        spent = self.clock() - t_fail
        self.recovery_seconds += spent
        self._m_recovery_s.inc(max(0.0, spent))

    def fit(self, data, epochs: int = 1, skip_done: bool = False) -> List[Any]:
        """Train ``epochs`` passes over ``data`` → the loss of each step
        position, in order.  The batches stream from the iterator, epoch by
        epoch; after a restore to step s training goes on at position s
        (relative to the global step at the call, or to step 0 with
        ``skip_done``: a resumed run then skips the batches its checkpoint
        already holds).  Only the batches a restore can go back to are
        held: those since the oldest of the last ``keep_last`` checkpoints
        this call took, at most ``keep_last * checkpoint_every`` and the
        one in flight.  A last checkpoint is written at the end unless the
        last step took one."""
        net = self.net
        it = net._as_iterator(data) if hasattr(net, "_as_iterator") else data
        stream = (ds for _ in range(epochs) for ds in it)
        base = 0 if skip_done else self.global_step
        start = self.global_step - base
        held: Dict[int, Any] = {}
        pulled = 0
        taken = collections.deque(maxlen=max(1, self.ckpt.keep_last))
        end = object()

        def available(pos: int) -> bool:
            nonlocal pulled
            while pulled <= pos:
                ds = next(stream, end)
                if ds is end:
                    return False
                if pulled >= start:
                    held[pulled] = ds
                pulled += 1
            return True

        def batch_at(pos: int):
            if pos not in held and not (available(pos) and pos in held):
                raise RuntimeError(
                    f"restored step {base + pos} is older than the batches this fit "
                    f"still holds (from step {base + min(held, default=start)})")
            return held[pos]

        losses: Dict[int, Any] = {}
        while available(self.global_step - base):
            loss = self._run_step(lambda: batch_at(self.global_step - base))
            losses[self.global_step - base - 1] = loss
            if self._saved_step == self.global_step:     # this step checkpointed
                while taken and taken[-1] >= self.global_step:
                    taken.pop()                          # a restore went back
                taken.append(self.global_step)
                if len(taken) == taken.maxlen:
                    for pos in [p for p in held if p < taken[0] - base]:
                        del held[pos]
        self.ckpt.wait()
        if self._saved_step != self.global_step:
            self._saved_step = self.global_step
            self._record_durable(self.global_step,
                                 self.ckpt.save(self._snapshot_source, self.global_step))
        return [losses[i] for i in sorted(losses)]
