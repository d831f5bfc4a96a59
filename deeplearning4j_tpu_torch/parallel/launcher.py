"""Pod-scale elastic runtime: a multi-process launcher and host join/leave
(mirrors ``deeplearning4j_tpu/parallel/launcher.py``; the ledger files
are the reference's, so either package's ``Membership`` reads them).

- :class:`PodLauncher` forks N worker processes (the CLI ``launch``
  subcommand's engine), sets each one's device visibility
  (``CUDA_VISIBLE_DEVICES``) and the ``DL4J_TPU_*`` environment contract,
  watches liveness, and RELAUNCHES workers that die or hang, within a
  restart budget; no worker outlives the run.
- :class:`Membership`: a shared heartbeat ledger with a membership
  **epoch** the launcher bumps whenever the alive set changes.
  File-based, with an injectable clock.
- :class:`Heartbeat`: the worker's daemon thread that beats.
- :class:`ProcessFailureDetector`: ``check()`` raises
  :class:`HostLostError` / :class:`MembershipChangedError` when the
  membership moved, so ``ElasticTrainer(membership_check=)`` recovers a
  peer's death through the same backoff → rebuild → restore path.

Bootstrap modes: ``distributed`` (workers form one process group:
``maybe_bootstrap_from_env`` waits until the ledger lists every process
at an epoch newer than the one the launcher spawned it at, and joins the
group under that epoch's store prefix; a survivor of a peer's death
rejoins the same way through ``distributed.reinitialize``) and
``replica`` (no process group: each worker trains its own replica).
With one card every worker sees ``cuda:0`` and the ranks use gloo, as
``distributed.default_backend`` chooses.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry, merge_snapshots
from .distributed import (
    ENV_CHAOS, ENV_CONNECT_TIMEOUT, ENV_COORD_PORTS, ENV_COORDINATOR,
    ENV_GRACE_S, ENV_INCARNATION, ENV_MEMBERSHIP_EPOCH, ENV_NUM_PROCESSES,
    ENV_PROCESS_ID, ENV_RUN_DIR, ENV_SERVE_PORT, ENV_TRACE_DIR,
    PREEMPTED_EXIT_CODE, CoordinatorUnreachableError, initialize,
    resolve_process_index,
)
from .elastic import FailureDetector, RecoverableInfraError

logger = logging.getLogger("deeplearning4j_tpu_torch")


class HostLostError(RecoverableInfraError):
    """A previously-alive member's heartbeat expired (process died, host
    preempted, network partition).  Message carries UNAVAILABLE so
    marker-based detectors classify it too; ``lost`` lists the members."""

    def __init__(self, lost: Sequence[int], epoch: int):
        super().__init__(
            f"UNAVAILABLE: host(s) {sorted(lost)} left the membership "
            f"(heartbeat expired) at epoch {epoch} — rebuilding over the "
            "survivors")
        self.lost = sorted(lost)
        self.epoch = epoch


class MembershipChangedError(RecoverableInfraError):
    """The membership epoch moved under a live trainer (typically a host
    JOINING back) — the mesh should be re-provisioned over the new
    member set before the next step."""

    def __init__(self, joined: Sequence[int], epoch: int):
        super().__init__(
            f"ABORTED: membership changed at epoch {epoch} — host(s) "
            f"{sorted(joined)} joined; re-provisioning the mesh")
        self.joined = sorted(joined)
        self.epoch = epoch


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


class Membership:
    """Shared heartbeat ledger + coordinator-side membership epoch.

    Workers call ``beat(process_id)``; the coordinator (launcher) calls
    ``refresh()``, which recomputes the alive-set from heartbeat ages and
    bumps the persisted epoch whenever it changes.  Heartbeat files and
    the epoch ledger are single files under ``directory`` written with
    atomic renames, so readers never see torn JSON.  ``clock`` is
    injectable (fake-clock transition tests); cross-process use needs a
    wall clock — the default ``time.time`` — because monotonic clocks
    don't compare across processes."""

    LEDGER = "membership.json"

    def __init__(self, directory: str, heartbeat_timeout: float = 5.0,
                 clock: Callable[[], float] = time.time):
        if heartbeat_timeout <= 0:
            raise ValueError(f"heartbeat_timeout must be > 0, got "
                             f"{heartbeat_timeout}")
        self.directory = directory
        self.heartbeat_timeout = heartbeat_timeout
        self.clock = clock
        os.makedirs(directory, exist_ok=True)

    # -- worker side -------------------------------------------------------

    def _hb_path(self, process_id: int) -> str:
        return os.path.join(self.directory, f"hb_{int(process_id)}.json")

    def _leaving_path(self, process_id: int) -> str:
        return os.path.join(self.directory,
                            f"leaving_{int(process_id)}.json")

    def beat(self, process_id: int, pid: Optional[int] = None,
             step: Optional[int] = None,
             step_s: Optional[float] = None,
             ckpt_step: Optional[int] = None,
             addr: Optional[str] = None) -> None:
        """Liveness beat.  Beyond (pid, step, t): ``step_s`` is this
        worker's current per-step wall time (straggler detection keys on
        it), ``ckpt_step`` the newest checkpoint step known durable on
        disk (pod-liveness reporting), ``addr`` a coordinator-capable
        host address (coordinator election)."""
        _atomic_write_json(self._hb_path(process_id), {
            "process_id": int(process_id),
            "pid": int(pid if pid is not None else os.getpid()),
            "step": step, "step_s": step_s, "ckpt_step": ckpt_step,
            "addr": addr, "t": self.clock()})

    def last_beat(self, process_id: int) -> Optional[dict]:
        try:
            with open(self._hb_path(process_id)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def remove(self, process_id: int) -> None:
        try:
            os.remove(self._hb_path(process_id))
        except OSError:
            pass

    # -- announced leaves (preemption notices) -----------------------------

    def mark_leaving(self, process_id: int,
                     grace_s: Optional[float] = None) -> None:
        """Record that this worker received a preemption notice and will
        exit within ``grace_s`` — survivors and the launcher observe a
        fast LEAVE instead of waiting out the heartbeat timeout
        (parallel/preemption.py)."""
        _atomic_write_json(self._leaving_path(process_id), {
            "process_id": int(process_id), "grace_s": grace_s,
            "t": self.clock()})

    def clear_leaving(self, process_id: int) -> None:
        try:
            os.remove(self._leaving_path(process_id))
        except OSError:
            pass

    def leaving(self) -> Dict[int, dict]:
        """{process_id: marker} of workers that announced a leave (and
        have not been respawned since — the launcher clears the marker
        at spawn).  Torn/foreign files are skipped, same contract as
        ``_scan``."""
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for fn in names:
            if not (fn.startswith("leaving_") and fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, fn)) as f:
                    rec = json.load(f)
                if not isinstance(rec, dict):
                    continue
                out[int(rec["process_id"])] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    # -- coordinator side --------------------------------------------------

    def _scan(self) -> Dict[int, dict]:
        """Read every heartbeat file, hardened against torn state: a
        worker killed mid-``beat()`` (or a foreign/garbage file matching
        the glob) must read as a MISSED beat, never raise into the
        coordinator's monitor loop — so empty files, truncated JSON,
        non-dict payloads (``null``) and malformed ids are all skipped."""
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for fn in names:
            if not (fn.startswith("hb_") and fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, fn)) as f:
                    rec = json.load(f)
                if not isinstance(rec, dict):
                    continue   # json "null"/list — torn or foreign
                out[int(rec["process_id"])] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue   # torn/foreign file — not a member
        return out

    @staticmethod
    def _num(value, default: float = 0.0) -> float:
        try:
            return float(value)
        except (TypeError, ValueError):
            return default

    def alive(self) -> List[int]:
        """Members with a fresh heartbeat, EXCLUDING those that announced
        a leave — a preemption notice is an immediate logical departure
        (the fast-LEAVE contract), even while the worker spends its grace
        budget writing the emergency checkpoint."""
        now = self.clock()
        leaving = self.leaving()
        return sorted(i for i, rec in self._scan().items()
                      if i not in leaving
                      and now - self._num(rec.get("t")) <=
                      self.heartbeat_timeout)

    def last_checkpoint_step(self) -> int:
        """Newest checkpoint step any member reported durable in its
        heartbeat (-1 when nobody reported one) — the launcher's
        "how much work would a loss cost right now" number."""
        steps = [int(self._num(rec.get("ckpt_step"), -1))
                 for rec in self._scan().values()
                 if rec.get("ckpt_step") is not None]
        return max(steps, default=-1)

    def read(self) -> dict:
        """The persisted ledger: {"epoch": int, "members": [ids]} (epoch 0,
        no members before the first refresh).  A truncated/garbage ledger
        file degrades to the empty default — the next ``refresh()``
        re-persists from the heartbeat scan — instead of raising."""
        default = {"epoch": 0, "members": []}
        try:
            with open(os.path.join(self.directory, self.LEDGER)) as f:
                led = json.load(f)
        except (OSError, ValueError):
            return default
        if (not isinstance(led, dict)
                or not isinstance(led.get("members"), list)):
            return default
        try:
            led["epoch"] = int(led["epoch"])
        except (KeyError, TypeError, ValueError):
            return default
        return led

    @property
    def epoch(self) -> int:
        return int(self.read()["epoch"])

    def members(self) -> List[int]:
        return list(self.read()["members"])

    def refresh(self) -> int:
        """Recompute the alive-set; if it differs from the ledger, bump
        the epoch and persist — ONE bump per transition batch, so two
        hosts expiring in the same scan cost one epoch, not two.  Only
        the coordinator calls this (single ledger writer)."""
        led = self.read()
        alive = self.alive()
        if alive != list(led["members"]):
            led = {"epoch": int(led["epoch"]) + 1, "members": alive,
                   "t": self.clock()}
            _atomic_write_json(os.path.join(self.directory, self.LEDGER), led)
            obs_trace.instant("membership/epoch", cat="launcher",
                              epoch=led["epoch"], members=list(alive))
            logger.info("membership epoch %d: members %s", led["epoch"],
                        alive)
        return int(led["epoch"])


class Heartbeat:
    """Worker-side liveness beacon: a daemon thread that beats the shared
    Membership every ``interval`` seconds (plus once immediately), with an
    optional ``step_fn`` so the ledger records training progress.  A
    SIGSTOPped / wedged worker stops beating — which is exactly the
    signal the launcher's hang detection keys on."""

    def __init__(self, membership: Membership, process_id: int,
                 interval: float = 0.2,
                 step_fn: Optional[Callable[[], int]] = None,
                 ckpt_step_fn: Optional[Callable[[], int]] = None,
                 export_metrics: bool = True, metrics_every: int = 5):
        self.membership = membership
        self.process_id = int(process_id)
        self.interval = interval
        self.step_fn = step_fn
        # pod-liveness extras: the newest DURABLE checkpoint step (e.g.
        # ``lambda: elastic_trainer.last_checkpoint_step``) rides the
        # beat, and per-step wall time is DERIVED from step_fn deltas —
        # the launcher's straggler detection needs no trainer wiring
        self.ckpt_step_fn = ckpt_step_fn
        self._last_step: Optional[int] = None
        self._last_step_t: Optional[float] = None
        self._step_s: Optional[float] = None
        self._step_samples = 0
        # pod-level telemetry: every Nth beat also snapshots the global
        # MetricsRegistry into run_dir/obs/ — the launcher's
        # ``pod_metrics()`` aggregates these per-worker files into one
        # pod view
        self.export_metrics = export_metrics
        self.metrics_every = max(1, int(metrics_every))
        self._beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def metrics_path(self) -> str:
        return os.path.join(self.membership.directory, "obs",
                            f"metrics_w{self.process_id}.json")

    def export_metrics_now(self) -> None:
        try:
            snap = get_registry().snapshot()
            snap["process_id"] = self.process_id
            snap["t"] = self.membership.clock()
            os.makedirs(os.path.dirname(self.metrics_path()), exist_ok=True)
            _atomic_write_json(self.metrics_path(), snap)
        except (OSError, TypeError, ValueError) as exc:
            logger.debug("metrics export failed: %s", exc)

    def set_step_fn(self, step_fn: Callable[[], int]) -> None:
        self.step_fn = step_fn

    def set_ckpt_step_fn(self, ckpt_step_fn: Callable[[], int]) -> None:
        self.ckpt_step_fn = ckpt_step_fn

    def _observe_step(self, step: Optional[int]) -> Optional[float]:
        """Derive per-step wall time from step_fn deltas.  The FIRST
        delta is discarded — it includes jit compilation (the same
        compile-grace reasoning as the elastic step watchdog), and a
        compile-polluted sample would make every cold-starting worker
        look like a straggler."""
        if step is None:
            return self._step_s
        now = self.membership.clock()
        if self._last_step is not None and step > self._last_step:
            sample = (now - self._last_step_t) / (step - self._last_step)
            self._step_samples += 1
            if self._step_samples >= 2:
                self._step_s = sample
        if self._last_step is None or step != self._last_step:
            self._last_step, self._last_step_t = step, now
        return self._step_s

    def _beat_once(self) -> None:
        step = ckpt_step = None
        if self.step_fn is not None:
            try:
                step = int(self.step_fn())
            except Exception:
                step = None
        if self.ckpt_step_fn is not None:
            try:
                ckpt_step = int(self.ckpt_step_fn())
            except Exception:
                ckpt_step = None
        try:
            self.membership.beat(self.process_id, step=step,
                                 step_s=self._observe_step(step),
                                 ckpt_step=ckpt_step)
        except OSError as exc:   # run dir vanished mid-shutdown — not fatal
            logger.debug("heartbeat write failed: %s", exc)
        self._beats += 1
        if self.export_metrics and self._beats % self.metrics_every == 1:
            self.export_metrics_now()

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._beat_once()

        def loop():
            while not self._stop.wait(self.interval):
                self._beat_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"heartbeat-{self.process_id}")
        self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self.export_metrics:
            self.export_metrics_now()   # final counters beat the interval
        if deregister:
            self.membership.remove(self.process_id)

    @classmethod
    def start_from_env(cls, step_fn: Optional[Callable[[], int]] = None,
                       interval: float = 0.2,
                       ckpt_step_fn: Optional[Callable[[], int]] = None,
                       ) -> Optional["Heartbeat"]:
        """Start beating iff launched under the pod launcher (the
        ``DL4J_TPU_RUN_DIR`` env is the contract); None otherwise."""
        run_dir = os.environ.get(ENV_RUN_DIR)
        if not run_dir:
            return None
        return cls(Membership(run_dir), resolve_process_index(),
                   interval=interval, step_fn=step_fn,
                   ckpt_step_fn=ckpt_step_fn).start()


class ProcessFailureDetector(FailureDetector):
    """Heartbeat-based process-liveness detection on top of the marker
    classifier: ``check()`` compares the current alive-set against the
    last one it saw and raises :class:`HostLostError` (leave) or
    :class:`MembershipChangedError` (join) — both recoverable by
    construction.  Wire it into ``ElasticTrainer(membership_check=
    detector.check, failure_detector=detector, rebuild_fn=...)`` and a
    peer's death flows through the standard backoff/restore recovery with
    a mesh rebuilt over the survivors (``mesh.surviving_mesh``)."""

    def __init__(self, membership: Membership,
                 recover_on_join: bool = True):
        self.membership = membership
        self.recover_on_join = recover_on_join
        self._known: Optional[frozenset] = None

    def check(self) -> None:
        alive = frozenset(self.membership.alive())
        if self._known is None:       # first observation is the baseline
            self._known = alive
            return
        lost, joined = self._known - alive, alive - self._known
        self._known = alive
        epoch = self.membership.epoch
        if lost:
            raise HostLostError(lost, epoch)
        if joined and self.recover_on_join:
            raise MembershipChangedError(joined, epoch)


def elect_coordinator(membership: Membership, ports) -> tuple:
    """→ (leader_id, 'host:port'): the survivor with the LOWEST alive id
    from the heartbeat ledger, at its coordinator-capable port.  ``ports``
    maps process id → port (dict or sequence — the launcher exports it as
    the comma-separated ``DL4J_TPU_COORD_PORTS`` env).  The host comes
    from the leader's own heartbeat ``addr`` field when it advertised one
    (multi-box pods), else 127.0.0.1 (the single-box launcher).  Raises
    CoordinatorUnreachableError when nobody is alive to elect — there is
    no cluster left to rejoin."""
    alive = membership.alive()
    if not alive:
        raise CoordinatorUnreachableError(
            "coordinator election found no alive member in the ledger at "
            f"{membership.directory} — nothing to fail over to")
    leader = min(alive)
    try:
        port = int(ports[leader])
    except (KeyError, IndexError, TypeError, ValueError):
        raise CoordinatorUnreachableError(
            f"no coordinator port known for elected leader {leader} "
            f"(ports: {ports!r})")
    beat = membership.last_beat(leader) or {}
    host = beat.get("addr") or "127.0.0.1"
    return leader, f"{host}:{port}"


#: the membership epoch this process last joined a process group at
_JOINED_EPOCH: Optional[int] = None


def wait_for_members(membership: Membership, n: int, after: int,
                     timeout_s: float, poll_s: float = 0.05) -> int:
    """Wait until the ledger's epoch is newer than ``after`` and lists all
    ``n`` processes → that epoch (the launcher bumps it when the last
    member beats).  Raises CoordinatorUnreachableError past ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    want = list(range(n))
    while True:
        led = membership.read()
        if int(led["epoch"]) > after and list(led["members"]) == want:
            return int(led["epoch"])
        if time.monotonic() > deadline:
            raise CoordinatorUnreachableError(
                f"membership at {membership.directory} did not list all {n} "
                f"processes after epoch {after} within {timeout_s:.1f}s "
                f"(ledger: {led})")
        time.sleep(poll_s)


def join_epoch(n: int, timeout_s: float, after: Optional[int] = None) -> Optional[int]:
    """The epoch to join the process group at under the launcher (None
    without a run dir): the first epoch after ``after`` (default: the one
    the launcher spawned this worker at, ``DL4J_TPU_MEMBERSHIP_EPOCH``)
    that lists every process."""
    run_dir = os.environ.get(ENV_RUN_DIR)
    if not run_dir:
        return None
    if after is None:
        after = int(os.environ.get(ENV_MEMBERSHIP_EPOCH, "-1"))
    return wait_for_members(Membership(run_dir), n, after, timeout_s)


def maybe_bootstrap_from_env(timeout_s: Optional[float] = None,
                             _initialize=None,
                             collective_timeout_s: Optional[float] = None) -> bool:
    """Join the process group iff the launcher exported a coordinator
    address (``DL4J_TPU_COORDINATOR``); replica-mode workers return False.
    Under a run dir the worker first waits for the membership epoch that
    lists every process (``join_epoch``) and joins under its store prefix.
    The bounded ``initialize`` raises CoordinatorUnreachableError instead
    of hanging.

    Coordinator failover: when the coordinator is unreachable and the
    launcher exported per-process ports (``DL4J_TPU_COORD_PORTS``) and a
    run dir, the worker elects the survivor with the lowest alive id
    (``elect_coordinator``), which hosts the store at its own port, and
    joins there.  ``_initialize`` is injectable for tests."""
    global _JOINED_EPOCH
    init = _initialize or initialize
    addr = os.environ.get(ENV_COORDINATOR)
    if not addr:
        return False
    n = int(os.environ[ENV_NUM_PROCESSES])
    i = resolve_process_index()
    if timeout_s is None:
        timeout_s = float(os.environ.get(ENV_CONNECT_TIMEOUT, "60"))
    kw = {}
    if collective_timeout_s is not None:
        kw["collective_timeout_s"] = collective_timeout_s
    epoch = join_epoch(n, timeout_s)
    if epoch is not None:
        kw["store_prefix"] = f"epoch{epoch}/"
    try:
        init(addr, n, i, timeout_s=timeout_s, **kw)
    except CoordinatorUnreachableError:
        run_dir = os.environ.get(ENV_RUN_DIR)
        ports_env = os.environ.get(ENV_COORD_PORTS)
        if not run_dir or not ports_env:
            raise   # no failover contract
        ports = [int(p) for p in ports_env.split(",") if p.strip()]
        leader, new_addr = elect_coordinator(Membership(run_dir), ports)
        if new_addr == addr:
            raise   # the election picked the address that just failed
        obs_trace.instant("launcher/coordinator_failover", cat="launcher",
                          leader=leader, addr=new_addr, process=i)
        logger.warning("coordinator %s unreachable — failing over to "
                       "elected survivor %d at %s", addr, leader, new_addr)
        init(new_addr, n, i, timeout_s=timeout_s, store_master=(leader == i), **kw)
    _JOINED_EPOCH = epoch
    return True


def rejoin_from_env(timeout_s: Optional[float] = None,
                    collective_timeout_s: Optional[float] = None) -> int:
    """A survivor's rejoin after a peer left (an ``ElasticTrainer``
    ``rebuild_fn`` step): wait for the first epoch after the one this
    process last joined at that lists every process again (the relaunched
    peer has beaten), then ``reinitialize`` under it → the epoch."""
    from .distributed import reinitialize

    global _JOINED_EPOCH
    n = int(os.environ[ENV_NUM_PROCESSES])
    if timeout_s is None:
        timeout_s = float(os.environ.get(ENV_CONNECT_TIMEOUT, "60"))
    epoch = join_epoch(n, timeout_s, after=_JOINED_EPOCH if _JOINED_EPOCH is not None else -1)
    reinitialize(os.environ[ENV_COORDINATOR], n, resolve_process_index(),
                 timeout_s=timeout_s, collective_timeout_s=collective_timeout_s,
                 epoch=epoch)
    _JOINED_EPOCH = epoch
    return epoch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _visible_devices(process_id: int, per_worker: int, total: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` of worker ``process_id``: its ``per_worker``
    consecutive cards, wrapping around ``total`` (with one card every
    worker sees card 0)."""
    return ",".join(str((process_id * per_worker + j) % total)
                    for j in range(per_worker))


def _card_count(env: Dict[str, str]) -> int:
    """Cards the workers may use: the launcher's own
    ``CUDA_VISIBLE_DEVICES`` list, else the cards CUDA reports."""
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    import torch

    return torch.cuda.device_count()


class _WorkerHandle:
    def __init__(self, process_id: int):
        self.process_id = process_id
        self.proc: Optional[subprocess.Popen] = None
        self.state = "pending"       # running | completed | unrecovered
        self.incarnation = 0
        self.restarts = 0            # budget-consuming relaunches only
        self.planned_leaves = 0      # PREEMPTED exits (budget untouched)
        self.hang_killed = False
        self.notice_t: Optional[float] = None   # wall clock of the notice
        self.grace_escalated = False
        self.straggler_streak = 0
        self.straggler_flagged = False
        self.straggler_killed = False
        self._last_hb_seen: Optional[float] = None
        self.spawned_pids: List[int] = []
        self.log_path: Optional[str] = None
        self._log_f = None


class PodLauncher:
    """Fork, monitor, and heal a fleet of worker processes (one per
    "host") — the engine behind the CLI ``launch`` subcommand and the
    multi-process chaos soak.

    Every worker runs ``worker_argv`` with the ``DL4J_TPU_*`` env
    contract (process id/count, run dir for heartbeats, optional
    coordinator address, optional chaos spec).  The monitor loop:

    - reaps exited workers — rc 0 is completion; anything else is a host
      LEAVE, and the worker is relaunched (host JOIN) while its restart
      budget lasts, with the chaos spec stripped (a scheduled
      ``proc_kill`` fires once per run, not once per incarnation);
    - declares a worker HUNG when its heartbeat goes stale while the
      process is still alive (SIGSTOP, wedged runtime), SIGKILLs it, and
      relaunches through the same leave/join path;
    - bumps the membership epoch on every transition via
      ``Membership.refresh()``;
    - on exit, kills anything still running and verifies no orphan
      worker process survives (the leak check the soak gates on).
    """

    def __init__(self, worker_argv: Sequence[str], num_workers: int,
                 run_dir: str,
                 devices_per_worker: Optional[int] = None,
                 base_env: Optional[Dict[str, str]] = None,
                 chaos: Optional[Dict[int, str]] = None,
                 bootstrap: str = "replica",
                 coordinator_port: Optional[int] = None,
                 heartbeat_timeout: float = 5.0,
                 max_restarts: int = 2,
                 poll_interval: float = 0.1,
                 deadline_s: float = 600.0,
                 connect_timeout_s: float = 60.0,
                 megascale_slices: Optional[int] = None,
                 trace_dir: Optional[str] = None,
                 grace_s: float = 30.0,
                 max_planned_leaves: int = 8,
                 straggler_factor: float = 2.0,
                 straggler_beats: int = 3,
                 straggler_policy: str = "flag",
                 serve: bool = False,
                 clock: Callable[[], float] = time.time):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if bootstrap not in ("replica", "distributed"):
            raise ValueError(f"bootstrap must be replica/distributed, got "
                             f"{bootstrap!r}")
        self.worker_argv = list(worker_argv)
        self.num_workers = num_workers
        self.run_dir = run_dir
        self.devices_per_worker = devices_per_worker
        self.base_env = dict(base_env if base_env is not None else os.environ)
        self.chaos = dict(chaos or {})
        bad = set(self.chaos) - set(range(num_workers))
        if bad:
            raise ValueError(f"chaos targets {sorted(bad)} out of range "
                             f"[0, {num_workers})")
        self.bootstrap = bootstrap
        self.coordinator_port = coordinator_port
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.deadline_s = deadline_s
        self.connect_timeout_s = connect_timeout_s
        self.megascale_slices = megascale_slices
        # when set, workers write per-incarnation Chrome traces here (the
        # DL4J_TPU_TRACE_DIR contract) and merge_trace() stitches them —
        # plus the launcher's own membership/leave/join instants — into
        # one pod timeline
        self.trace_dir = trace_dir
        # announced failures: grace_s is the emergency-checkpoint budget exported
        # to workers AND the launcher-side escalation deadline — a
        # notified worker still alive past ~1.5x the budget is SIGKILLed
        # (it is wedged, and the scheduler is about to do the same).
        # max_planned_leaves bounds PREEMPTED-exit relaunches separately
        # from the restart budget (a worker that always exits 75 must not
        # relaunch forever).
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.grace_s = grace_s
        self.max_planned_leaves = max_planned_leaves
        # straggler policy: a worker whose per-step wall time (from its
        # heartbeat) exceeds straggler_factor x the median of its PEERS'
        # step times for straggler_beats consecutive fresh beats is
        # flagged ("flag", the default: counter + trace instant + event)
        # or killed-and-relaunched ("relaunch", consuming restart budget);
        # "off" disables the scan
        if straggler_policy not in ("off", "flag", "relaunch"):
            raise ValueError(f"straggler_policy must be off/flag/relaunch, "
                             f"got {straggler_policy!r}")
        self.straggler_factor = straggler_factor
        self.straggler_beats = max(1, int(straggler_beats))
        self.straggler_policy = straggler_policy
        # serving worker role (``launch --serve``): every worker gets a
        # preassigned HTTP port exported as DL4J_TPU_SERVE_PORT — a
        # serve-role worker binds its UIServer there, and a fleet router
        # (serving/fleet.py) reaches the whole pod via serve_endpoints();
        # ports are STABLE across relaunches so a recovered host rejoins
        # the fleet at the same address
        self.serve_ports: Optional[List[int]] = (
            [free_port() for _ in range(num_workers)] if serve else None)
        # one injectable wall clock shared with the membership ledger:
        # launcher event times, notice deadlines and heartbeat staleness
        # all read the SAME clock, and fake-clock tests can drive it
        self.clock = clock
        self.membership = Membership(run_dir, heartbeat_timeout,
                                     clock=clock)
        self.handles = [_WorkerHandle(i) for i in range(num_workers)]
        self.events: List[dict] = []
        self._t0: Optional[float] = None
        self._shutting_down = False
        self._shutdown_forwarded = False
        self._prev_sigterm = None
        self.coord_ports: Optional[List[int]] = None
        reg = get_registry()
        self._m_preempt_notices = reg.counter("launcher_preempt_notices_total")
        self._m_planned_leaves = reg.counter("launcher_planned_leaves_total")
        self._m_stragglers = reg.counter("launcher_stragglers_total")
        self._m_grace_escalations = reg.counter(
            "launcher_grace_escalations_total")
        reg.register_collector("launcher", self.stats, unique=True)

    def stats(self) -> dict:
        """Membership/fleet counters (the registry collector view — this
        is what ``/metrics`` shows under ``registry.collected.launcher``):
        the pod-liveness answer an operator needs at a glance — epoch,
        who is alive, who announced a leave, and the newest checkpoint
        step known durable (how much work a loss would cost)."""
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {"workers": self.num_workers,
                "epoch": self.membership.epoch,
                "members": self.membership.members(),
                "alive": self.membership.alive(),
                "leaving": sorted(self.membership.leaving()),
                "last_checkpoint_step":
                    self.membership.last_checkpoint_step(),
                "restarts": sum(h.restarts for h in self.handles),
                "planned_leaves": sum(h.planned_leaves
                                      for h in self.handles),
                "stragglers_flagged": sum(1 for h in self.handles
                                          if h.straggler_flagged),
                "events": by_kind}

    def serve_endpoints(self) -> List[str]:
        """``host:port`` per worker when launched with ``serve=True``
        (``launch --serve``) — feed these to ``serve --fleet`` or
        ``FleetRouter`` over ``HttpHost``s."""
        if self.serve_ports is None:
            raise RuntimeError("launcher was not started with serve=True")
        return [f"127.0.0.1:{p}" for p in self.serve_ports]

    # -- env / spawn -------------------------------------------------------

    def _event(self, kind: str, worker: Optional[int] = None, **extra):
        e = {"t": round(self.clock() - (self._t0 or self.clock()), 3),
             "kind": kind}
        if worker is not None:
            e["worker"] = worker
        e.update(extra)
        self.events.append(e)
        obs_trace.instant(f"launcher/{kind}", cat="launcher",
                          **{k: v for k, v in e.items()
                             if k not in ("t", "kind", "log_tail")})
        logger.info("launcher: %s", e)

    def _env_for(self, h: _WorkerHandle) -> Dict[str, str]:
        env = dict(self.base_env)
        env[ENV_PROCESS_ID] = str(h.process_id)
        env[ENV_NUM_PROCESSES] = str(self.num_workers)
        env[ENV_RUN_DIR] = self.run_dir
        env[ENV_INCARNATION] = str(h.incarnation)
        env[ENV_CONNECT_TIMEOUT] = str(self.connect_timeout_s)
        if self.devices_per_worker:
            total = _card_count(self.base_env)
            if total:
                base = self.base_env.get("CUDA_VISIBLE_DEVICES")
                ids = (base.split(",") if base is not None
                       else [str(d) for d in range(total)])
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    ids[int(j)].strip() for j in _visible_devices(
                        h.process_id, self.devices_per_worker, total).split(","))
        env[ENV_MEMBERSHIP_EPOCH] = str(self.membership.epoch)
        env[ENV_GRACE_S] = str(self.grace_s)
        if self.bootstrap == "distributed":
            if self.coordinator_port is None:
                self.coordinator_port = free_port()
            env[ENV_COORDINATOR] = f"127.0.0.1:{self.coordinator_port}"
            # restartable coordinator: every worker gets a preassigned
            # coordinator-capable port, so a worker that finds the
            # configured coordinator dead can elect the survivor with the
            # lowest alive id and re-initialize there (elect_coordinator
            # + maybe_bootstrap_from_env failover)
            if self.coord_ports is None:
                self.coord_ports = [self.coordinator_port] + [
                    free_port() for _ in range(self.num_workers - 1)]
            env[ENV_COORD_PORTS] = ",".join(str(p)
                                            for p in self.coord_ports)
            # feed slice detection (distributed.detect_num_slices →
            # build_two_tier_mesh / ShardedTrainer.two_tier): each worker
            # process is one "slice" unless the deployment already set
            # the multislice runtime's env or the caller overrode it
            if self.megascale_slices:
                env["MEGASCALE_NUM_SLICES"] = str(self.megascale_slices)
            else:
                env.setdefault("MEGASCALE_NUM_SLICES",
                               str(self.num_workers))
        else:
            env.pop(ENV_COORDINATOR, None)
            if self.megascale_slices:
                env["MEGASCALE_NUM_SLICES"] = str(self.megascale_slices)
        if self.trace_dir:
            env[ENV_TRACE_DIR] = self.trace_dir
        if self.serve_ports is not None:
            env[ENV_SERVE_PORT] = str(self.serve_ports[h.process_id])
        spec = self.chaos.get(h.process_id)
        if spec and h.incarnation == 0:
            env[ENV_CHAOS] = spec     # consumed once per RUN: a relaunched
        else:                         # worker must not re-kill itself at
            env.pop(ENV_CHAOS, None)  # the same scheduled step forever
        return env

    def _spawn(self, h: _WorkerHandle) -> None:
        self.membership.remove(h.process_id)   # a stale beat from the dead
        # incarnation must not trip hang detection before the new process
        # gets through its imports to the first beat
        self.membership.clear_leaving(h.process_id)   # the new incarnation
        # is joining, not leaving — a stale marker would exclude it from
        # alive() forever
        h.notice_t = None
        h.grace_escalated = False
        h.straggler_streak = 0
        h.straggler_flagged = False
        h.straggler_killed = False
        h._last_hb_seen = None
        logs = os.path.join(self.run_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        h.log_path = os.path.join(
            logs, f"worker{h.process_id}.inc{h.incarnation}.log")
        h._log_f = open(h.log_path, "wb")
        h.proc = subprocess.Popen(self.worker_argv, env=self._env_for(h),
                                  stdout=h._log_f,
                                  stderr=subprocess.STDOUT)
        h.state = "running"
        h.hang_killed = False
        h.spawned_pids.append(h.proc.pid)
        self._event("spawn", h.process_id, pid=h.proc.pid,
                    incarnation=h.incarnation)

    def _close_log(self, h: _WorkerHandle) -> None:
        if h._log_f is not None:
            try:
                h._log_f.close()
            except OSError:
                pass
            h._log_f = None

    def _log_tail(self, h: _WorkerHandle, n: int = 1500) -> str:
        try:
            with open(h.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                return f.read().decode(errors="replace")
        except (OSError, TypeError):
            return ""

    # -- monitor -----------------------------------------------------------

    def _poll_once(self) -> None:
        now = self.clock()
        leaving = self.membership.leaving()
        for h in self.handles:
            if h.state != "running":
                continue
            rc = h.proc.poll()
            if rc is not None:
                self._close_log(h)
                if rc == 0 and not h.hang_killed:
                    h.state = "completed"
                    self.membership.remove(h.process_id)
                    self._event("complete", h.process_id,
                                incarnation=h.incarnation)
                    continue
                if (rc == PREEMPTED_EXIT_CODE and not h.hang_killed
                        and not h.grace_escalated):
                    # PLANNED leave: the worker processed its notice,
                    # wrote the emergency checkpoint, and exited on
                    # purpose — relaunch WITHOUT consuming the restart
                    # budget (preemption is the platform's fault, not the
                    # worker's)
                    h.planned_leaves += 1
                    self._m_planned_leaves.inc()
                    self._event("leave", h.process_id, cause="preempted",
                                rc=rc, incarnation=h.incarnation,
                                planned=True)
                    if self._shutting_down:
                        h.state = "completed"
                        self.membership.remove(h.process_id)
                    elif h.planned_leaves <= self.max_planned_leaves:
                        h.incarnation += 1
                        self._spawn(h)
                        self._event("join", h.process_id,
                                    incarnation=h.incarnation)
                    else:
                        h.state = "unrecovered"
                        self._event("unrecovered", h.process_id,
                                    cause="preempt_loop", rc=rc,
                                    log_tail=self._log_tail(h))
                    continue
                if self._shutting_down:
                    # pod shutdown in progress: exits are expected; a
                    # worker without a preemption handler dies on the
                    # forwarded SIGTERM itself (rc -15) — that is still a
                    # clean shutdown, not a crash to relaunch
                    h.state = "completed"
                    self.membership.remove(h.process_id)
                    self._event("leave", h.process_id, cause="shutdown",
                                rc=rc, incarnation=h.incarnation)
                    continue
                if h.grace_escalated:
                    kind = "grace_expired"
                elif h.straggler_killed:
                    kind = "straggler"
                elif h.hang_killed:
                    kind = "hang"
                else:
                    kind = "crash"
                self._event("leave", h.process_id, cause=kind, rc=rc,
                            incarnation=h.incarnation)
                if h.restarts < self.max_restarts:
                    h.restarts += 1
                    h.incarnation += 1
                    self._spawn(h)
                    self._event("join", h.process_id,
                                incarnation=h.incarnation)
                else:
                    h.state = "unrecovered"
                    self._event("unrecovered", h.process_id, cause=kind,
                                rc=rc, log_tail=self._log_tail(h))
                continue
            # alive — observe a self-announced leave (the worker's
            # preemption handler wrote the ledger marker, e.g. the
            # scheduler SIGTERMed it directly): start the escalation
            # clock from the marker's own timestamp
            if h.notice_t is None and h.process_id in leaving:
                h.notice_t = Membership._num(
                    leaving[h.process_id].get("t"), now)
                self._m_preempt_notices.inc()
                self._event("preempt_notice", h.process_id,
                            source="worker", incarnation=h.incarnation)
            # grace escalation: a notified worker still alive well past
            # the budget is wedged — SIGKILL it (the scheduler is about
            # to anyway) and recover through the normal leave path
            if (h.notice_t is not None and not h.grace_escalated
                    and now - h.notice_t >
                    self.grace_s + max(1.0, 0.5 * self.grace_s)):
                h.grace_escalated = True
                self._m_grace_escalations.inc()
                self._event("grace_expired", h.process_id,
                            overdue_s=round(now - h.notice_t, 2))
                try:
                    h.proc.kill()
                except OSError:
                    pass
                continue
            # hang detection: a beat from THIS incarnation (the hb
            # file is removed at spawn) that has gone stale means the
            # process is wedged or stopped; never-beaten workers get
            # startup grace (imports/compiles) and are bounded by the
            # overall deadline instead
            hb = self.membership.last_beat(h.process_id)
            if hb is not None and \
                    now - Membership._num(hb.get("t"), now) > \
                    self.heartbeat_timeout:
                h.hang_killed = True
                self._event("hang_detected", h.process_id,
                            stale_s=round(now - float(hb["t"]), 2))
                try:
                    h.proc.kill()    # SIGKILL terminates SIGSTOPped too
                except OSError:
                    pass
        self._check_stragglers()

    def _check_stragglers(self) -> None:
        """Flag (or relaunch) workers whose per-step wall time — derived
        by their Heartbeat and carried in the beat — exceeds
        ``straggler_factor`` x the median of their PEERS' step times for
        ``straggler_beats`` consecutive FRESH beats.  Peer median (not
        pod median including self) so a single slow worker among few
        can't drag the threshold up to meet itself; requires >= 2 running
        workers with steady-state samples.  One flag per incarnation."""
        if self.straggler_policy == "off" or self.num_workers < 2:
            return
        beats: Dict[int, dict] = {}
        for h in self.handles:
            if h.state != "running":
                continue
            hb = self.membership.last_beat(h.process_id)
            if hb is not None:
                beats[h.process_id] = hb
        for h in self.handles:
            hb = beats.get(h.process_id)
            if hb is None or h.state != "running":
                continue
            t = Membership._num(hb.get("t"))
            if h._last_hb_seen is not None and t <= h._last_hb_seen:
                continue          # same beat — don't recount the streak
            h._last_hb_seen = t
            step_s = hb.get("step_s")
            if not isinstance(step_s, (int, float)) or step_s <= 0:
                continue
            peers = [b.get("step_s") for i, b in beats.items()
                     if i != h.process_id
                     and isinstance(b.get("step_s"), (int, float))
                     and b.get("step_s") > 0]
            if not peers:
                continue
            peers.sort()
            median = peers[len(peers) // 2] if len(peers) % 2 else \
                0.5 * (peers[len(peers) // 2 - 1] + peers[len(peers) // 2])
            if median > 0 and step_s > self.straggler_factor * median:
                h.straggler_streak += 1
            else:
                h.straggler_streak = 0
                continue
            if (h.straggler_streak >= self.straggler_beats
                    and not h.straggler_flagged):
                h.straggler_flagged = True
                self._m_stragglers.inc()
                self._event("straggler", h.process_id,
                            step_s=round(float(step_s), 4),
                            peer_median_s=round(float(median), 4),
                            streak=h.straggler_streak,
                            policy=self.straggler_policy)
                if self.straggler_policy == "relaunch":
                    h.straggler_killed = True
                    try:
                        h.proc.kill()
                    except OSError:
                        pass

    def _running(self) -> bool:
        return any(h.state == "running" for h in self.handles)

    # -- announced preemption ----------------------------------------------

    def preempt_worker(self, process_id: int) -> bool:
        """Deliver a preemption notice (SIGTERM) to one running worker —
        the launcher-side half of the announced-failure path: the worker's
        PreemptionHandler writes its emergency checkpoint and exits
        PREEMPTED within the grace budget, or the monitor escalates to
        SIGKILL past it.  → True when the signal was sent."""
        h = self.handles[process_id]
        if h.state != "running" or h.proc is None:
            return False
        try:
            h.proc.send_signal(signal.SIGTERM)
        except OSError:
            return False
        if h.notice_t is None:
            h.notice_t = self.clock()
            self._m_preempt_notices.inc()
            self._event("preempt_notice", process_id, source="launcher",
                        incarnation=h.incarnation)
        return True

    def preempt_all(self) -> int:
        """Forward a preemption notice to every running worker (the
        launcher's own SIGTERM handler calls this: pod-level preemption
        notices cascade down as worker notices).  → count notified."""
        return sum(1 for h in self.handles
                   if self.preempt_worker(h.process_id))

    def _on_sigterm(self, signum, frame) -> None:
        # the launcher itself was told to go away: cascade the notice and
        # stop healing — workers get their grace window, nobody relaunches
        self._shutting_down = True

    def _install_sigterm(self) -> None:
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        except ValueError:   # not the main thread (tests drive run() from
            self._prev_sigterm = None        # a helper thread) — skip

    def _restore_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None

    def shutdown_gracefully(self) -> None:
        """Programmatic equivalent of SIGTERMing the launcher: notify
        every worker and let the monitor loop drain them within grace."""
        self._shutting_down = True

    def _reap_all(self) -> int:
        """Kill anything still alive and count it; then verify every pid
        this launcher EVER spawned is gone — the no-orphans contract."""
        leaked = 0
        for h in self.handles:
            if h.proc is not None and h.proc.poll() is None:
                leaked += 1
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            self._close_log(h)
        for h in self.handles:
            for pid in h.spawned_pids:
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    continue           # gone, as it should be
                except PermissionError:
                    pass               # exists under another uid — not ours
                else:
                    # still alive (a double-fork would land here) — last
                    # resort, then recheck
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
                    leaked += 1
        return leaked

    # -- pod-level telemetry -----------------------------------------------

    def pod_metrics(self) -> dict:
        """Aggregate the per-worker registry snapshots (written by each
        worker's Heartbeat into run_dir/obs/) plus this launcher's own
        registry into ONE pod-level view: counters summed, histogram
        buckets added, gauges min/mean/max across workers — the
        pod-scale ``/metrics`` answer."""
        workers: Dict[str, dict] = {}
        obs_dir = os.path.join(self.run_dir, "obs")
        try:
            names = sorted(os.listdir(obs_dir))
        except OSError:
            names = []
        for fn in names:
            if not (fn.startswith("metrics_w") and fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(obs_dir, fn)) as f:
                    workers[fn[len("metrics_"):-len(".json")]] = json.load(f)
            except (OSError, ValueError):
                continue   # torn write — the next beat replaces it
        return {"workers": workers,
                "launcher": get_registry().snapshot(),
                "aggregate": merge_snapshots(list(workers.values()))}

    def merge_trace(self, out_path: str) -> Optional[dict]:
        """Stitch every per-worker (and per-incarnation) trace file under
        ``trace_dir`` — plus the launcher's own events, flushed here —
        into one pod timeline at ``out_path``; None when tracing was not
        armed or no worker wrote a trace."""
        if not self.trace_dir:
            return None
        rec = obs_trace.get_recorder()
        if rec is not None:
            rec.save(os.path.join(self.trace_dir, "launcher.trace.json"))
        try:
            names = sorted(os.listdir(self.trace_dir))
        except OSError:
            return None
        paths = [os.path.join(self.trace_dir, fn) for fn in names
                 if fn.endswith(".trace.json")
                 and not fn.endswith("pod.trace.json")]
        if not paths:
            return None
        return obs_trace.merge_traces(paths, out_path)

    def run(self) -> dict:
        """Launch the fleet, heal it until every worker completes (or its
        budget/deadline runs out), and return the run report."""
        self._t0 = self.clock()
        os.makedirs(self.run_dir, exist_ok=True)
        self._install_sigterm()
        for h in self.handles:
            self._spawn(h)
        deadline_hit = False
        leaked = 0
        try:
            while self._running():
                time.sleep(self.poll_interval)
                if self._shutting_down and not self._shutdown_forwarded:
                    self._shutdown_forwarded = True
                    self._event("shutdown",
                                notified=self.preempt_all())
                self.membership.refresh()
                self._poll_once()
                if self.clock() - self._t0 > self.deadline_s:
                    deadline_hit = True
                    for h in self.handles:
                        if h.state == "running":
                            h.state = "unrecovered"
                            self._event("unrecovered", h.process_id,
                                        cause="deadline",
                                        log_tail=self._log_tail(h))
                    break
            self.membership.refresh()
        finally:
            leaked = self._reap_all()
            self._restore_sigterm()
        completed = [h.process_id for h in self.handles
                     if h.state == "completed"]
        unrecovered = [h.process_id for h in self.handles
                       if h.state == "unrecovered"]
        report = {
            "workers": self.num_workers,
            "completed": completed,
            "unrecovered": unrecovered,
            "restarts": sum(h.restarts for h in self.handles),
            "budget_used": {h.process_id: h.restarts
                            for h in self.handles},
            "planned_leaves": sum(h.planned_leaves for h in self.handles),
            "preempt_notices": sum(1 for e in self.events
                                   if e["kind"] == "preempt_notice"),
            "grace_escalations": sum(1 for e in self.events
                                     if e["kind"] == "grace_expired"),
            "stragglers": [e for e in self.events
                           if e["kind"] == "straggler"],
            "leaves": [e for e in self.events if e["kind"] == "leave"],
            "joins": sum(1 for e in self.events if e["kind"] == "join"),
            "hang_detected": sum(1 for e in self.events
                                 if e["kind"] == "hang_detected"),
            "epoch": self.membership.epoch,
            "alive": self.membership.alive(),
            "leaving": sorted(self.membership.leaving()),
            "last_checkpoint_step": self.membership.last_checkpoint_step(),
            "deadline_hit": deadline_hit,
            "leaked_killed": leaked,
            "wall_seconds": round(self.clock() - self._t0, 2),
            "events": self.events,
        }
        report["ok"] = (not unrecovered and not deadline_hit
                        and leaked == 0)
        report["pod_metrics"] = self.pod_metrics()
        return report
