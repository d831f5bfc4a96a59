"""Multi-process initialization over ``torch.distributed`` (mirrors
``deeplearning4j_tpu/parallel/distributed.py``).

Every process runs the same program, calls ``initialize()`` and is one
rank; ``build_mesh`` / ``build_two_tier_mesh`` then name axes over the
ranks.  Each rank feeds its own rows of the global batch
(``local_batch_slice``), the reference's per-host data-locality model.

The backend: NCCL when every rank on a host has a card of its own;
gloo when ranks share a card or run on the CPU (NCCL refuses two ranks
on one device).

The rendezvous is a key-value store: rank 0 hosts a ``TCPStore`` at the
coordinator address (``tcp://`` / ``coordinator_address``), or the ranks
share a ``FileStore`` (``file://``).  ``initialize`` bounds the joiners'
connect: a dead coordinator raises ``CoordinatorUnreachableError``
within ``timeout_s``.  ``reinitialize`` leaves the group and joins again
under a new key prefix of the same store (the membership epoch), so a
rejoin never reads the rendezvous keys of an earlier group.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import Optional, Tuple

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: the environment contract between the ``launch`` subcommand and its
#: workers (the reference's names): the launcher sets these, and
#: ``resolve_process_index`` / ``CheckpointManager`` / ``Heartbeat`` read
#: them without a process group
ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"
ENV_NUM_PROCESSES = "DL4J_TPU_NUM_PROCESSES"
ENV_RUN_DIR = "DL4J_TPU_RUN_DIR"
ENV_COORDINATOR = "DL4J_TPU_COORDINATOR"
ENV_CHAOS = "DL4J_TPU_CHAOS"
ENV_INCARNATION = "DL4J_TPU_INCARNATION"
ENV_CONNECT_TIMEOUT = "DL4J_TPU_CONNECT_TIMEOUT"
#: directory each worker writes its Chrome trace into (``launch --trace``:
#: worker{i}.inc{j}.trace.json, merged into one pod timeline)
ENV_TRACE_DIR = "DL4J_TPU_TRACE_DIR"
#: preemption grace budget in seconds (parallel/preemption.py)
ENV_GRACE_S = "DL4J_TPU_GRACE_S"
#: comma-separated coordinator-capable port per process id, for the
#: failover election (launcher.elect_coordinator)
ENV_COORD_PORTS = "DL4J_TPU_COORD_PORTS"
#: HTTP port a ``serve`` worker binds under ``launch --serve``
ENV_SERVE_PORT = "DL4J_TPU_SERVE_PORT"
#: the membership epoch the launcher saw when it spawned this worker: a
#: worker joins the process group at the first later epoch whose members
#: are every process (the epoch names the group's store prefix)
ENV_MEMBERSHIP_EPOCH = "DL4J_TPU_MEMBERSHIP_EPOCH"

#: exit code of a PLANNED leave: the worker took a preemption notice,
#: wrote its emergency checkpoint and exited on purpose; the launcher
#: relaunches it without spending the restart budget (75 = EX_TEMPFAIL)
PREEMPTED_EXIT_CODE = 75


class CoordinatorUnreachableError(ConnectionError):
    """``initialize()`` could not reach the coordinator within its bounded
    connect budget (wrong address, dead coordinator, no path), raised
    instead of a hang so a launcher can back off, retry or re-elect."""


def validate_coordinator_address(address: str) -> Tuple[str, int]:
    """'host:port' → (host, port); every malformed shape is a ValueError
    up front."""
    if not isinstance(address, str) or ":" not in address:
        raise ValueError(f"coordinator_address must be 'host:port', got "
                         f"{address!r}")
    host, _, port_s = address.rpartition(":")
    host = host.strip("[]")  # [v6::addr]:port
    if not host:
        raise ValueError(f"coordinator_address {address!r} has no host")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"coordinator_address {address!r} has a non-integer "
                         f"port {port_s!r}")
    if not (0 < port < 65536):
        raise ValueError(f"coordinator_address {address!r} port out of range "
                         f"(1-65535)")
    return host, port


def default_backend(local_ranks: int) -> str:
    """"nccl" when each of ``local_ranks`` ranks on this host has a card
    of its own, else "gloo"."""
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _probe_coordinator(host: str, port: int, timeout_s: float) -> None:
    """Bounded TCP connect-with-retry to the coordinator before the
    store's own connect loop: a dead coordinator fails in ``timeout_s``
    with a clear error."""
    deadline = time.monotonic() + timeout_s
    delay = 0.1
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(
                    (host, port),
                    timeout=max(0.1, min(2.0, deadline - time.monotonic()))):
                return
        except OSError as exc:
            last_err = exc
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(1.0, delay * 2)
    raise CoordinatorUnreachableError(
        f"coordinator {host}:{port} unreachable after {timeout_s:.1f}s "
        f"of connect retries (last error: {last_err})")


#: rank 0's TCPStore server, kept across ``reinitialize`` (its joiners
#: reconnect to the same address): ((host, port), store)
_MASTER_STORE: Optional[tuple] = None
#: how many times this process has called ``reinitialize``
_REJOINS = 0


def _store(init_method: str, n: int, r: int, timeout: datetime.timedelta,
           prefix: Optional[str], master: Optional[bool] = None):
    """The rendezvous store of a ``tcp://`` or ``file://`` URL under
    ``prefix`` (None: the URL goes to ``init_process_group`` as it is)."""
    import torch.distributed as dist
    from urllib.parse import urlparse

    global _MASTER_STORE
    u = urlparse(init_method)
    master = (r == 0) if master is None else master
    if u.scheme == "tcp":
        addr = (u.hostname, u.port)
        if master and _MASTER_STORE is not None and _MASTER_STORE[0] == addr:
            store = _MASTER_STORE[1]
        else:
            store = dist.TCPStore(u.hostname, u.port, n, is_master=master,
                                  timeout=timeout, wait_for_workers=False)
            if master:
                _MASTER_STORE = (addr, store)
    elif u.scheme == "file" and prefix is not None:
        store = dist.FileStore(u.path, n)
    else:
        return None
    return dist.PrefixStore(prefix, store) if prefix is not None else store


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               init_method: Optional[str] = None,
               backend: Optional[str] = None,
               collective_timeout_s: Optional[float] = None,
               store_prefix: Optional[str] = None,
               store_master: Optional[bool] = None) -> None:
    """Join (or form) the process group.

    ``coordinator_address='host:port'`` (rank 0 hosts the store there) or
    an ``init_method`` URL (``file:///path`` or ``tcp://host:port``) names
    the rendezvous; with neither, ``MASTER_ADDR``/``MASTER_PORT`` are
    read.  ``num_processes`` and ``process_id`` default to ``WORLD_SIZE``
    and ``RANK``.  ``backend`` defaults to ``default_backend`` over
    ``LOCAL_WORLD_SIZE`` (else the world size); with NCCL the rank takes
    card ``LOCAL_RANK`` (else its rank) as its current device.

    ``timeout_s`` (default 60) bounds the rendezvous: a joiner first
    probes the coordinator and raises ``CoordinatorUnreachableError``
    when it cannot reach it in time.  ``collective_timeout_s`` (default
    ``timeout_s``) bounds every collective of the group: a collective
    whose peer is gone raises instead of blocking the caller forever.
    ``store_prefix`` puts the group's keys under a prefix of the store
    (``reinitialize`` passes one per rejoin); ``store_master`` says
    whether this process hosts the ``tcp://`` store (default: rank 0; a
    coordinator elected after a failover hosts it at its own port)."""
    import torch.distributed as dist

    n = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    r = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if not (0 <= r < n):
        raise ValueError(f"process_id {r} out of range [0, {n})")
    timeout_s = 60.0 if timeout_s is None else float(timeout_s)
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    coll_s = timeout_s if collective_timeout_s is None else float(collective_timeout_s)
    if coordinator_address is not None:
        if init_method is not None:
            raise ValueError("pass coordinator_address or init_method, not both")
        host, port = validate_coordinator_address(coordinator_address)
        init_method = f"tcp://{host}:{port}"
    if init_method is None:
        init_method = "env://"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    backend = backend or default_backend(local)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", r)) % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        master = (r == 0) if store_master is None else store_master
        if init_method.startswith("tcp://") and not master:
            from urllib.parse import urlparse
            u = urlparse(init_method)
            _probe_coordinator(u.hostname, u.port, timeout_s)
        store = _store(init_method, n, r, timeout, store_prefix, master)
        kw = {"store": store} if store is not None else {"init_method": init_method}
        dist.init_process_group(backend, world_size=n, rank=r,
                                timeout=datetime.timedelta(seconds=coll_s), **kw)
    except CoordinatorUnreachableError:
        raise
    except Exception as exc:
        text = f"{type(exc).__name__}: {exc}"
        if any(m in text for m in ("Connection", "connect", "timed out", "Timed out",
                                   "timeout", "DistNetworkError", "DistStoreError")):
            raise CoordinatorUnreachableError(
                f"rendezvous at {init_method} failed within {timeout_s:.1f}s: "
                f"{text}") from exc
        raise
    logger.info("distributed initialized: rank %d/%d, backend %s", r, n, backend)


def reinitialize(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 init_method: Optional[str] = None,
                 backend: Optional[str] = None,
                 collective_timeout_s: Optional[float] = None,
                 epoch: Optional[int] = None,
                 store_master: Optional[bool] = None) -> None:
    """Leave the process group (best effort: a group whose peer died is
    torn down all the same) and join again, under the store prefix
    ``epoch<epoch>/`` (default: this process's rejoin count), so the new
    group never reads the keys of the one before.  Every rank of the new
    group must pass the same ``epoch`` (the membership ledger's)."""
    global _REJOINS
    try:
        shutdown()
    except Exception as exc:          # already collapsed with its peer
        logger.debug("process group teardown before rejoin: %s", exc)
    _REJOINS += 1
    prefix = f"epoch{_REJOINS if epoch is None else int(epoch)}/"
    initialize(coordinator_address, num_processes, process_id, timeout_s=timeout_s,
               init_method=init_method, backend=backend,
               collective_timeout_s=collective_timeout_s, store_prefix=prefix,
               store_master=store_master)


def shutdown() -> None:
    """Leave the process group (a no-op when none was initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def resolve_process_index(explicit: Optional[int] = None) -> int:
    """This process's index without needing a process group: an explicit
    value, else the launcher's ``DL4J_TPU_PROCESS_ID``, else the rank of
    an initialized group, else 0."""
    if explicit is not None:
        return int(explicit)
    env = os.environ.get(ENV_PROCESS_ID)
    if env is not None:
        try:
            return int(env)
        except ValueError:
            raise ValueError(f"{ENV_PROCESS_ID}={env!r} is not an integer")
    return process_index()


_MP_SUPPORT: Optional[Tuple[bool, str]] = None

_PROBE = """
import sys, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="file://" + sys.argv[2], world_size=2,
                        rank=int(sys.argv[1]))
t = torch.ones(1)
dist.all_reduce(t)
assert float(t[0]) == 2.0, t
dist.destroy_process_group()
"""


def probe_multiprocess_support(timeout_s: float = 60.0) -> Tuple[bool, str]:
    """(supported, reason): can two processes of this installation form a
    gloo group and all-reduce?  Spawns the pair once (cached) with a
    time limit."""
    global _MP_SUPPORT
    if _MP_SUPPORT is not None:
        return _MP_SUPPORT
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rdv = os.path.join(d, "rdv")
        procs = [subprocess.Popen([sys.executable, "-c", _PROBE, str(i), rdv],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for i in range(2)]
        ok, reason = True, ""
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout_s)
                if p.returncode != 0:
                    ok, reason = False, (f"probe worker rc={p.returncode}: "
                                         f"{err.decode(errors='replace')[-400:]}")
                    break
        except subprocess.TimeoutExpired:
            ok, reason = False, "multiprocess probe timed out"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    _MP_SUPPORT = (ok, reason)
    logger.info("multiprocess backend probe: supported=%s %s", ok, reason)
    return _MP_SUPPORT


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a globally indexed batch (ranks feed disjoint
    shards of the global batch)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def detect_num_slices() -> int:
    """Number of slices the job spans: ``MEGASCALE_NUM_SLICES`` (the
    multislice runtime's env contract, which the reference reads too),
    else 1.  Use it to size the ``dcn`` axis."""
    env = os.environ.get("MEGASCALE_NUM_SLICES")
    return max(1, int(env)) if env else 1


def is_coordinator() -> bool:
    """True on rank 0 — the rank that writes checkpoints."""
    return process_index() == 0
