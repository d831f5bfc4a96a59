"""Multi-process initialization over ``torch.distributed`` (mirrors
``deeplearning4j_tpu/parallel/distributed.py`` as far as data-parallel
training needs it).

Every process runs the same program, calls ``initialize()`` and is one
rank; ``build_mesh`` / ``build_two_tier_mesh`` then name axes over the
ranks.  Each rank feeds its own rows of the global batch
(``local_batch_slice``), the reference's per-host data-locality model.

The backend: NCCL when every rank on a host has a card of its own;
gloo when ranks share a card or run on the CPU (NCCL refuses two ranks
on one device).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


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


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               init_method: Optional[str] = None,
               backend: Optional[str] = None) -> None:
    """Join (or form) the process group.

    ``coordinator_address='host:port'`` (rank 0 listens there) or an
    ``init_method`` URL (``file:///path`` or ``tcp://host:port``) names the
    rendezvous; with neither, ``MASTER_ADDR``/``MASTER_PORT`` are read.
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  ``backend`` defaults to ``default_backend`` over
    ``LOCAL_WORLD_SIZE`` (else the world size); with NCCL the rank takes
    card ``LOCAL_RANK`` (else its rank) as its current device.
    ``timeout_s`` (default 60) bounds the rendezvous and every collective."""
    import torch.distributed as dist

    n = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    r = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if not (0 <= r < n):
        raise ValueError(f"process_id {r} out of range [0, {n})")
    timeout_s = 60.0 if timeout_s is None else float(timeout_s)
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
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
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed initialized: rank %d/%d, backend %s", r, n, backend)


def shutdown() -> None:
    """Leave the process group (a no-op when none was initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


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
