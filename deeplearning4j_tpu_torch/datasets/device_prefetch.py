"""Device-resident input pipeline — double-buffered async host-to-device
prefetch (the port of ``deeplearning4j_tpu/datasets/device_prefetch.py``).

AsyncDataSetIterator overlaps host ETL (decode, batching, normalization)
with device compute, but the batch it hands over is still HOST memory:
every training step then pays a host-to-device copy inside ``fit_batch``
(``torch.as_tensor(..., device=)``, from pageable memory, on the compute
stream).  :class:`DevicePrefetchIterator` closes that gap: a background
thread copies batches ahead of the consumer, keeping a depth-k ring of
batches that are already

  * **on the device** — on a card the producer thread stages each array
    in a pinned host buffer and copies it with ``non_blocking=True`` on a
    CUDA stream of its own, so the copy rides under the previous step's
    compute instead of serializing with it,
  * **this rank's rows** (``sharding=`` a ``ShardedTrainer``'s
    ``batch_sharding``: only the rank's rows are copied, and the trainer
    passes them through untouched),
  * **narrow on the wire** (``cast_dtype="bfloat16"`` casts floating
    feature arrays on the host side of the copy, halving wire bytes;
    uint8 pixels already cross at 1 byte/px and scale on the card), and
  * **already normalized** (``transform=`` a fitted normalizer runs its
    ``device_transform()``: the statistics move to the card once and the
    transform runs there on the producer's stream — host numpy drops out of
    the steady-state path).

On a card, three things keep the ring correct:

  * **ordering** — each batch carries an event recorded on the producer's
    stream after its copy and transform; ``next()`` makes the consumer's
    current stream wait on it (a device-side wait: the consumer never
    blocks on the host for a copy);
  * **memory reuse** — every tensor of a handed-over batch is
    ``record_stream``-ed on the consumer's stream, so the caching allocator
    does not give its memory to a later copy while a step still reads it;
  * **pinned staging** — a ring of ``depth + 1`` pinned buffers per (shape,
    dtype), each reused only after the event of the copy that last read it
    has completed (a copy from pageable memory would be synchronous and
    hide nothing).

A ``fit_batches`` CUDA-graph capture (``nn/train_graph.py``) pauses every
live producer (``producers_paused``), so no thread issues CUDA work while
a graph is being captured, and captures in ``thread_local`` mode.

Input-stall accounting: every ``next()`` measures the gap between "step
requested a batch" and "a batch was ready".  ``stall_stats()`` returns the
stall fraction / queue depth snapshot, also published as the
``input_pipeline`` collector of ``obs.metrics``.

The synchronous path is untouched: not wrapping (or CLI ``--prefetch 0``)
runs exactly the pre-prefetch code, bit for bit.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from ..utils.device import DeviceLike, resolve_device
from .dataset import DataSet
from .iterators import DataSetIterator, _ProducerFailure

# live prefetchers, for the stats snapshot (weak: a dropped iterator must
# not be kept alive — its producer thread would be too)
_LIVE: "weakref.WeakSet[DevicePrefetchIterator]" = weakref.WeakSet()

# producers hold it while they place a batch (on a card: issue its CUDA
# work); a graph capture holds it for the whole capture (``producers_paused``)
_GATE = threading.RLock()


def live_pipelines():
    """Snapshot list over the currently-live prefetch iterators."""
    return list(_LIVE)


@contextlib.contextmanager
def producers_paused():
    """Hold every live producer before its next batch's CUDA work (the
    one in progress finishes enqueueing first) until the block exits.
    ``nn/train_graph.py`` captures ``fit_batches`` inside it."""
    with _GATE:
        yield


# stall stats ride the unified registry too: one /metrics response
# answers "is this job input-bound"
get_registry().register_collector(
    "input_pipeline", lambda: [p.stall_stats() for p in live_pipelines()])


def _tree_map(fn, tree):
    """``fn`` over the leaves of a DataSet field tuple / list / dict tree
    (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _torch_dtype(d) -> torch.dtype:
    """A dtype name, numpy dtype or torch dtype → the torch dtype
    (``"bfloat16"`` → ``torch.bfloat16``, which numpy lacks)."""
    if isinstance(d, torch.dtype):
        return d
    try:
        name = "bfloat16" if str(d) == "bfloat16" else np.dtype(d).name
    except TypeError:
        name = None
    out = getattr(torch, name, None) if name else None
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown cast_dtype {d!r}")
    return out


def _cut(placement, batch):
    """This rank's rows of ``batch`` when ``placement`` is a batch
    sharding (anything with ``local_rows``), else ``batch``."""
    if placement is not None and hasattr(placement, "local_rows"):
        return placement.local_rows(batch)
    return batch


def _target(placement) -> torch.device:
    if placement is not None and hasattr(placement, "local_rows"):
        return torch.device(placement.device)
    return resolve_device(placement)


def device_put_batch(batch, placement=None):
    """Transfer a tree (tuple / list / dict) of host arrays or tensors to a
    device.

    ``placement`` is a ``torch.device`` (or its name), a trainer's
    ``batch_sharding`` (this rank's rows, on its device), or None (the
    card).  Tensors already on the target device pass through untouched —
    never a device→host→device round trip.  The copy of a pageable array
    is synchronous; ``DevicePrefetchIterator`` is the asynchronous path."""
    dev = _target(placement)
    batch = _cut(placement, batch)

    def put(a):
        if isinstance(a, torch.Tensor) and a.device == dev:
            return a
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(dev)

    return _tree_map(put, batch)


class _Staging:
    """The pinned host buffers of one (shape, dtype): a ring of ``n``, each
    with the event of the copy that last read it."""

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype, n: int):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(n)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * n
        self.next = 0

    def acquire(self) -> Tuple[int, torch.Tensor]:
        """The next buffer in ring order, after its last copy completed (a
        host wait on the PRODUCER thread, only when the ring is short)."""
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        ev = self.events[i]
        if ev is not None and not ev.query():
            ev.synchronize()
        return i, self.bufs[i]


class _Ready:
    """A placed batch and the event its consumer's stream waits on."""

    __slots__ = ("ds", "event")

    def __init__(self, ds: DataSet, event: Optional[torch.cuda.Event]):
        self.ds = ds
        self.event = event


class DevicePrefetchIterator(DataSetIterator):
    """Wrap any DataSetIterator with a depth-k ring of device-resident
    batches (k=2 double-buffers: one batch feeding the current step, one
    in flight).

    Parameters
    ----------
    base: the host-side iterator to wrap (its ``next()`` — including any
        attached host pre_processor — runs on the producer thread).
    depth: ring size — batches transferred ahead of the consumer.
    sharding: optional ``ShardedTrainer.batch_sharding``: the producer
        copies only this rank's rows to the rank's device, and the
        trainer's per-step row split passes the batch through.
    device: optional device (mutually exclusive with sharding); default
        ``cuda``, which raises without a card; ``"cpu"`` runs the pipeline
        on the CPU (plain tensors, no streams).
    cast_dtype: optional wire dtype for FLOATING feature arrays — cast on
        the host side of the copy (``"bfloat16"`` is ``torch.bfloat16``
        and halves wire bytes).  Labels, masks and integer features (uint8
        pixels, token ids) are never cast.  Lossy for narrowing casts — the
        bitwise-parity guarantee vs the sync path holds only with
        ``cast_dtype=None``.
    transform: optional device-side batch transform — either a fitted
        normalizer (``datasets.normalizers``; its ``device_transform()``
        runs the statistics on the device) or any callable DataSet→DataSet
        over tensors.  Runs after the copy, on the producer thread (and
        its stream).  If ``transform`` is the very normalizer attached to
        ``base`` as pre_processor, it is detached from the base for this
        pipeline — normalization moves on-device instead of running twice.
    """

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, depth: int = 2,
                 sharding=None, device: DeviceLike = None,
                 cast_dtype: Optional[Any] = None,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if sharding is not None and device is not None:
            raise ValueError("pass sharding OR device, not both")
        self._base = base
        self._depth = depth
        self._placement = sharding
        self.device = _target(sharding) if sharding is not None else resolve_device(device)
        self._cast = None if cast_dtype is None else _torch_dtype(cast_dtype)
        if transform is not None and hasattr(transform, "device_transform"):
            if getattr(base, "pre_processor", None) is transform:
                base.pre_processor = None
            transform = transform.device_transform()
        self._transform = transform
        self.batch_size = base.batch_size
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._staging: Dict[Tuple[Tuple[int, ...], torch.dtype], _Staging] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._peeked = None
        self._closed = False
        # stall accounting (cumulative across epochs/resets)
        self._lock = threading.Lock()
        self._batches = 0
        self._stalls = 0
        self._stall_seconds = 0.0
        self._first_request: Optional[float] = None
        self._last_ready: Optional[float] = None
        _LIVE.add(self)
        self._start()

    # -- producer ----------------------------------------------------------

    def _host(self, a, feature: bool) -> torch.Tensor:
        """A CPU tensor of ``a`` (numpy shares memory), the wire cast
        applied to floating features."""
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        if feature and self._cast is not None and t.is_floating_point():
            t = t.to(self._cast)
        return t

    def _copy_in(self, t: torch.Tensor, copies: list) -> torch.Tensor:
        """``t`` on the card: staged in a pinned buffer, then copied with
        ``non_blocking=True`` on the producer's stream (the current one)."""
        if t.device == self.device:
            return t
        t = t.cpu()
        key = (tuple(t.shape), t.dtype)
        ring = self._staging.get(key)
        if ring is None:
            ring = self._staging[key] = _Staging(key[0], t.dtype, self._depth + 1)
        i, buf = ring.acquire()
        buf.copy_(t)
        out = torch.empty(key[0], dtype=t.dtype, device=self.device)
        out.copy_(buf, non_blocking=True)
        copies.append((ring, i))
        return out

    def _place(self, ds: DataSet):
        """Host cast (wire dtype) → copy to the device → on-device
        transform.  Runs on the producer thread; on a card the copies and
        the transform are queued on the producer's stream, and the
        returned batch carries the event its consumer waits on."""
        fields = _cut(self._placement, (ds.features, ds.labels, ds.features_mask,
                                        ds.labels_mask))
        fields = (_tree_map(lambda a: self._host(a, True), fields[0]),
                  *(_tree_map(lambda a: self._host(a, False), f) for f in fields[1:]))
        if not self._cuda:
            with _GATE:
                out = DataSet(*_tree_map(lambda t: t.to(self.device), fields))
                if self._transform is not None:
                    out = self._transform(out)
            return _Ready(self._mark(out), None)
        with _GATE, torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            copies: list = []
            out = DataSet(*_tree_map(lambda t: self._copy_in(t, copies), fields))
            if self._transform is not None:
                out = self._transform(out)
            done = torch.cuda.Event()
            done.record(self._stream)
            for ring, i in copies:
                ring.events[i] = done
        return _Ready(self._mark(out), done)

    def _mark(self, ds: DataSet) -> DataSet:
        if self._placement is not None:
            ds.sharded_as = self._placement
        return ds

    def _start(self) -> None:
        self._queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        self._stop = stop
        q = self._queue

        def _enqueue(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            err: Optional[BaseException] = None
            try:
                self._base.reset()
                while not stop.is_set() and self._base.has_next():
                    _enqueue(self._place(self._base.next()))
            except BaseException as e:  # noqa: BLE001 — carried, not eaten
                err = e
            finally:
                # exhaustion OR failure both close the stream explicitly;
                # a raise must reach the consumer, never truncate an epoch
                _enqueue(self._SENTINEL if err is None
                         else _ProducerFailure(err))

        self._thread = threading.Thread(
            target=producer, daemon=True, name="DevicePrefetchIterator")
        self._thread.start()

    def _teardown(self) -> None:
        """Stop the producer deadlock-free (it may be blocked on a full
        queue) and join it — no thread leaks on reset/close mid-stream."""
        if self._thread is None:
            return
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
        self._thread = None
        self._peeked = None

    # -- consumer ----------------------------------------------------------

    def _peek(self):
        if self._peeked is None:
            if self._closed:
                return self._SENTINEL
            t0 = time.perf_counter()
            # the data-wait leg of the step span taxonomy: how long the
            # consumer sat waiting for a device-resident batch
            with obs_trace.span("input/data_wait", cat="input"):
                item = self._queue.get()
            waited = time.perf_counter() - t0
            with self._lock:
                if self._first_request is None:
                    self._first_request = t0
                self._stall_seconds += waited
                if waited > 1e-3:
                    self._stalls += 1
                self._last_ready = t0 + waited
            self._peeked = item
        return self._peeked

    def has_next(self) -> bool:
        item = self._peek()
        if isinstance(item, _ProducerFailure):
            raise item.exc
        return item is not self._SENTINEL

    def next(self) -> DataSet:
        item = self._peek()
        if isinstance(item, _ProducerFailure):
            raise item.exc
        if item is self._SENTINEL:
            raise StopIteration
        self._peeked = None
        with self._lock:
            self._batches += 1
        if item.event is not None:
            # the consumer's stream (not its thread) waits for the copy and
            # the transform; its tensors are in use on that stream from here
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(item.event)
            for t in _leaves((item.ds.features, item.ds.labels,
                              item.ds.features_mask, item.ds.labels_mask)):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(consumer)
        return item.ds

    def reset(self) -> None:
        """Restart the stream: tear the producer down (even mid-stream or
        after a failure) and spin a fresh pass.  Stall statistics are
        cumulative across resets — an epoch boundary is not a new run."""
        self._teardown()
        self._closed = False
        self._start()

    def close(self) -> None:
        """Tear down without restarting (mid-stream teardown); the
        iterator reports exhausted until ``reset()``."""
        self._teardown()
        self._closed = True

    def total_examples(self):
        return self._base.total_examples()

    # -- input-stall accounting --------------------------------------------

    def stall_stats(self) -> dict:
        """Snapshot of the request-vs-ready accounting.

        ``stall_fraction`` is the share of the consumer's wall clock (first
        request → last batch ready) spent waiting on the pipeline: ~0 means
        input is fully hidden under compute; → 1 means the step is
        input-bound (grow ``depth``, move ETL on-device, or shrink wire
        bytes).  The first batch always stalls — the ring starts empty."""
        with self._lock:
            wall = ((self._last_ready - self._first_request)
                    if self._first_request is not None
                    and self._last_ready is not None else 0.0)
            stall = self._stall_seconds
            n = self._batches
            return {
                "depth": self._depth,
                "queue_depth": self._queue.qsize(),
                "batches": n,
                "stalls": self._stalls,
                "stall_seconds": round(stall, 6),
                "stall_fraction": round(stall / wall, 6) if wall > 0 else (
                    1.0 if stall > 0 else 0.0),
                "avg_stall_ms": round(stall / n * 1e3, 3) if n else 0.0,
            }
