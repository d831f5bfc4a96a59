"""Replicated predict engine: dispatch, warm-up as CUDA graphs, hot-swap,
resilience (mirrors ``deeplearning4j_tpu/serving/engine.py``), and the
typed serving errors and future helpers the decode engine shares.

Topology (one Engine):

    callers ──submit──▶ DynamicBatcher ──next_batch──▶ dispatcher thread
        ──round-robin over dispatchable replicas (in-flight cap per
          replica, health + circuit breaker)──▶ replica queues
        ──▶ replica threads (one per replica; replica i on
            cuda:(i mod device_count), or the CPU) ──▶ futures resolve
    supervisor thread ──▶ detects crashed and hung replica threads,
        retries or fails their futures, respawns and re-warms them

Model versions are immutable ``_ModelVersion`` snapshots: a batch reads
the current version once, under the version lock, so it never mixes two
versions.  ``swap_model`` warms the incoming version first, flips the
pointer, then waits until every batch on the old version has drained.

Warm-up (``load()``) is the port's form of the reference's ahead-of-time
compiles: on a card it captures the forward, ``model._apply_layers(
params, state, x, None, train=False)``, once per (bucket, input dtype)
pair and per replica into a ``cuda_graphs.ForwardGraph`` (a stream and
static buffers of its own).  A served batch is copied into its bucket's
static input and replayed; its output rows are checked for finiteness
on the device and only then copied to the host.  ``compile_cache_size``
counts the prepared programs (the captured graphs; on the CPU, where
nothing is captured, the warmed (replica, bucket, dtype) forwards) and
does not grow while serving.  A batch whose pair was not warmed, or
whose per-example shape is not the warmed one, runs eagerly and counts
``unwarmed_serves``.  Models without
``_apply_layers`` (a duck-typed ``.output``) run eagerly, unwarmed by
graphs, as the reference's do.

Failure model: every submitted future completes, with a result or a typed
error.  A replica thread that dies mid-batch, or runs one batch past
``forward_timeout_s``, is detected by the supervisor; its requests are
retried once on a different replica when their deadline allows (else
``ReplicaCrashError`` / ``ReplicaHungError``), and the replica respawns
with its graphs captured afresh.  K consecutive failures open a
replica's circuit breaker until ``breaker_cooldown_s`` passes, then one
probe batch half-opens it.  A batch with non-finite outputs is bisected
so only the poison request fails (``PoisonInputError``).

Not ported here: canary promotion, named models (``add_model``),
autoscaling, warm bundles, int8 quantization, tenancy and the chaos
hook; trace spans come with ``obs/``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .batcher import DeadlineExceededError, DynamicBatcher, _Request
from .metrics import ServingMetrics

_SENTINEL = object()
_log = logging.getLogger(__name__)


class ReplicaCrashError(RuntimeError):
    """The replica thread executing this request died; the request's
    deadline (or retry budget) did not allow a retry elsewhere."""


class ReplicaHungError(RuntimeError):
    """The replica executing this request exceeded ``forward_timeout_s``
    and was abandoned; no retry was possible within the deadline."""


class PoisonInputError(RuntimeError):
    """This request's input made the forward produce non-finite outputs
    (isolated by batch bisection: co-batched requests were unaffected)."""


class ServingUnavailableError(RuntimeError):
    """No dispatchable replica (all dead or circuit-broken)."""


class ModelNotLoadedError(RuntimeError):
    """The request named a model this engine does not place."""


def _fail_safe(fut: Future, exc: BaseException) -> None:
    if not fut.done():
        try:
            fut.set_exception(exc)
        except InvalidStateError:   # lost a completion race: resolved
            pass


def _set_safe(fut: Future, value) -> bool:
    """Resolve ``fut`` with ``value``; True when this call resolved it."""
    if not fut.done():
        try:
            fut.set_result(value)
            return True
        except InvalidStateError:   # lost a completion race: resolved
            pass
    return False


def _forwardable(model) -> bool:
    return (hasattr(model, "_apply_layers") and hasattr(model, "params")
            and hasattr(model, "state"))


def _to_device(tree, device: torch.device):
    """A params/state tree on ``device``; tensors already there pass
    through (the replicas on the model's own device share its
    parameters)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _rows_of(out, rows: int) -> Tuple[np.ndarray, bool]:
    """A duck-typed model's output (array or tensor) → (rows, finite)."""
    if isinstance(out, torch.Tensor):
        from .cuda_graphs import rows_to_host
        return rows_to_host(out.detach(), rows)
    out = np.asarray(out)[:rows]
    return out, bool(np.isfinite(out).all())


class _ModelVersion:
    """Immutable serving snapshot of one model version: per-replica
    parameters and state and the prepared programs, keyed (replica,
    bucket, dtype): a ``ForwardGraph`` on a card, None for a warmed eager
    forward on the CPU.  Plus the drain bookkeeping of a hot-swap."""

    def __init__(self, model, tag: str, devices: Sequence[torch.device]):
        self.model = model
        self.tag = tag
        self.forwardable = _forwardable(model)
        self.params: List[Any] = []
        self.state: List[Any] = []
        self.programs: Dict[Tuple[int, int, str], Any] = {}
        self.lock = threading.Lock()     # guards programs
        self.active = 0          # batches currently executing on this version
        self.retired = False
        self.drained = threading.Event()
        if self.forwardable:
            for d in devices:
                self.params.append(_to_device(model.params, d))
                self.state.append(_to_device(model.state, d))

    def fwd(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return self.model._apply_layers(self.params[idx], self.state[idx], x,
                                         None, train=False)[0]

    def cache_size(self) -> Optional[int]:
        if not self.forwardable:
            return None
        with self.lock:
            return len(self.programs)

    def release(self) -> None:
        """Drop the graphs (and their memory pools) of a drained version."""
        with self.lock:
            for g in self.programs.values():
                if g is not None:
                    g.release()
            self.programs.clear()


class _Execution:
    """One batch execution's claim on a model version; ``release`` is
    idempotent, so the supervisor and the executing thread may both
    call it."""

    __slots__ = ("version", "released")

    def __init__(self, version: _ModelVersion):
        self.version = version
        self.released = False


class _Replica:
    def __init__(self, idx: int, device: torch.device, inflight_cap: int):
        self.idx = idx
        self.device = device
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(1, inflight_cap))
        self.thread: Optional[threading.Thread] = None
        self.processed = 0
        # supervision state, all mutated under `lock`
        self.lock = threading.Lock()
        self.generation = 0              # bumped on every abandon/respawn
        self.current_batch: Optional[List[_Request]] = None
        self.busy_since: Optional[float] = None
        self.execution: Optional[_Execution] = None
        self.consecutive_failures = 0
        self.breaker_open = False
        self.breaker_open_until = 0.0
        self.respawns = 0


class Engine:
    """Production inference engine over any model with ``.output(x)``.

    ``max_batch`` / ``slo_ms`` / ``bucket_sizes`` / ``max_queue`` /
    ``admission`` / ``max_wait_ms``: batching and admission control
    (``serving/batcher.py``).  ``replicas``: replica count, ``-1`` = one
    per card; replica i runs on ``cuda:(i mod device_count)``, or on the
    CPU with ``device="cpu"``.  ``inflight_per_replica``: the dispatcher
    skips a replica whose queue holds that many batches.
    ``forward_timeout_s``: a replica whose batch runs longer is declared
    hung (None: crash detection only).  ``max_retries``: per-request
    retries after a replica failure or forward error, on a different
    replica and never past the deadline.  ``breaker_threshold`` /
    ``breaker_cooldown_s``: the circuit breaker.  ``poison_isolation``:
    bisect non-finite batches.  ``device`` defaults to ``cuda`` and
    raises without a card."""

    def __init__(self, model=None, *, registry=None, name: Optional[str] = None,
                 ref: str = "prod", max_batch: int = 32, slo_ms: float = 50.0,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 replicas: int = 1, max_queue: int = 1024,
                 admission: str = "block", inflight_per_replica: int = 2,
                 max_wait_ms: Optional[float] = None,
                 metrics: Optional[ServingMetrics] = None,
                 forward_timeout_s: Optional[float] = None,
                 max_retries: int = 1, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 supervise_interval_s: float = 0.02,
                 poison_isolation: bool = True,
                 clock=time.monotonic, device: DeviceLike = None):
        if model is None:
            if registry is None or name is None:
                raise ValueError("pass a model, or registry= and name=")
            version, model = registry.resolve(name, ref)
            tag = f"{name}:v{version}"
        else:
            tag = "v0"
        base = resolve_device(device)
        self.device = base
        self.metrics = metrics or ServingMetrics()
        self.batcher = DynamicBatcher(
            max_batch=max_batch, slo_ms=slo_ms, bucket_sizes=bucket_sizes,
            max_queue=max_queue, admission=admission,
            max_wait_ms=max_wait_ms, metrics=self.metrics, clock=clock)
        self.clock = clock
        self.forward_timeout_s = forward_timeout_s
        self.max_retries = int(max_retries)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.supervise_interval_s = float(supervise_interval_s)
        self.poison_isolation = bool(poison_isolation)
        n_dev = torch.cuda.device_count() if base.type == "cuda" else 1
        n = n_dev if replicas in (-1, 0) else int(replicas)
        if n < 1:
            raise ValueError(f"replicas must be >=1 or -1, got {replicas}")
        self._replicas = [
            _Replica(i, torch.device("cuda", i % n_dev) if base.type == "cuda"
                     else base, inflight_per_replica)
            for i in range(n)]
        self._devices = [r.device for r in self._replicas]
        self._vlock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._current = _ModelVersion(model, tag, self._devices)
        self._warmed: set = set()       # (bucket, dtype_str) pairs
        self._example_shape: Optional[Tuple[int, ...]] = None
        self._warm_dtypes: Tuple[str, ...] = ("float32",)
        self._loaded = False
        self._shutdown = False
        self.batch_log: List[dict] = []  # bounded; test/debug hook
        self._log_lock = threading.Lock()
        if registry is not None and name is not None:
            registry.subscribe(
                name, ref,
                lambda version, m: self.swap_model(m, tag=f"{name}:v{version}"))
        for r in self._replicas:
            self._start_replica_thread(r)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="engine-dispatch", daemon=True)
        self._dispatcher.start()
        self._supervisor = threading.Thread(target=self._supervise_loop,
                                            name="engine-supervisor", daemon=True)
        self._supervisor.start()

    @classmethod
    def from_registry(cls, registry, name: str, ref: str = "prod",
                      **kwargs) -> "Engine":
        return cls(registry=registry, name=name, ref=ref, **kwargs)

    # -- warm-up -------------------------------------------------------------

    def _infer_example_shape(self) -> Optional[Tuple[int, ...]]:
        conf = getattr(self._current.model, "conf", None)
        it = getattr(conf, "input_type", None)
        if it is None:
            return None
        try:
            return tuple(it.batch_shape(1))[1:]
        except ValueError:  # variable-length recurrent input
            return None

    def load(self, input_shape: Optional[Sequence[int]] = None,
             dtypes: Sequence[str] = ("float32",)) -> "Engine":
        """Warm-up: prepare every (bucket, dtype) pair on every replica
        (capture its graph on a card) so no request pays a capture.
        ``input_shape`` is the per-example shape, inferred from the
        model's configured InputType when omitted.  The warm-up times
        seed the batcher's per-bucket exec EMA."""
        shape = tuple(input_shape) if input_shape is not None else (
            self._infer_example_shape())
        if shape is None:
            raise ValueError(
                "cannot infer the per-example input shape from the model's "
                "configuration — pass input_shape=(...) explicitly")
        self._example_shape = shape
        self._warm_dtypes = tuple(dtypes)
        self._warm_version(self._current)
        self._loaded = True
        return self

    def _warm_version(self, v: _ModelVersion) -> None:
        """Prepare and run one version over every (bucket, dtype) pair on
        every replica, then time replica 0 once more for the EMA seed."""
        shape = self._example_shape
        if shape is None:
            return
        for dtype in self._warm_dtypes:
            dts = str(np.dtype(dtype))
            for b in self.batcher.buckets:
                x = np.zeros((b,) + shape, dtype=dtype)
                t0 = self.clock()
                for i in range(len(self._replicas)):
                    self._prepare(v, i, b, dts)
                    self._run_forward(v, i, x)
                self.metrics.inc("warmup_seconds_total", self.clock() - t0)
                t1 = self.clock()
                self._run_forward(v, 0, x)
                self.batcher.observe_exec_ms(b, (self.clock() - t1) * 1e3)
                self._warmed.add((b, dts))

    def _prepare(self, v: _ModelVersion, idx: int, b: int, dts: str) -> None:
        """Capture the graph of one (replica, bucket, dtype), replacing
        (and releasing) any earlier one; on the CPU mark the pair warmed."""
        if not v.forwardable:
            return
        dev = self._replicas[idx].device
        g = None
        if dev.type == "cuda":
            from .cuda_graphs import ForwardGraph
            g = ForwardGraph(lambda x: v.fwd(idx, x),
                             (b,) + tuple(self._example_shape),
                             torch.from_numpy(np.zeros(0, dts)).dtype, dev)
        with v.lock:
            old = v.programs.get((idx, b, dts))
            v.programs[(idx, b, dts)] = g
        if old is not None:
            old.release()

    def _rewarm_replica(self, idx: int) -> None:
        """Re-warm one (respawned) replica: capture its graphs of the
        current version afresh (new buffers and streams, so an abandoned
        incarnation still holding the old ones shares nothing with the
        new; the count of programs is unchanged) and run every warmed
        pair once, which doubles as a health probe."""
        with self._vlock:
            v = self._current
        shape = self._example_shape
        if shape is None:
            return
        for dtype in self._warm_dtypes:
            dts = str(np.dtype(dtype))
            for b in self.batcher.buckets:
                if (b, dts) in self._warmed:
                    self._prepare(v, idx, b, dts)
                self._run_forward(v, idx, np.zeros((b,) + shape, dtype=dtype))

    def compile_cache_size(self) -> Optional[int]:
        """Prepared programs behind the current version's forward (None
        for a duck-typed model): captured graphs on a card, warmed
        (replica, bucket, dtype) forwards on the CPU.  After ``load`` it
        must not grow while serving bucket-shaped requests, also across
        respawns and swaps."""
        with self._vlock:
            v = self._current
        return v.cache_size()

    # -- request path --------------------------------------------------------

    def output(self, x, slo_ms: Optional[float] = None) -> np.ndarray:
        """Submit one request (leading batch axis); blocks for the result."""
        return self.output_async(x, slo_ms=slo_ms).result()

    def output_async(self, x, slo_ms: Optional[float] = None) -> Future:
        return self.batcher.submit(np.asarray(x), slo_ms=slo_ms)

    # -- dispatch --------------------------------------------------------------

    def _dispatchable(self, r: _Replica, now: float) -> bool:
        """Thread alive and breaker closed (or past its cooldown: half-open,
        the next batch is the probe)."""
        with r.lock:
            if r.thread is None or not r.thread.is_alive():
                return False
            if r.breaker_open and now < r.breaker_open_until:
                return False
        return True

    def _dispatch_loop(self) -> None:
        rr = 0
        while True:
            batch = self.batcher.next_batch()
            if batch is None:
                break
            rr = self._place_batch(batch, rr)
        for r in list(self._replicas):
            r.queue.put(_SENTINEL)

    def _place_batch(self, batch: List[_Request], rr: int) -> int:
        """Round-robin placement skipping unhealthy or full replicas;
        waits (expiring deadlines) while nothing is dispatchable, fails
        the batch on shutdown."""
        while True:
            if self._shutdown:
                for req in batch:
                    _fail_safe(req.future, RuntimeError("serving engine is shut down"))
                return rr
            now = self.clock()
            batch = self._expire_batch(batch, now)
            if not batch:
                return rr
            reps = list(self._replicas)
            n = len(reps)
            candidates = [reps[(rr + k) % n] for k in range(n)]
            dispatchable = [c for c in candidates if self._dispatchable(c, now)]
            for c in dispatchable:
                try:
                    c.queue.put_nowait(batch)
                    return (c.idx + 1) % n
                except queue.Full:
                    continue
            if dispatchable:
                # every healthy replica at its in-flight cap: backpressure
                c = dispatchable[0]
                try:
                    c.queue.put(batch, timeout=0.1)
                    return (c.idx + 1) % n
                except queue.Full:
                    continue
            # nothing dispatchable: wait for the supervisor to respawn
            time.sleep(0.005)

    def _expire_batch(self, batch: List[_Request], now: float) -> List[_Request]:
        live = []
        expired = 0
        for r in batch:
            if r.future.done():
                continue
            if r.deadline < now:
                expired += 1
                _fail_safe(r.future, DeadlineExceededError(
                    f"deadline passed after {(now - r.t_submit) * 1e3:.1f}ms"))
            else:
                live.append(r)
        if expired:
            self.metrics.inc("deadline_missed", expired)
        return live

    def _start_replica_thread(self, r: _Replica) -> None:
        with r.lock:
            gen = r.generation
            t = threading.Thread(target=self._replica_loop, args=(r, gen),
                                 name=f"engine-replica-{r.idx}", daemon=True)
            r.thread = t
        t.start()

    def _replica_loop(self, replica: _Replica, gen: int) -> None:
        while True:
            item = replica.queue.get()
            if item is _SENTINEL:
                break
            with replica.lock:
                if gen != replica.generation:
                    # abandoned while blocked in get(): hand the batch to
                    # the live incarnation and exit
                    replica.queue.put(item)
                    return
                replica.current_batch = item
                replica.busy_since = self.clock()
            self._execute(item, replica, gen)
            with replica.lock:
                if gen != replica.generation:
                    return              # abandoned mid-execute; successor runs
                replica.current_batch = None
                replica.busy_since = None
                replica.processed += 1

    # -- execution -------------------------------------------------------------

    def _run_forward(self, v: _ModelVersion, idx: int, xs: np.ndarray,
                     rows: Optional[int] = None) -> Tuple[np.ndarray, bool]:
        """The forward of the bucket-shaped ``xs`` on replica ``idx`` →
        (its first ``rows`` output rows on the host, all finite): the
        pair's graph where one was captured for this per-example shape,
        else the eager forward (a graph's input copy would broadcast
        another shape, so it runs eagerly and the model's own shape check
        applies)."""
        rows = xs.shape[0] if rows is None else rows
        if not v.forwardable:
            out = v.model.output(xs)
            return _rows_of(out[0] if isinstance(out, list) else out, rows)
        g = None
        if xs.shape[1:] == self._example_shape:
            with v.lock:
                g = v.programs.get((idx, xs.shape[0], str(xs.dtype)))
        if g is not None:
            return g(xs, rows)
        from .cuda_graphs import rows_to_host
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(xs)).to(self._replicas[idx].device)
            return rows_to_host(v.fwd(idx, x), rows)

    def _forward_padded(self, v: _ModelVersion, idx: int, reqs: List[_Request],
                        count_unwarmed: bool = True):
        """Concatenate and pad ``reqs`` to their bucket, run the forward →
        (output rows of the requests, finite, rows, bucket, padded)."""
        xs = (reqs[0].x if len(reqs) == 1
              else np.concatenate([r.x for r in reqs], axis=0))
        rows = xs.shape[0]
        bucket = self.batcher.bucket_for(rows)
        padded = bucket - rows
        if padded:
            pad = np.zeros((padded,) + xs.shape[1:], xs.dtype)
            xs = np.concatenate([xs, pad], axis=0)
        if (count_unwarmed and self._loaded
                and ((bucket, str(xs.dtype)) not in self._warmed
                     or xs.shape[1:] != self._example_shape)):
            self.metrics.inc("unwarmed_serves")
        out, finite = self._run_forward(v, idx, xs, rows)
        return out, finite, rows, bucket, padded

    def _execute(self, batch: List[_Request], replica: _Replica, gen: int) -> None:
        now = self.clock()
        live = self._expire_batch(batch, now)
        if not live:
            return
        for r in live:
            self.metrics.queue_wait.record((now - r.t_submit) * 1e3)
        with self._vlock:
            v = self._current
            v.active += 1
        ex = _Execution(v)
        with replica.lock:
            replica.execution = ex
        t0 = self.clock()
        try:
            out, finite, rows, bucket, padded = self._forward_padded(v, replica.idx, live)
            device_ms = (self.clock() - t0) * 1e3
            if self.poison_isolation and not finite:
                # bisect to isolate the poison request(s): co-batched
                # requests still succeed
                self._log_batch(v, replica, live, rows, padded, poison=True)
                self._isolate_poison(v, replica, live, precomputed=out)
                self.metrics.record_batch(len(live), rows, padded, device_ms)
                return
        except Exception as e:
            self.metrics.inc("errors")
            self._retry_or_fail(live, replica.idx, e)
            return
        finally:
            self._release(ex)
            with replica.lock:
                replica.execution = None
        with replica.lock:
            abandoned = gen != replica.generation
            if not abandoned and (replica.consecutive_failures
                                  or replica.breaker_open):
                # a completed batch is the half-open probe succeeding
                replica.consecutive_failures = 0
                replica.breaker_open = False
        if abandoned:
            # the supervisor already redispatched this batch: discard
            return
        self.batcher.observe_exec_ms(bucket, device_ms)
        self.metrics.record_batch(len(live), rows, padded, device_ms)
        self._log_batch(v, replica, live, rows, padded)
        done = self.clock()
        ofs = 0
        for r in live:
            _set_safe(r.future, out[ofs:ofs + r.rows])
            ofs += r.rows
            self.metrics.e2e.record((done - r.t_submit) * 1e3)

    def _log_batch(self, v: _ModelVersion, replica: _Replica, live: List[_Request],
                   rows: int, padded: int, poison: bool = False) -> None:
        """Append one executed batch to ``batch_log`` (bounded); ``poison``
        marks a batch whose output was non-finite and went to bisection."""
        with self._log_lock:
            self.batch_log.append({"tag": v.tag, "n_requests": len(live),
                                   "rows": rows, "padded": padded,
                                   "replica": replica.idx, "poison": poison,
                                   "request_ids": [id(r.future) for r in live]})
            if len(self.batch_log) > 4096:
                del self.batch_log[:2048]

    def _isolate_poison(self, v: _ModelVersion, replica: _Replica,
                        reqs: List[_Request],
                        precomputed: Optional[np.ndarray] = None) -> None:
        """Bisection: resolve every request in ``reqs`` with a result or
        ``PoisonInputError``, re-running bucket-shaped halves (so still on
        captured graphs) until each non-finite output is pinned to one
        request.  Works even when a poison row contaminates the whole
        batch's output."""
        if precomputed is not None:
            out = precomputed
        else:
            out, _, _, _, _ = self._forward_padded(v, replica.idx, reqs,
                                                   count_unwarmed=False)
        ofs = 0
        finite = []
        for r in reqs:
            finite.append(bool(np.isfinite(out[ofs:ofs + r.rows]).all()))
            ofs += r.rows
        if all(finite):
            done = self.clock()
            ofs = 0
            for r in reqs:
                _set_safe(r.future, out[ofs:ofs + r.rows])
                ofs += r.rows
                self.metrics.e2e.record((done - r.t_submit) * 1e3)
            return
        if len(reqs) == 1:
            self.metrics.inc("poison_isolated")
            _fail_safe(reqs[0].future, PoisonInputError(
                "request input produced non-finite outputs (isolated by "
                "batch bisection)"))
            return
        mid = max(1, len(reqs) // 2)
        self._isolate_poison(v, replica, reqs[:mid])
        self._isolate_poison(v, replica, reqs[mid:])

    # -- failure isolation and retry ---------------------------------------------

    def _release(self, ex: _Execution) -> None:
        with self._vlock:
            if ex.released:
                return
            ex.released = True
            v = ex.version
            v.active -= 1
            if v.retired and v.active == 0:
                v.drained.set()

    def _retry_or_fail(self, reqs: List[_Request], failed_idx: int,
                       error: BaseException) -> None:
        """Deadline-aware bounded retry: requests with retry budget and
        deadline slack for another execution go to a different replica;
        the rest fail with ``error``."""
        now = self.clock()
        retry = []
        for r in reqs:
            if r.future.done():
                continue
            budget_s = self.batcher._exec_budget_ms(r.rows) / 1000.0
            if r.retries < self.max_retries and r.deadline - now > budget_s:
                r.retries += 1
                r.tried.add(failed_idx)
                retry.append(r)
            else:
                _fail_safe(r.future, error)
        if not retry:
            return
        self.metrics.inc("retries", len(retry))
        self._redispatch(retry)

    def _redispatch(self, reqs: List[_Request]) -> None:
        """Place retried requests on a healthy replica, preferring one that
        has not failed them; a short blocking put competes fairly with the
        dispatcher, and the preference is dropped after a few rounds
        rather than starving the retry until its deadline."""
        tried = set()
        for r in reqs:
            tried |= r.tried
        rounds = 0
        while True:
            if self._shutdown:
                for r in reqs:
                    _fail_safe(r.future, RuntimeError("serving engine is shut down"))
                return
            now = self.clock()
            reqs = self._expire_batch(reqs, now)
            if not reqs:
                return
            candidates = [c for c in self._replicas if self._dispatchable(c, now)]
            preferred = ([c for c in candidates if c.idx not in tried]
                         if rounds < 3 else []) or candidates
            for c in preferred[1:]:
                try:
                    c.queue.put_nowait(list(reqs))
                    return
                except queue.Full:
                    continue
            if preferred:
                try:
                    preferred[0].queue.put(list(reqs), timeout=0.05)
                    return
                except queue.Full:
                    pass
            else:
                time.sleep(0.005)
            rounds += 1

    # -- supervision -------------------------------------------------------------

    def _supervise_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self.supervise_interval_s)
            if self._shutdown:
                return
            now = self.clock()
            for r in list(self._replicas):
                if self._shutdown:
                    return
                self._check_replica(r, now)

    def _check_replica(self, r: _Replica, now: float) -> None:
        with r.lock:
            if self._shutdown:
                return      # a sentinel-exited thread is not a crash
            crashed = r.thread is not None and not r.thread.is_alive()
            hung = (not crashed and self.forward_timeout_s is not None
                    and r.busy_since is not None
                    and now - r.busy_since > self.forward_timeout_s)
            if not crashed and not hung:
                return
            batch = r.current_batch
            ex = r.execution
            r.current_batch = None
            r.busy_since = None
            r.execution = None
            r.generation += 1       # any late wake-up is now a no-op
            r.consecutive_failures += 1
            r.respawns += 1
            opened = False
            if r.consecutive_failures >= self.breaker_threshold and not r.breaker_open:
                r.breaker_open = True
                opened = True
            if r.breaker_open:
                r.breaker_open_until = now + self.breaker_cooldown_s
        if ex is not None:
            self._release(ex)       # idempotent against the hung finally
        self.metrics.inc("replica_crashes" if crashed else "replica_hangs")
        if opened:
            self.metrics.inc("circuit_opens")
        # respawn first, so a retry has a live target even with one replica
        self._start_replica_thread(r)
        error: RuntimeError = (
            ReplicaCrashError(f"replica {r.idx} thread died mid-batch") if crashed
            else ReplicaHungError(f"replica {r.idx} exceeded forward_timeout_s="
                                  f"{self.forward_timeout_s}"))
        # recover off the supervisor thread: re-warm and retry can block,
        # and hang detection on the other replicas must keep running
        threading.Thread(target=self._recover_replica, args=(r, batch, error),
                         name=f"engine-recover-{r.idx}", daemon=True).start()

    def _recover_replica(self, r: _Replica, batch: Optional[List[_Request]],
                         error: RuntimeError) -> None:
        try:
            self._rewarm_replica(r.idx)
        except Exception:
            # the replica fails its next batch and re-enters the
            # supervisor; the breaker bounds the retries
            self.metrics.inc("respawn_failures")
            _log.exception("re-warm of replica %d failed", r.idx)
        self.metrics.inc("replica_respawns")
        if batch:
            self._retry_or_fail([q for q in batch if not q.future.done()], r.idx, error)

    def health_snapshot(self) -> dict:
        """Per-replica health (healthy / degraded / dead) and readiness:
        ``status`` "ok" (all healthy), "degraded" (at least one
        dispatchable), "unready" (none, or shut down)."""
        now = self.clock()
        reps = []
        n_healthy = n_dispatchable = 0
        for r in self._replicas:
            with r.lock:
                alive = r.thread is not None and r.thread.is_alive()
                cooling = r.breaker_open and now < r.breaker_open_until
                if not alive or cooling:
                    h = "dead"
                elif r.breaker_open or r.consecutive_failures:
                    h = "degraded"      # half-open, or recent failures
                else:
                    h = "healthy"
                reps.append({
                    "replica": r.idx, "health": h, "alive": alive,
                    "busy": r.busy_since is not None,
                    "consecutive_failures": r.consecutive_failures,
                    "breaker_open": r.breaker_open,
                    "respawns": r.respawns, "processed": r.processed,
                    "device": str(r.device),
                })
            if h == "healthy":
                n_healthy += 1
            if h != "dead":
                n_dispatchable += 1
        if self._shutdown or n_dispatchable == 0:
            status = "unready"
        elif n_healthy == len(self._replicas):
            status = "ok"
        else:
            status = "degraded"
        return {"status": status, "ready": status != "unready", "replicas": reps}

    # -- hot swap ----------------------------------------------------------------

    def swap_model(self, model, tag: Optional[str] = None) -> str:
        """Atomic hot-swap: build and warm the new version (its graphs
        captured while the old one serves), flip the current pointer, then
        block until every batch on the old version has completed and drop
        its graphs.  Returns the retired version's tag."""
        nv = _ModelVersion(model, tag or f"swap@{time.time():.0f}", self._devices)
        if self._loaded:
            self._warm_version(nv)
        with self._swap_lock:
            with self._vlock:
                old = self._current
                self._current = nv
                old.retired = True
                if old.active == 0:
                    old.drained.set()
            old.drained.wait()
            old.release()
            self.metrics.inc("swaps")
            return old.tag

    @property
    def current_tag(self) -> str:
        with self._vlock:
            return self._current.tag

    # -- lifecycle ---------------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["model"] = self.current_tag
        snap["replicas"] = len(self._replicas)
        snap["queue_depth"] = self.batcher.qsize()
        snap["buckets"] = list(self.batcher.buckets)
        snap["compile_cache_size"] = self.compile_cache_size()
        snap["health"] = self.health_snapshot()
        snap["device"] = str(self.device)
        return snap

    def begin_drain(self) -> None:
        """Stop admission (every later submission sheds with
        ``OverloadedError``, HTTP 429) while queued and in-flight batches
        complete; call ``shutdown()`` once the queue is empty."""
        self.batcher.begin_drain()
        self.metrics.inc("drains")

    def shutdown(self, timeout: float = 5.0) -> None:
        """Every request (queued, in a replica queue, or submitted
        concurrently with this call) resolves, with a result or the
        shut-down error; the graphs are released."""
        if self._shutdown:
            return
        self._shutdown = True
        self.batcher.close(fail_pending=True)
        self._dispatcher.join(timeout=timeout)
        for r in self._replicas:
            if r.thread:
                r.thread.join(timeout=timeout)
        if self._supervisor:
            self._supervisor.join(timeout=timeout)
        for r in self._replicas:
            with r.lock:
                stranded = r.current_batch
                r.current_batch = None
            if stranded:
                for req in stranded:
                    _fail_safe(req.future, RuntimeError("serving engine is shut down"))
            while True:
                try:
                    item = r.queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    continue
                for req in item:
                    _fail_safe(req.future, RuntimeError("serving engine is shut down"))
        with self._vlock:
            v = self._current
        if v.active == 0:
            v.release()
