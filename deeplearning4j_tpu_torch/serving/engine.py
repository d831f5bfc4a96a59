"""Replicated predict engine: dispatch, warm-up as CUDA graphs, hot-swap,
canary promotion, named models, tenant lanes, replica autoscale,
resilience (mirrors ``deeplearning4j_tpu/serving/engine.py``), and the
typed serving errors and future helpers the decode engine shares.

Topology (one Engine):

    callers ──submit──▶ DynamicBatcher (per-tenant lanes) ──next_batch──▶
        dispatcher thread ──round-robin over dispatchable replicas
          (in-flight cap per replica, health + circuit breaker)──▶
        replica queues ──▶ replica threads (one per replica; replica i on
            cuda:(i mod device_count), or the CPU) ──▶ futures resolve
    supervisor thread ──▶ detects crashed and hung replica threads,
        retries or fails their futures, respawns and re-warms them, and
        ticks the autoscaler

Model versions are immutable ``_ModelVersion`` snapshots: a batch reads
its model's current version once, under the version lock, so it never
mixes two versions, and a batch never mixes models (the batcher's rule).
``swap_model`` warms the incoming version first, flips the pointer, then
waits until every batch on the old version has drained and drops its
graphs.  The constructor's model is the default model; ``add_model``
places named models beside it, each warmed before it becomes routable.

Warm-up (``load()``) is the port's form of the reference's ahead-of-time
compiles: on a card it captures the forward, ``model._apply_layers(
params, state, x, None, train=False)``, once per (bucket, input dtype)
pair and per replica into a ``cuda_graphs.ForwardGraph`` (a stream and
static buffers of its own).  A served batch is copied into its bucket's
static input and replayed; its output rows are checked for finiteness
on the device and only then copied to the host.  ``compile_cache_size``
counts one model's prepared programs (the captured graphs; on the CPU,
where nothing is captured, the warmed (replica, bucket, dtype) forwards)
and does not grow while serving.  A batch whose pair was not warmed, or
whose per-example shape is not the warmed one, runs eagerly and counts
``unwarmed_serves``.  Models without
``_apply_layers`` (a duck-typed ``.output``) run eagerly, unwarmed by
graphs, as the reference's do.  A ``ComputationGraph`` is served that
way, the reference's: eagerly through its ``output`` (the first output
of a one-input graph, its per-example shape inferred from its one
InputType), warmed by one eager forward per (bucket, dtype) and
counted as the reference counts it (a warmed pair is no unwarmed serve;
``compile_cache_size`` is None, there being no captured program).

Every graph a request replays is captured before the request can reach
it.  Where the reference appends an autoscaled replica and warms it
after (its executables are compiled already, so that is safe there), a
replica born here captures the graphs of every warmed pair of the
current version, every named model and any canary first, and only then
joins the routable set; a canary's graphs are captured in
``run_canary`` before any batch is mirrored to it.  A retired replica,
a removed model and a rolled-back canary release their graphs once
their batches have drained.

``load(quantize="int8")`` serves the current model through
``ops/quantize.py`` (int8 weights, ``torch._int_mm``), calibrated on
``calibration_inputs``; the quantized forward is captured like any
other.  ``load(warm_bundle=)`` reads a bundle (``serving/warmcache.py``)
that names the graphs to capture; the graphs are captured either way,
and the pairs it named count ``bundle_hits``, the others
``bundle_misses``.

Failure model: every submitted future completes, with a result or a typed
error.  A replica thread that dies mid-batch, or runs one batch past
``forward_timeout_s``, is detected by the supervisor; its requests are
retried once on a different replica when their deadline allows (else
``ReplicaCrashError`` / ``ReplicaHungError``), and the replica respawns
with its graphs captured afresh.  K consecutive failures open a
replica's circuit breaker until ``breaker_cooldown_s`` passes, then one
probe batch half-opens it.  A batch with non-finite outputs is bisected
so only the poison request fails (``PoisonInputError``).  ``chaos=`` (a
``parallel.chaos.ServingChaos``) injects replica crashes and hangs.

Trace spans and instants (``obs.trace``) are the reference's, with its
names, categories and argument keys: ``serve/warmup``,
``serve/queue_wait``, ``serve/forward``, ``serve/request``,
``serve/batch``, ``serve/retry``, ``serve/scale_up`` /
``serve/scale_down``, ``serve/replica_crash`` / ``serve/replica_hang``,
``serve/circuit_open``, ``serve/respawn`` / ``serve/respawn_failed``,
``serve/canary_decision``, ``serve/swap``, ``serve/model_load`` /
``serve/model_evict`` and ``serve/drain``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops.quantize import Int8Weight
from ..utils.device import DeviceLike, resolve_device
from .batcher import DeadlineExceededError, DynamicBatcher, _Request
from .metrics import ServingMetrics

_SENTINEL = object()

# the device ms of the calling thread's last forward when it replayed a
# CUDA graph, else None: the canary compares these, not wall clocks
_FORWARD_MS = threading.local()
_log = logging.getLogger(__name__)

# the engine-side serving chaos kinds (``parallel.chaos.FaultKind``'s
# strings; serving does not import parallel/)
_CHAOS_CRASH = "replica_crash"
_CHAOS_HANG = "replica_hang"


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
    """The request named a model this engine does not place (never added,
    or removed)."""


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


def _bundle_key(bucket: int, dtype: str) -> str:
    """A warm bundle's key of one (bucket, dtype) forward."""
    return f"predict|b={bucket}|dtype={dtype}"


def _to_device(tree, device: torch.device):
    """A params/state tree on ``device``; tensors (and int8 weights)
    already there pass through (the replicas on the model's own device
    share its parameters)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, (torch.Tensor, Int8Weight)) else tree


def _rows_of(out, rows: int) -> Tuple[np.ndarray, bool]:
    """A duck-typed model's output (array or tensor) → (rows, finite)."""
    if isinstance(out, torch.Tensor):
        from .cuda_graphs import rows_to_host
        return rows_to_host(out.detach(), rows)
    out = np.asarray(out)[:rows]
    return out, bool(np.isfinite(out).all())


class _ModelVersion:
    """Serving snapshot of one model version: per-replica parameters and
    state, the per-example shape it was warmed at, and the prepared
    programs keyed (replica, bucket, dtype): a ``ForwardGraph`` on a card,
    None for a warmed eager forward on the CPU.  Plus the drain
    bookkeeping of a swap, an eviction or a rolled-back canary."""

    def __init__(self, model, tag: str, devices: Sequence[torch.device]):
        self.model = model
        self.tag = tag
        self.forwardable = _forwardable(model)
        self.shape: Optional[Tuple[int, ...]] = None
        self.params: List[Any] = []
        self.state: List[Any] = []
        self.programs: Dict[Tuple[int, int, str], Any] = {}
        self.lock = threading.Lock()     # guards programs, params, state
        self.active = 0          # batches currently executing on this version
        self.retired = False
        self.drained = threading.Event()
        self.ensure_replicas(devices)

    def ensure_replicas(self, devices: Sequence[torch.device]) -> None:
        """Parameters and state on every device of ``devices`` (a replica
        born after this version was built gets its copy here)."""
        if not self.forwardable:
            return
        with self.lock:
            while len(self.params) < len(devices):
                d = devices[len(self.params)]
                self.params.append(_to_device(self.model.params, d))
                self.state.append(_to_device(self.model.state, d))

    def fwd(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return self.model._apply_layers(self.params[idx], self.state[idx], x,
                                         None, train=False)[0]

    def cache_size(self) -> Optional[int]:
        if not self.forwardable:
            return None
        with self.lock:
            return len(self.programs)

    def pairs(self) -> Set[Tuple[int, str]]:
        """The (bucket, dtype) pairs prepared on any replica."""
        with self.lock:
            return {(b, dts) for (_, b, dts) in self.programs}

    def release(self, idx: Optional[int] = None) -> None:
        """Drop the graphs (and their memory pools) of one replica, or of
        every replica of a drained version."""
        with self.lock:
            keys = [k for k in self.programs if idx is None or k[0] == idx]
            gone = [self.programs.pop(k) for k in keys]
        for g in gone:
            if g is not None:
                g.release()


class _ModelEntry:
    """One named model placed beside the default one: its current version
    and its own warm-up state (the no-capture-at-serve contract holds per
    model)."""

    __slots__ = ("version", "example_shape", "warm_dtypes", "warmed", "last_used")

    def __init__(self, version: _ModelVersion, example_shape: Tuple[int, ...],
                 warm_dtypes: Tuple[str, ...]):
        self.version = version
        self.example_shape = example_shape
        self.warm_dtypes = warm_dtypes
        self.warmed: set = set()       # (bucket, dtype_str) pairs
        self.last_used: Optional[float] = None


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


class _CanaryState:
    """The shadow-traffic window of one canary candidate."""

    def __init__(self, version: _ModelVersion, frac: float, window: int):
        self.version = version
        self.frac = float(frac)
        self.window = int(window)
        self.lock = threading.Lock()
        self.eligible = 0
        self.mirrored = 0
        self.canary_ms: List[float] = []
        self.incumbent_ms: List[float] = []
        self.canary_errors = 0
        self.divergences: List[float] = []
        self.done = threading.Event()

    def select(self) -> bool:
        """Mirror eligible batch k iff the integer part of k·frac advanced:
        exactly ceil(frac·n) of the first n mirror, with no RNG."""
        self.eligible += 1
        return int(self.eligible * self.frac) > int((self.eligible - 1) * self.frac)


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
    bisect non-finite batches.  ``chaos``: an armed
    ``parallel.chaos.ServingChaos`` (tests and soaks).  ``tenants``: a
    ``tenancy.TenantTable`` (per-tenant quotas and fair-share lanes).
    ``device`` defaults to ``cuda`` and raises without a card."""

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
                 chaos=None, tenants=None,
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
        self.tenants = tenants
        self.batcher = DynamicBatcher(
            max_batch=max_batch, slo_ms=slo_ms, bucket_sizes=bucket_sizes,
            max_queue=max_queue, admission=admission,
            max_wait_ms=max_wait_ms, metrics=self.metrics, clock=clock,
            tenants=tenants)
        self.clock = clock
        self.forward_timeout_s = forward_timeout_s
        self.max_retries = int(max_retries)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.supervise_interval_s = float(supervise_interval_s)
        self.poison_isolation = bool(poison_isolation)
        self._chaos = chaos
        n = self._n_devices() if replicas in (-1, 0) else int(replicas)
        if n < 1:
            raise ValueError(f"replicas must be >=1 or -1, got {replicas}")
        self._inflight_per_replica = int(inflight_per_replica)
        self._replicas = [_Replica(i, self._device_of(i), inflight_per_replica)
                          for i in range(n)]
        self._devices = [r.device for r in self._replicas]
        self._vlock = threading.Lock()
        self._swap_lock = threading.Lock()
        # serializes what changes the set of (replica, version) graphs:
        # warming a version and installing it, births, retirements and
        # respawn re-warms, so a born replica never misses a version
        self._topology = threading.RLock()
        self._current = _ModelVersion(model, tag, self._devices)
        self._default_name: Optional[str] = name if registry is not None else None
        self._named: Dict[str, _ModelEntry] = {}
        self._canary: Optional[_CanaryState] = None
        self._canary_log: List[dict] = []
        self._warmed: set = set()       # the default model's (bucket, dtype_str) pairs
        self._example_shape: Optional[Tuple[int, ...]] = None
        self._warm_dtypes: Tuple[str, ...] = ("float32",)
        self._loaded = False
        self._shutdown = False
        self._autoscaler = None             # see enable_autoscale()
        self._autoscale_interval_s = 0.25
        self._last_autoscale_t: Optional[float] = None
        self._shed_seen = 0.0
        self.batch_log: List[dict] = []  # bounded; test/debug hook
        self._log_lock = threading.Lock()
        if registry is not None and name is not None:
            registry.subscribe(
                name, ref,
                lambda version, m: self.swap_model(m, tag=f"{name}:v{version}"),
                canary=lambda version, m, **kw: self.run_canary(
                    m, tag=f"{name}:v{version}", **kw))
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

    def _n_devices(self) -> int:
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def _device_of(self, idx: int) -> torch.device:
        if self.device.type == "cuda":
            return torch.device("cuda", idx % self._n_devices())
        return self.device

    # -- warm-up -------------------------------------------------------------

    @staticmethod
    def _infer_shape_of(model) -> Optional[Tuple[int, ...]]:
        conf = getattr(model, "conf", None)
        it = getattr(conf, "input_type", None)
        types = getattr(conf, "input_types", None) or {}
        if it is None and len(types) == 1:   # a one-input ComputationGraph
            it = next(iter(types.values()))
        if it is None:
            return None
        try:
            return tuple(it.batch_shape(1))[1:]
        except ValueError:  # variable-length recurrent input
            return None

    def _infer_example_shape(self) -> Optional[Tuple[int, ...]]:
        return self._infer_shape_of(self._current.model)

    def load(self, input_shape: Optional[Sequence[int]] = None,
             dtypes: Sequence[str] = ("float32",),
             quantize: Optional[str] = None, calibration_inputs=None,
             warm_bundle: Optional[str] = None) -> "Engine":
        """Warm-up: prepare every (bucket, dtype) pair on every replica
        (capture its graph on a card) so no request pays a capture.
        ``input_shape`` is the per-example shape, inferred from the
        model's configured InputType when omitted.  The warm-up times
        seed the batcher's per-bucket exec EMA.

        ``quantize="int8"`` serves the current model int8
        (``ops/quantize.py``): its Dense-style matmul weights quantized
        per output channel, activation scales calibrated on
        ``calibration_inputs`` (an array or a list of arrays of
        representative inputs; a seeded standard-normal batch when
        omitted), and the quantized forward captured.  ``warm_bundle``
        names a bundle (else the ``<checkpoint>.warm`` of a
        registry-loaded model); the quantized path reads none."""
        shape = tuple(input_shape) if input_shape is not None else (
            self._infer_example_shape())
        if shape is None:
            raise ValueError(
                "cannot infer the per-example input shape from the model's "
                "configuration — pass input_shape=(...) explicitly")
        self._example_shape = shape
        self._warm_dtypes = tuple(dtypes)
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unsupported quantize mode {quantize!r}; only 'int8'")
            from ..ops.quantize import quantize_model
            if calibration_inputs is None:
                rng = np.random.default_rng(0)
                calibration_inputs = rng.standard_normal(
                    (max(self.batcher.buckets),) + shape).astype(np.float32)
            qm = quantize_model(self._current.model, calibration_inputs)
            with self._vlock:
                old = self._current
                self._current = _ModelVersion(qm, old.tag + "+int8", self._devices)
            old.release()
        self._warm_version(self._current, warm_bundle=warm_bundle,
                           use_bundle=quantize is None)
        self._loaded = True
        return self

    def _load_bundle_for(self, v: _ModelVersion,
                         explicit_path: Optional[str] = None) -> dict:
        """The warm bundle of a version: an explicit path, else the
        ``<checkpoint>.warm`` beside a registry-loaded model's checkpoint;
        ``{}`` on any miss."""
        if not v.forwardable:
            return {}
        from . import warmcache
        path = explicit_path
        if path is None:
            ckpt = getattr(v.model, "_checkpoint_path", None)
            if ckpt:
                path = warmcache.bundle_path_for(ckpt)
        if not path:
            return {}
        return warmcache.load_bundle(path, device=self._devices[0])

    def _warm_version(self, v: _ModelVersion, warm_bundle: Optional[str] = None,
                      use_bundle: bool = True,
                      shape: Optional[Tuple[int, ...]] = None,
                      dtypes: Optional[Tuple[str, ...]] = None,
                      warmed: Optional[set] = None) -> None:
        """Prepare and run one version over every (bucket, dtype) pair on
        every replica, then time replica 0 once more for the EMA seed.
        With no overrides this warms the default model; ``add_model`` and
        a named swap pass their entry's shape, dtypes and warmed set."""
        shape = shape if shape is not None else self._example_shape
        dtypes = dtypes if dtypes is not None else self._warm_dtypes
        warmed = warmed if warmed is not None else self._warmed
        if shape is None:
            return
        v.shape = tuple(shape)
        bundle = self._load_bundle_for(v, warm_bundle) if use_bundle else {}
        with self._topology:
            v.ensure_replicas(self._devices)
            for dtype in dtypes:
                dts = str(np.dtype(dtype))
                for b in self.batcher.buckets:
                    x = np.zeros((b,) + v.shape, dtype=dtype)
                    t0 = self.clock()
                    if v.forwardable:
                        self.metrics.inc("bundle_hits" if _bundle_key(b, dts) in bundle
                                         else "bundle_misses")
                    with obs_trace.span("serve/warmup", cat="serve", bucket=b,
                                        dtype=dts, tag=v.tag):
                        for i in range(len(self._replicas)):
                            self._prepare(v, i, b, dts)
                            self._run_forward(v, i, x)
                    self.metrics.inc("warmup_seconds_total", self.clock() - t0)
                    t1 = self.clock()
                    self._run_forward(v, 0, x)
                    self.batcher.observe_exec_ms(b, (self.clock() - t1) * 1e3)
                    warmed.add((b, dts))

    def _prepare(self, v: _ModelVersion, idx: int, b: int, dts: str) -> None:
        """Capture the graph of one (replica, bucket, dtype), replacing
        (and releasing) any earlier one; on the CPU mark the pair warmed."""
        if not v.forwardable:
            return
        dev = self._devices[idx]
        g = None
        if dev.type == "cuda":
            from .cuda_graphs import ForwardGraph
            g = ForwardGraph(lambda x: v.fwd(idx, x), (b,) + v.shape,
                             torch.from_numpy(np.zeros(0, dts)).dtype, dev)
        with v.lock:
            old = v.programs.get((idx, b, dts))
            v.programs[(idx, b, dts)] = g
        if old is not None:
            old.release()

    def _live_versions(self) -> List[Tuple[_ModelVersion, set]]:
        """Every version a request can reach, with its warmed pairs: the
        default model's, each named model's and the canary's."""
        with self._vlock:
            out = [(self._current, set(self._warmed))]
            out += [(e.version, set(e.warmed)) for e in self._named.values()]
        can = self._canary
        if can is not None:
            out.append((can.version, set(self._warmed)))
        return out

    def _rewarm_replica(self, idx: int) -> None:
        """Warm one replica (respawned, or born by the autoscaler) for every
        live version: capture its graphs of every warmed pair afresh (new
        buffers and streams, so an abandoned incarnation still holding the
        old ones shares nothing with the new; the count of programs per
        replica is unchanged) and run each once, which doubles as a health
        probe."""
        with self._topology:
            for v, pairs in self._live_versions():
                if v.shape is None:
                    continue
                v.ensure_replicas(self._devices)
                for b, dts in sorted(pairs):
                    self._prepare(v, idx, b, dts)
                    self._run_forward(v, idx, np.zeros((b,) + v.shape, dtype=dts))

    def _version_of(self, model: Optional[str]) -> _ModelVersion:
        """The current version of the default model (None or its name) or
        of a placed named model; under ``_vlock``."""
        if model is None or model == self._default_name:
            return self._current
        entry = self._named.get(model)
        if entry is None:
            raise ModelNotLoadedError(f"model {model!r} is not placed on this host")
        return entry.version

    def compile_cache_size(self, model: Optional[str] = None) -> Optional[int]:
        """Prepared programs behind one model's forward (the default model
        unless ``model`` names a placed one; None for a duck-typed model):
        captured graphs on a card, warmed (replica, bucket, dtype) forwards
        on the CPU.  After ``load`` it must not grow while serving
        bucket-shaped requests, also across respawns and swaps; a replica
        born or retired by the autoscaler adds or drops its own share."""
        with self._vlock:
            v = self._version_of(model)
        return v.cache_size()

    def save_warmup_bundle(self, path: Optional[str] = None,
                           model: Optional[str] = None) -> str:
        """Write one model's warm bundle (``serving/warmcache.py``): the
        (bucket, dtype) pairs its graphs were captured for.  The default
        path is ``<checkpoint>.warm`` beside a registry-loaded model's
        checkpoint; a fresh engine passes it to ``load(warm_bundle=)`` (or
        finds it by that provenance)."""
        from . import warmcache
        with self._vlock:
            v = self._version_of(model)
        pairs = v.pairs() if v.forwardable else set()
        if not pairs:
            raise RuntimeError(
                "nothing to bundle — load() the engine first (a duck-typed model "
                "has no captured graphs)")
        if path is None:
            ckpt = getattr(v.model, "_checkpoint_path", None)
            if not ckpt:
                raise ValueError("model has no checkpoint provenance (not "
                                 "registry-loaded); pass path= explicitly")
            path = warmcache.bundle_path_for(ckpt)
        entries = {_bundle_key(b, dts): {"bucket": b, "dtype": dts,
                                         "shape": list(v.shape)}
                   for b, dts in pairs}
        return warmcache.save_bundle(path, v.tag, entries, device=self._devices[0])

    # -- request path --------------------------------------------------------

    def output(self, x, slo_ms: Optional[float] = None, model: Optional[str] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        """Submit one request (leading batch axis); blocks for the result."""
        return self.output_async(x, slo_ms=slo_ms, model=model, tenant=tenant).result()

    def output_async(self, x, slo_ms: Optional[float] = None,
                     model: Optional[str] = None,
                     tenant: Optional[str] = None) -> Future:
        """``model`` routes to a placed named model (None: the default
        model); ``tenant`` tags the request for fair-share scheduling and
        quotas.  An unplaced model fails the future with
        ``ModelNotLoadedError``."""
        if model is not None:
            with self._vlock:
                if model == self._default_name:
                    model = None
                elif model not in self._named:
                    f: Future = Future()
                    f.set_exception(ModelNotLoadedError(
                        f"model {model!r} is not placed on this host"))
                    return f
        return self.batcher.submit(np.asarray(x), slo_ms=slo_ms, tenant=tenant,
                                   model=model)

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
        the batch on shutdown.  The replica list is read afresh every
        round: the autoscaler grows and shrinks it."""
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
            if self._chaos is not None:
                kinds = self._chaos.pop_batch(replica.idx)
                if _CHAOS_CRASH in kinds:
                    # thread death with the batch in limbo: the supervisor
                    # detects it, retries or fails the batch, respawns
                    return
                if _CHAOS_HANG in kinds:
                    self._chaos.sleep_fn(self._chaos.hang_seconds)
                    with replica.lock:
                        if gen != replica.generation:
                            return      # abandoned by the supervisor mid-hang
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
        _FORWARD_MS.ms = None
        if not v.forwardable:
            out = v.model.output(xs)
            return _rows_of(out[0] if isinstance(out, list) else out, rows)
        g = None
        if xs.shape[1:] == v.shape:
            with v.lock:
                g = v.programs.get((idx, xs.shape[0], str(xs.dtype)))
        if g is not None:
            out = g(xs, rows)
            _FORWARD_MS.ms = g.last_ms
            return out
        from .cuda_graphs import rows_to_host
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(xs)).to(self._devices[idx])
            return rows_to_host(v.fwd(idx, x), rows)

    def _forward_padded(self, v: _ModelVersion, idx: int, reqs: List[_Request],
                        count_unwarmed: bool = True, warmed: Optional[set] = None):
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
        warm_set = self._warmed if warmed is None else warmed
        if (count_unwarmed and self._loaded
                and ((bucket, str(xs.dtype)) not in warm_set or xs.shape[1:] != v.shape)):
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
            obs_trace.complete_at("serve/queue_wait", r.t_submit, now,
                                  cat="serve", rows=r.rows)
        # a batch holds one model, so it reads one version snapshot
        model_name = live[0].model
        with self._vlock:
            if model_name is None:
                v, warmed = self._current, self._warmed
            else:
                entry = self._named.get(model_name)
                if entry is None:
                    err = ModelNotLoadedError(
                        f"model {model_name!r} was evicted from this host")
                    for r in live:
                        _fail_safe(r.future, err)
                    return
                entry.last_used = now
                v, warmed = entry.version, entry.warmed
            v.active += 1
        ex = _Execution(v)
        with replica.lock:
            replica.execution = ex
        t0 = self.clock()
        try:
            out, finite, rows, bucket, padded = self._forward_padded(
                v, replica.idx, live, warmed=warmed)
            device_ms = (self.clock() - t0) * 1e3
            replay_ms = _FORWARD_MS.ms
            obs_trace.complete_at("serve/forward", t0, self.clock(), cat="serve",
                                  replica=replica.idx, rows=rows, bucket=bucket,
                                  tag=v.tag)
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
            obs_trace.complete_at("serve/request", r.t_submit, done, cat="serve",
                                  rows=r.rows, retries=r.retries)
        obs_trace.complete_at("serve/batch", now, done, cat="serve",
                              replica=replica.idx, n_requests=len(live),
                              rows=rows, padded=padded, tag=v.tag)
        can = self._canary
        if can is not None and not can.done.is_set() and model_name is None:
            # a canary shadows the default model's traffic only
            self._mirror_canary(can, replica, live, out,
                                device_ms if replay_ms is None else replay_ms)

    def _log_batch(self, v: _ModelVersion, replica: _Replica, live: List[_Request],
                   rows: int, padded: int, poison: bool = False) -> None:
        """Append one executed batch to ``batch_log`` (bounded); ``poison``
        marks a batch whose output was non-finite and went to bisection."""
        with self._log_lock:
            self.batch_log.append({"tag": v.tag, "n_requests": len(live),
                                   "rows": rows, "padded": padded,
                                   "replica": replica.idx, "poison": poison,
                                   "model": live[0].model,
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
        obs_trace.instant("serve/retry", cat="serve", n_requests=len(retry),
                          failed_replica=failed_idx, error=type(error).__name__)
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
            candidates = [c for c in list(self._replicas) if self._dispatchable(c, now)]
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
            self._autoscale_tick(now)

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
        obs_trace.instant("serve/replica_crash" if crashed else "serve/replica_hang",
                          cat="serve", replica=r.idx,
                          in_flight=len(batch) if batch else 0)
        if opened:
            self.metrics.inc("circuit_opens")
            obs_trace.instant("serve/circuit_open", cat="serve", replica=r.idx)
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
            with obs_trace.span("serve/respawn", cat="serve", replica=r.idx):
                self._rewarm_replica(r.idx)
        except Exception as e:
            # the replica fails its next batch and re-enters the
            # supervisor; the breaker bounds the retries
            self.metrics.inc("respawn_failures")
            obs_trace.instant("serve/respawn_failed", cat="serve", replica=r.idx,
                              error=f"{type(e).__name__}: {e}")
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
        replicas = list(self._replicas)
        for r in replicas:
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
        elif n_healthy == len(replicas):
            status = "ok"
        else:
            status = "degraded"
        return {"status": status, "ready": status != "unready", "replicas": reps}

    # -- autoscaling -------------------------------------------------------------

    def enable_autoscale(self, autoscaler=None, *, min_replicas: Optional[int] = None,
                         max_replicas: Optional[int] = None,
                         interval_s: float = 0.25, **knobs) -> "Engine":
        """Arm load-driven replica autoscaling: the supervisor ticks a
        ``ReplicaAutoscaler`` every ``interval_s`` with the queue depth,
        the in-flight count and the shed counter's delta; +1 births a
        replica (its graphs captured before it is routable), -1 retires
        the last replica once it is idle.  Pass a built controller, or
        the knobs of the default one (``up_load`` / ``down_load`` /
        ``up_ticks`` / ``down_ticks`` / ``cooldown_s``)."""
        from .autoscale import ReplicaAutoscaler
        if autoscaler is None:
            n = len(self._replicas)
            autoscaler = ReplicaAutoscaler(
                min_replicas=n if min_replicas is None else int(min_replicas),
                max_replicas=n if max_replicas is None else int(max_replicas),
                clock=self.clock, **knobs)
        self._autoscale_interval_s = float(interval_s)
        self._shed_seen = self.metrics.counter_value("shed")
        self._autoscaler = autoscaler
        return self

    def _autoscale_tick(self, now: float) -> None:
        a = self._autoscaler
        if a is None or not self._loaded or self._shutdown:
            return
        if (self._last_autoscale_t is not None
                and now - self._last_autoscale_t < self._autoscale_interval_s):
            return
        self._last_autoscale_t = now
        shed = self.metrics.counter_value("shed")
        shed_delta = shed - self._shed_seen
        self._shed_seen = shed
        reps = list(self._replicas)
        inflight = 0
        for r in reps:
            inflight += r.queue.qsize()
            with r.lock:
                if r.busy_since is not None:
                    inflight += 1
        decision = a.observe(self.batcher.qsize(), inflight, len(reps),
                             shed_delta=int(shed_delta))
        if decision > 0:
            self._add_replica()
        elif decision < 0:
            self._retire_replica()

    def _add_replica(self) -> None:
        """Autoscale birth: a new replica on the next device.  Its copy of
        every live version's parameters is made and its graphs of every
        warmed pair are captured and run once before it joins the
        routable set, so no request reaches an uncaptured graph."""
        with self._topology:
            idx = len(self._replicas)
            r = _Replica(idx, self._device_of(idx), self._inflight_per_replica)
            with obs_trace.span("serve/scale_up", cat="serve", replica=idx):
                self._devices.append(r.device)
                try:
                    self._rewarm_replica(idx)
                except BaseException:
                    self._devices.pop()
                    for v, _ in self._live_versions():
                        v.release(idx)
                    raise
                self._start_replica_thread(r)
                self._replicas.append(r)
        self.metrics.inc("scale_ups")

    def _retire_replica(self) -> None:
        """Autoscale retirement: remove the last replica (indices stay
        dense for round-robin) once it is alive and idle (a busy one waits
        for the next tick), redispatch anything a racing dispatch parked
        behind its sentinel, then release its graphs."""
        with self._topology:
            if len(self._replicas) <= 1:
                return
            r = self._replicas[-1]
            with r.lock:
                alive = r.thread is not None and r.thread.is_alive()
                busy = r.busy_since is not None
            if not alive or busy or not r.queue.empty():
                return
            with obs_trace.span("serve/scale_down", cat="serve", replica=r.idx):
                # unroute first (the dispatcher reads the list each round),
                # then send the thread its sentinel
                self._replicas.pop()
                r.queue.put(_SENTINEL)
                if r.thread is not None:
                    r.thread.join(timeout=5.0)
                leftovers = []
                while True:
                    try:
                        item = r.queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _SENTINEL:
                        leftovers.append(item)
                for item in leftovers:
                    self._redispatch([q for q in item if not q.future.done()])
                self._devices.pop()
                for v, _ in self._live_versions():
                    v.release(r.idx)
        self.metrics.inc("scale_downs")

    # -- canary ------------------------------------------------------------------

    def _mirror_canary(self, can: _CanaryState, replica: _Replica,
                       reqs: List[_Request], incumbent_out: np.ndarray,
                       incumbent_ms: float) -> None:
        """Shadow one live batch to the canary version after the
        incumbent's results were delivered (a user never waits for the
        canary) and record the comparison.  A forward that replayed a CUDA
        graph is timed by the replay's device time, so a pause of the host
        (the interpreter's lock, a collection) cannot veto a candidate; an
        eager forward is timed by the wall clock."""
        with can.lock:
            if can.done.is_set() or not can.select():
                return
        with self._vlock:
            if can.version.retired:     # rolled back meanwhile
                return
            can.version.active += 1
        ex = _Execution(can.version)
        err = False
        div = None
        t0 = self.clock()
        try:
            out, finite, _, _, _ = self._forward_padded(can.version, replica.idx, reqs,
                                                        count_unwarmed=False)
            if not finite:
                err = True
            elif out.shape == incumbent_out.shape:
                div = float(np.mean(np.abs(out - incumbent_out)))
        except Exception:
            err = True
        finally:
            self._release(ex)
        ms = (self.clock() - t0) * 1e3
        if not err and _FORWARD_MS.ms is not None:
            ms = _FORWARD_MS.ms
        self.metrics.inc("canary_mirrored_batches")
        with can.lock:
            can.mirrored += 1
            can.canary_ms.append(ms)
            can.incumbent_ms.append(incumbent_ms)
            if err:
                can.canary_errors += 1
            if div is not None:
                can.divergences.append(div)
            if can.mirrored >= can.window:
                can.done.set()

    def run_canary(self, model, tag: Optional[str] = None, *, frac: float = 0.2,
                   window: int = 32, timeout_s: float = 60.0,
                   max_error_rate: float = 0.0, p99_factor: float = 3.0,
                   max_divergence: Optional[float] = None) -> dict:
        """Canary the incoming ``model`` against the incumbent: capture its
        graphs, mirror a deterministic ``frac`` of live batches to it as
        shadow traffic, compare error rate, p99 forward time and
        prediction divergence over ``window`` mirrored batches, then
        complete the hot-swap (promote) or roll back (its graphs released
        once its mirrors drained).  Blocks until the window fills or
        ``timeout_s`` passes (an unfilled window rolls back: an unjudged
        version is never promoted).  Returns the decision; usually driven
        by ``registry.set_alias(..., canary=)``."""
        if self._canary is not None:
            raise RuntimeError("a canary evaluation is already running")
        nv = _ModelVersion(model, tag or f"canary@{time.time():.0f}", self._devices)
        with self._topology:
            if self._loaded:
                self._warm_version(nv)
            can = _CanaryState(nv, frac, window)
            self._canary = can
        try:
            can.done.wait(timeout_s)
        finally:
            self._canary = None     # no more mirrors record into `can`
        with can.lock:
            mirrored = can.mirrored
            errors = can.canary_errors
            c_ms = list(can.canary_ms)
            i_ms = list(can.incumbent_ms)
            divs = list(can.divergences)
        err_rate = errors / mirrored if mirrored else None
        p99_c = float(np.percentile(c_ms, 99)) if c_ms else None
        p99_i = float(np.percentile(i_ms, 99)) if i_ms else None
        mean_div = float(np.mean(divs)) if divs else None
        reasons = []
        if mirrored < window:
            reasons.append(f"window incomplete ({mirrored}/{window} "
                           "mirrored batches before timeout)")
        if err_rate is not None and err_rate > max_error_rate:
            reasons.append(f"error rate {err_rate:.3f} > {max_error_rate}")
        # the 1 ms floor keeps clock noise on sub-ms forwards from vetoing
        # a healthy canary
        if (p99_c is not None and p99_i is not None
                and p99_c > p99_factor * max(p99_i, 1.0)):
            reasons.append(f"p99 {p99_c:.2f}ms > {p99_factor}x incumbent {p99_i:.2f}ms")
        if max_divergence is not None and mean_div is not None and mean_div > max_divergence:
            reasons.append(f"prediction divergence {mean_div:.4f} > {max_divergence}")
        promote = not reasons
        obs_trace.instant("serve/canary_decision", cat="serve", candidate=nv.tag,
                          promote=promote, reasons=list(reasons))
        decision = {
            "candidate": nv.tag, "incumbent": self.current_tag,
            "promote": promote, "reasons": reasons,
            "mirrored_batches": mirrored, "error_rate": err_rate,
            "canary_p99_ms": round(p99_c, 3) if p99_c is not None else None,
            "incumbent_p99_ms": round(p99_i, 3) if p99_i is not None else None,
            "mean_divergence": round(mean_div, 6) if mean_div is not None else None,
        }
        if promote:
            self._swap_version(nv)      # already warmed: nothing is captured
            self.metrics.inc("canary_promotions")
        else:
            self._drain_and_release(nv)
            self.metrics.inc("canary_rollbacks")
        with self._log_lock:
            self._canary_log.append(decision)
        return decision

    # -- hot swap ----------------------------------------------------------------

    def _drain_and_release(self, v: _ModelVersion, timeout: Optional[float] = None) -> None:
        """Retire ``v``, wait until no batch executes on it, drop its graphs."""
        with self._vlock:
            v.retired = True
            if v.active == 0:
                v.drained.set()
        v.drained.wait(timeout)
        v.release()

    def swap_model(self, model, tag: Optional[str] = None,
                   warm_bundle: Optional[str] = None, name: Optional[str] = None) -> str:
        """Atomic hot-swap: build and warm the new version (its graphs
        captured while the old one serves), flip the current pointer, then
        block until every batch on the old version has completed and drop
        its graphs.  ``name`` scopes the swap to one placed named model
        (None: the default model).  Returns the retired version's tag."""
        nv = _ModelVersion(model, tag or f"swap@{time.time():.0f}", self._devices)
        if name is None or name == self._default_name:
            return self._swap_version(nv, warm_bundle=warm_bundle, warm=True)
        with self._swap_lock:
            # warm and flip under one hold of _topology, so a replica born
            # meanwhile sees either the old version or the warmed new one
            with self._topology:
                with self._vlock:
                    entry = self._named.get(name)
                    if entry is None:
                        raise ModelNotLoadedError(
                            f"model {name!r} is not placed on this host")
                if self._loaded:
                    self._warm_version(nv, warm_bundle=warm_bundle,
                                       shape=entry.example_shape,
                                       dtypes=entry.warm_dtypes, warmed=entry.warmed)
                with self._vlock:
                    old = entry.version
                    entry.version = nv
            self._drain_and_release(old)
            self.metrics.inc("swaps")
            obs_trace.instant("serve/swap", cat="serve", incoming=nv.tag,
                              retired=old.tag, model=name)
            return old.tag

    def _swap_version(self, nv: _ModelVersion, warm_bundle: Optional[str] = None,
                      warm: bool = False) -> str:
        """Make ``nv`` the default model's version (warming it first when
        ``warm``), drain the old one and drop its graphs.  Lock order:
        ``_swap_lock``, ``_topology``, ``_vlock``."""
        with self._swap_lock:
            with self._topology:
                if warm and self._loaded:
                    self._warm_version(nv, warm_bundle=warm_bundle)
                with self._vlock:
                    old = self._current
                    self._current = nv
            self._drain_and_release(old)
            self.metrics.inc("swaps")
            obs_trace.instant("serve/swap", cat="serve", incoming=nv.tag,
                              retired=old.tag)
            return old.tag

    @property
    def current_tag(self) -> str:
        with self._vlock:
            return self._current.tag

    # -- named models --------------------------------------------------------------

    def add_model(self, name: str, model, *, input_shape: Optional[Sequence[int]] = None,
                  dtypes: Sequence[str] = ("float32",), warm_bundle: Optional[str] = None,
                  tag: Optional[str] = None) -> "Engine":
        """Place a named model beside the default one.  It is warmed
        (every graph captured, the warm bundle read) before it becomes
        routable; the other models keep serving meanwhile."""
        if not name:
            raise ValueError("model name must be non-empty")
        with self._vlock:
            if name == self._default_name or name in self._named:
                raise ValueError(f"model {name!r} is already placed")
        shape = (tuple(input_shape) if input_shape is not None
                 else self._infer_shape_of(model))
        if shape is None:
            raise ValueError(f"cannot infer the per-example input shape for {name!r} — "
                             "pass input_shape=(...) explicitly")
        v = _ModelVersion(model, tag or name, self._devices)
        entry = _ModelEntry(v, shape, tuple(dtypes))
        t0 = entry.last_used = self.clock()
        with self._topology:
            if self._loaded:
                self._warm_version(v, warm_bundle=warm_bundle, shape=shape,
                                   dtypes=entry.warm_dtypes, warmed=entry.warmed)
            else:
                v.shape = shape
            with self._vlock:
                if name == self._default_name or name in self._named:
                    v.release()
                    raise ValueError(f"model {name!r} is already placed")
                self._named[name] = entry
        self.metrics.inc("model_loads")
        obs_trace.instant("serve/model_load", cat="serve", model=name, tag=v.tag,
                          warm_ms=(self.clock() - t0) * 1e3)
        return self

    def add_model_from_registry(self, registry, name: str, ref: str = "prod", *,
                                input_shape: Optional[Sequence[int]] = None,
                                dtypes: Sequence[str] = ("float32",),
                                warm_bundle: Optional[str] = None,
                                subscribe: bool = False) -> "Engine":
        """``add_model`` of ``name@ref`` from a registry, tagged
        ``name:vN``; ``subscribe=True`` also turns the alias's moves into
        swaps of this named model."""
        version, model = registry.resolve(name, ref)
        self.add_model(name, model, input_shape=input_shape, dtypes=dtypes,
                       warm_bundle=warm_bundle, tag=f"{name}:v{version}")
        if subscribe:
            registry.subscribe(
                name, ref,
                lambda ver, m: self.swap_model(m, tag=f"{name}:v{ver}", name=name))
        return self

    def remove_model(self, name: str, timeout: float = 30.0) -> bool:
        """Evict a named model: unroute it (its later requests fail with
        ``ModelNotLoadedError``), wait for its batches in flight to
        complete, drop its graphs.  False if it was not placed.  The
        default model cannot be evicted (``begin_drain`` retires a whole
        engine)."""
        if name == self._default_name:
            raise ValueError(f"model {name!r} is this engine's default model and "
                             "cannot be evicted; drain the host instead")
        with self._vlock:
            entry = self._named.pop(name, None)
        if entry is None:
            return False
        self._drain_and_release(entry.version, timeout)
        self.metrics.inc("model_evictions")
        obs_trace.instant("serve/model_evict", cat="serve", model=name,
                          tag=entry.version.tag)
        return True

    def has_model(self, name: Optional[str]) -> bool:
        """True when this engine places ``name`` (None and the default
        model's name always)."""
        if name is None:
            return True
        with self._vlock:
            return name == self._default_name or name in self._named

    def placed_models(self) -> Dict[str, str]:
        """name → current version tag of every placed model (the default
        model under its registry name, or "" for a bare model)."""
        with self._vlock:
            out = {self._default_name if self._default_name is not None else "":
                   self._current.tag}
            for name, e in self._named.items():
                out[name] = e.version.tag
            return out

    def model_last_used(self, name: str) -> Optional[float]:
        """Engine-clock time of the last batch of a named model (None:
        never, or not placed)."""
        with self._vlock:
            e = self._named.get(name)
            return e.last_used if e is not None else None

    # -- lifecycle ---------------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["model"] = self.current_tag
        snap["models"] = self.placed_models()
        if self.tenants is not None:
            snap["tenants"] = self.tenants.snapshot()
        snap["replicas"] = len(self._replicas)
        snap["queue_depth"] = self.batcher.qsize()
        snap["buckets"] = list(self.batcher.buckets)
        snap["compile_cache_size"] = self.compile_cache_size()
        snap["health"] = self.health_snapshot()
        snap["device"] = str(self.device)
        with self._log_lock:
            snap["canary_decisions"] = list(self._canary_log[-8:])
        return snap

    def begin_drain(self) -> None:
        """Stop admission (every later submission sheds with
        ``OverloadedError``, HTTP 429) while queued and in-flight batches
        complete; call ``shutdown()`` once the queue is empty."""
        self.batcher.begin_drain()
        self.metrics.inc("drains")
        obs_trace.instant("serve/drain", cat="serve")

    def shutdown(self, timeout: float = 5.0) -> None:
        """Every request (queued, in a replica queue, or submitted
        concurrently with this call) resolves, with a result or the
        shut-down error; the graphs are released."""
        if self._shutdown:
            return
        self._shutdown = True
        self.batcher.close(fail_pending=True)
        self._dispatcher.join(timeout=timeout)
        for r in list(self._replicas):
            if r.thread:
                r.thread.join(timeout=timeout)
        if self._supervisor:
            self._supervisor.join(timeout=timeout)
        for r in list(self._replicas):
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
        for v, _ in self._live_versions():
            if v.active == 0:
                v.release()
