"""One metrics registry: typed counters / gauges / fixed-bucket histograms
(a copy of ``deeplearning4j_tpu/obs/metrics.py``, with its snapshot
schema, so ``merge_snapshots`` aggregates either package's snapshots).

Every subsystem used to carry its own counter dict with its own schema
(`serving/metrics.py`, ElasticTrainer's recovery attributes, prefetch
stall stats, launcher membership stats) — none of them composable into
one "what is this process doing" answer.  :class:`MetricsRegistry` is
that answer:

- **Typed instruments.**  ``counter()`` (monotonic, float-friendly),
  ``gauge()`` (set/callback), ``histogram()`` (fixed boundaries — O(k)
  record, tiny lock hold, mergeable across processes; the same design
  the serving latency histograms already proved out).  All instruments
  take optional labels (``c.inc(1, replica=0)``) rendered as
  ``name{replica=0}`` series keys in the snapshot.
- **Collectors.**  Components that already own structured state
  (a `ServingMetrics`, the live prefetch iterators, a PodLauncher)
  register a zero-arg callable; its dict is embedded under
  ``snapshot()["collected"][name]``.  Bound methods are held via
  weakref so a dropped engine unregisters itself.
- **One snapshot schema.**  ``{"counters": {series: value}, "gauges":
  {...}, "histograms": {series: {...}}, "collected": {...}}`` — what
  ``UIServer /metrics`` serves and what :func:`merge_snapshots`
  aggregates into the launcher's pod-level view (counters sum,
  histogram buckets add, gauges keep min/mean/max across workers).

A process-global default registry (:func:`get_registry`) is the shared
surface; tests needing isolation construct their own instances.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    """Monotonic counter (per label-set series)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {_series(self.name, k): v
                    for k, v in sorted(self._values.items())} \
                or {self.name: 0}


class Gauge:
    """Point-in-time value: ``set()`` it, or ``set_fn()`` a callback read
    at snapshot time (how launcher epoch / queue depths export)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[_LabelKey, float] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            if self._fn is not None and not labels:
                try:
                    return float(self._fn())
                except Exception:
                    return None
            return self._values.get(_label_key(labels))

    def snapshot(self) -> Dict[str, Optional[float]]:
        with self._lock:
            vals = dict(self._values)
            fn = self._fn
        out = {_series(self.name, k): v for k, v in sorted(vals.items())}
        if fn is not None:
            try:
                out[self.name] = float(fn())
            except Exception:
                out[self.name] = None
        return out or {self.name: None}


# 0.1ms .. 10s in exponential steps — the serving default, reused
# anywhere latencies are recorded; +inf overflow bucket is implicit
DEFAULT_LATENCY_BUCKETS_MS: Sequence[float] = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
    200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0,
)


class Histogram:
    """Fixed-boundary histogram (thread-safe, one series per label-set).

    Fixed buckets, not reservoirs: O(#buckets) record, tiny lock-held
    time, and snapshots merge across engines/processes by adding
    counts — the properties a hot path and a pod aggregator both need.
    Percentiles interpolate linearly inside the winning bucket, so p99
    on ~17 buckets is approximate by design; exact needs read ``count``
    / ``sum`` or time externally.
    """

    class _Series:
        __slots__ = ("counts", "count", "total", "max_value")

        def __init__(self, n_buckets: int):
            self.counts = [0] * (n_buckets + 1)   # +1 = overflow
            self.count = 0
            self.total = 0.0
            self.max_value = 0.0

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        self.name = name
        self.bounds = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._series: Dict[_LabelKey, Histogram._Series] = {}

    def _get(self, key: _LabelKey) -> "Histogram._Series":
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = Histogram._Series(len(self.bounds))
        return s

    def record(self, value: float, **labels) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if value <= b:
                break
        else:
            i = len(self.bounds)
        key = _label_key(labels)
        with self._lock:
            s = self._get(key)
            s.counts[i] += 1
            s.count += 1
            s.total += value
            if value > s.max_value:
                s.max_value = value

    def percentile(self, p: float, **labels) -> Optional[float]:
        """Approximate p-th percentile (0 < p <= 100); None when empty.
        Overflow hits report the max seen (no boundary to interpolate
        against)."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or not s.count:
                return None
            counts = list(s.counts)
            count, mx = s.count, s.max_value
        rank = p / 100.0 * count
        seen = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= rank:
                if i >= len(self.bounds):
                    return mx
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * ((rank - seen) / c)
            seen += c
        return mx

    def _series_snapshot(self, s: "Histogram._Series",
                         key: _LabelKey) -> dict:
        out = {"count": s.count, "sum": round(s.total, 3),
               "max": round(s.max_value, 3),
               "mean": round(s.total / s.count, 3) if s.count else None,
               "buckets": list(self.bounds), "counts": list(s.counts)}
        return out

    def series_snapshot(self) -> Dict[str, dict]:
        """{series key: stats} — the registry-facing schema (subclasses
        may override ``snapshot()`` with a legacy shape; the registry
        always reads this one)."""
        with self._lock:
            items = list(self._series.items())
        out = {}
        for key, s in sorted(items, key=lambda kv: kv[0]):
            snap = self._series_snapshot(s, key)
            for p in (50, 90, 99):
                v = self.percentile(p, **dict(key))
                snap[f"p{p}"] = round(v, 3) if v is not None else None
            out[_series(self.name, key)] = snap
        return out

    def snapshot(self) -> Dict[str, dict]:
        return self.series_snapshot()


class MetricsRegistry:
    """Named instruments + collectors with one snapshot schema."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, object] = {}
        self._seq = 0

    # -- instruments (get-or-create, idempotent) ---------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._check_free(name, self._counters)
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._check_free(name, self._gauges)
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                self._check_free(name, self._histograms)
                h = self._histograms[name] = Histogram(name, buckets)
            elif tuple(sorted(buckets)) != h.bounds:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{h.bounds}")
            return h

    def register(self, instrument):
        """Adopt an already-constructed instrument (e.g. a subclassed
        histogram) under its own name; returns it."""
        if isinstance(instrument, Counter):
            d = self._counters
        elif isinstance(instrument, Gauge):
            d = self._gauges
        elif isinstance(instrument, Histogram):
            d = self._histograms
        else:
            raise TypeError(f"not an instrument: {type(instrument).__name__}")
        with self._lock:
            self._check_free(instrument.name, d)
            if instrument.name in d:
                raise ValueError(f"{instrument.name!r} already registered")
            d[instrument.name] = instrument
        return instrument

    def _check_free(self, name: str, own: dict) -> None:
        for kind, d in (("counter", self._counters),
                        ("gauge", self._gauges),
                        ("histogram", self._histograms)):
            if d is not own and name in d:
                raise ValueError(f"{name!r} already registered as a {kind}")

    # -- collectors --------------------------------------------------------

    def register_collector(self, name: str, fn: Callable[[], object],
                           unique: bool = False) -> str:
        """Embed ``fn()``'s JSON-able result under
        ``snapshot()["collected"][name]``.  Bound methods are held via
        ``weakref.WeakMethod`` — when the owner dies the collector
        disappears (no unregister bookkeeping on engine teardown).
        ``unique=True`` suffixes the name with a registry-wide sequence
        number (per-instance collectors like serving engines).  Returns
        the registered name."""
        ref: object
        try:
            ref = weakref.WeakMethod(fn)       # bound method
        except TypeError:
            ref = fn                           # plain function: strong ref
        with self._lock:
            if unique:
                name = f"{name}#{self._seq}"
                self._seq += 1
            self._collectors[name] = ref
        return name

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histos = list(self._histograms.values())
            collectors = list(self._collectors.items())
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "collected": {}}
        for c in counters:
            out["counters"].update(c.snapshot())
        for g in gauges:
            out["gauges"].update(g.snapshot())
        for h in histos:
            out["histograms"].update(h.series_snapshot())
        dead = []
        for name, ref in collectors:
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(name)
                continue
            try:
                out["collected"][name] = fn()
            except Exception as e:   # a broken collector must not take
                out["collected"][name] = {"error": repr(e)}  # /metrics down
        if dead:
            with self._lock:
                for name in dead:
                    self._collectors.pop(name, None)
        return out

    def reset(self) -> None:
        """Drop every instrument and collector (test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._collectors.clear()


def merge_snapshots(snaps: List[dict]) -> dict:
    """Aggregate N ``MetricsRegistry.snapshot()`` dicts (one per worker)
    into a pod-level view: counters sum, histogram bucket counts add
    (series with matching boundaries), gauges keep min/mean/max across
    the workers that exported them.  ``collected`` blocks are kept
    per-source (they are component-shaped, not mergeable)."""
    out: dict = {"sources": len(snaps), "counters": {}, "gauges": {},
                 "histograms": {}, "collected": []}
    gauge_vals: Dict[str, List[float]] = {}
    for snap in snaps:
        for k, v in (snap.get("counters") or {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + (v or 0)
        for k, v in (snap.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauge_vals.setdefault(k, []).append(float(v))
        for k, h in (snap.get("histograms") or {}).items():
            if not isinstance(h, dict):
                continue
            agg = out["histograms"].get(k)
            if agg is None:
                agg = out["histograms"][k] = {
                    "count": 0, "sum": 0.0, "max": 0.0,
                    "buckets": list(h.get("buckets", [])),
                    "counts": [0] * len(h.get("counts", []))}
            if agg["buckets"] != list(h.get("buckets", [])):
                continue   # foreign boundaries — cannot add counts
            agg["count"] += h.get("count", 0)
            agg["sum"] = round(agg["sum"] + (h.get("sum") or 0.0), 3)
            agg["max"] = max(agg["max"], h.get("max") or 0.0)
            counts = h.get("counts", [])
            if len(counts) == len(agg["counts"]):
                agg["counts"] = [a + b for a, b in zip(agg["counts"], counts)]
        if snap.get("collected"):
            out["collected"].append(snap["collected"])
    for k, vals in gauge_vals.items():
        out["gauges"][k] = {"min": min(vals), "max": max(vals),
                            "mean": round(sum(vals) / len(vals), 6),
                            "n": len(vals)}
    for h in out["histograms"].values():
        h["mean"] = round(h["sum"] / h["count"], 3) if h["count"] else None
    return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry — the one ``UIServer
    /metrics`` serves and the launcher's per-worker exports snapshot."""
    return _REGISTRY
