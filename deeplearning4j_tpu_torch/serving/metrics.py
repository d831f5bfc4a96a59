"""Serving metrics on the unified registry (mirrors ``ServingMetrics``,
``DecodeMetrics`` and ``LatencyHistogram`` of
``deeplearning4j_tpu/serving/metrics.py``).

A ``ServingMetrics`` belongs to one predict ``Engine`` and a
``DecodeMetrics`` to one ``DecodeEngine``.  Each exports three ways: the
plain ``snapshot()`` dict (the API and test surface), its own
``registry`` of typed instruments, and the process-wide
``obs.metrics.get_registry()``, where it registers itself as a collector,
so one registry snapshot (``UIServer`` /metrics) carries every live
engine.

The latency histograms are the fixed-bucket ``obs.metrics.Histogram``
(0.1 ms to 10 s in exponential steps): percentiles interpolate inside
the winning bucket, and a snapshot carries ``buckets_ms`` and ``counts``
so snapshots merge across engines.  A counter no key list names appears
when first incremented; ``inc(..., tenant=)`` also counts the tenant's
label slice.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Sequence

from ..obs.metrics import (DEFAULT_LATENCY_BUCKETS_MS, Histogram, MetricsRegistry,
                           get_registry)

DEFAULT_BUCKETS_MS: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS

# every counter a fresh decode engine reports, at zero: the feature
# counters (prefix cache, speculation, fused horizon, chunked prefill)
# stay registered when their feature is off, so no key appears mid-flight
_DECODE_COUNTER_KEYS = (
    "requests", "tokens_out", "prefills", "decode_steps",
    "eos_stops", "max_token_stops", "deadline_stops",
    "shed", "deadline_missed", "errors", "retries", "poison_isolated",
    "replica_crashes", "replica_respawns",
    "prefix_hits", "prefix_misses", "prefix_inserts",
    "prefix_evictions", "prefix_hit_tokens",
    "spec_steps", "spec_proposed", "spec_accepted", "spec_committed",
    "fused_dispatches", "tokens_per_dispatch",
    "chunked_prefills", "prefill_chunks",
)

_DECODE_GAUGES = ("active_slots", "pages_in_use", "shared_pages", "free_pages",
                  "free_slots")

# every counter a fresh predict engine reports, at zero: batching and
# admission, then resilience and canary, then warm-up, autoscale and
# placement
_COUNTER_KEYS = (
    "requests", "rows", "batches", "padded_rows",
    "shed", "deadline_missed", "errors", "swaps", "unwarmed_serves",
    "replica_crashes", "replica_hangs", "replica_respawns",
    "respawn_failures", "retries", "poison_isolated", "circuit_opens",
    "canary_promotions", "canary_rollbacks", "canary_mirrored_batches",
    "warmup_seconds_total", "bundle_hits", "bundle_misses",
    "scale_ups", "scale_downs",
    "model_loads", "model_evictions",
)


class LatencyHistogram(Histogram):
    """The fixed-bucket histogram with the serving surface: ``record(ms)``,
    ``count`` / ``sum_ms`` / ``max_ms``, and the ``*_ms``-keyed
    ``snapshot()`` (rounded to 3 decimals; ``max_ms`` 0.0 when empty)."""

    def __init__(self, buckets_ms: Sequence[float] = DEFAULT_BUCKETS_MS,
                 name: str = "latency_ms"):
        super().__init__(name, buckets_ms)

    def _unlabeled(self):
        with self._lock:
            return self._series.get(())

    @property
    def count(self) -> int:
        s = self._unlabeled()
        return s.count if s else 0

    @property
    def sum_ms(self) -> float:
        s = self._unlabeled()
        return s.total if s else 0.0

    @property
    def max_ms(self) -> float:
        s = self._unlabeled()
        return s.max_value if s else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            s = self._series.get(())
            counts = list(s.counts) if s else [0] * (len(self.bounds) + 1)
            count = s.count if s else 0
            total = s.total if s else 0.0
            mx = s.max_value if s else 0.0
        out = {"count": count, "sum_ms": round(total, 3),
               "max_ms": round(mx, 3),
               "mean_ms": round(total / count, 3) if count else None,
               "buckets_ms": list(self.bounds), "counts": counts}
        for p in (50, 90, 99):
            v = self.percentile(p)
            out[f"p{p}_ms"] = round(v, 3) if v is not None else None
        return out


class _Counters:
    """The counter set shared by both metric sets: typed counters in the
    per-engine registry, open key set, tenant label slices."""

    def _init_counters(self, keys) -> None:
        self._counters = {k: self.registry.counter(k) for k in keys}
        self._lock = threading.Lock()

    def inc(self, key: str, n: float = 1, tenant: str = None) -> None:
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.get(key)
                if c is None:
                    c = self._counters[key] = self.registry.counter(key)
        c.inc(n)
        if tenant:
            c.inc(n, tenant=tenant)

    def counter_value(self, key: str, tenant: str = None) -> float:
        """One counter's value (0.0 if never incremented); with
        ``tenant``, that tenant's label slice."""
        c = self._counters.get(key)
        if c is None:
            return 0.0
        return float(c.value(tenant=tenant) if tenant else c.value())

    def _counter_snapshot(self) -> Dict[str, float]:
        out = {}
        for k, counter in list(self._counters.items()):
            v = counter.value()
            out[k] = int(v) if float(v).is_integer() else v
        return out


class DecodeMetrics(_Counters):
    """Per-decode-engine metric set: TTFT, TPOT and per-step time
    histograms, throughput/stop/error counters, pool-occupancy gauges."""

    def __init__(self, buckets_ms: Sequence[float] = DEFAULT_BUCKETS_MS,
                 registry: MetricsRegistry = None):
        self.registry = registry or MetricsRegistry()
        self.ttft = self.registry.register(LatencyHistogram(buckets_ms, name="ttft_ms"))
        self.tpot = self.registry.register(LatencyHistogram(buckets_ms, name="tpot_ms"))
        self.step_time = self.registry.register(
            LatencyHistogram(buckets_ms, name="decode_step_ms"))
        self._init_counters(_DECODE_COUNTER_KEYS)
        self._gauges = {k: self.registry.gauge(k) for k in _DECODE_GAUGES}
        for g in self._gauges.values():
            g.set(0)
        self._t0 = time.monotonic()
        self.global_name = get_registry().register_collector(
            "decode", self.snapshot, unique=True)

    def set_gauge(self, key: str, value: int) -> None:
        self._gauges[key].set(int(value))

    def gauge(self, key: str) -> int:
        return int(self._gauges[key].value())

    def counter(self, key: str) -> float:
        return self.counter_value(key)

    def snapshot(self) -> dict:
        c = self._counter_snapshot()
        elapsed = time.monotonic() - self._t0
        return {
            "counters": c,
            **{k: self.gauge(k) for k in _DECODE_GAUGES},
            "accepted_tokens_per_step": (c["spec_committed"] / c["spec_steps"]
                                         if c["spec_steps"] else None),
            "tokens_per_sec": c["tokens_out"] / elapsed if elapsed > 0 else None,
            "uptime_sec": elapsed,
            "ttft_ms": self.ttft.snapshot(),
            "tpot_ms": self.tpot.snapshot(),
            "decode_step_ms": self.step_time.snapshot(),
        }


class ServingMetrics(_Counters):
    """Per-predict-engine metric set: queue-wait, device-time and
    end-to-end latency histograms, the batching/admission/resilience
    counters, and the largest batch seen.  Batch occupancy,
    ``rows / (rows + padded_rows)``, is the padding waste."""

    def __init__(self, buckets_ms: Sequence[float] = DEFAULT_BUCKETS_MS,
                 registry: MetricsRegistry = None):
        self.registry = registry or MetricsRegistry()
        self.queue_wait = self.registry.register(
            LatencyHistogram(buckets_ms, name="queue_wait_ms"))
        self.device_time = self.registry.register(
            LatencyHistogram(buckets_ms, name="device_time_ms"))
        self.e2e = self.registry.register(LatencyHistogram(buckets_ms, name="e2e_ms"))
        self._init_counters(_COUNTER_KEYS)
        self._batch_rows_max = 0
        self._rows_max_gauge = self.registry.gauge("max_batch_rows")
        self._rows_max_gauge.set(0)
        self._t0 = time.monotonic()
        self.global_name = get_registry().register_collector(
            "serving", self.snapshot, unique=True)

    def record_batch(self, n_requests: int, rows: int, padded_rows: int,
                     device_ms: float) -> None:
        self._counters["batches"].inc()
        self._counters["requests"].inc(n_requests)
        self._counters["rows"].inc(rows)
        self._counters["padded_rows"].inc(padded_rows)
        with self._lock:
            if rows > self._batch_rows_max:
                self._batch_rows_max = rows
                self._rows_max_gauge.set(rows)
        self.device_time.record(device_ms)

    def snapshot(self) -> dict:
        c = self._counter_snapshot()
        with self._lock:
            rows_max = self._batch_rows_max
        elapsed = time.monotonic() - self._t0
        total = c["rows"] + c["padded_rows"]
        return {
            "counters": c,
            "max_batch_rows": rows_max,
            "batch_occupancy": round(c["rows"] / total, 4) if total else None,
            "requests_per_sec": (round(c["requests"] / elapsed, 2)
                                 if elapsed > 0 else None),
            "uptime_sec": round(elapsed, 3),
            "queue_wait_ms": self.queue_wait.snapshot(),
            "device_time_ms": self.device_time.snapshot(),
            "e2e_ms": self.e2e.snapshot(),
        }
