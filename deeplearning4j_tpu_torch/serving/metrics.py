"""Serving metrics (mirrors ``ServingMetrics`` and ``DecodeMetrics`` of
``deeplearning4j_tpu/serving/metrics.py``; self-contained, without the
reference's process-wide registry, which comes with ``obs/``).

The predict engine's latencies are queue wait, device time and
end-to-end; the decode engine's are TTFT and time-per-output-token.  The
histograms keep their samples (bounded), so percentiles are exact rather
than bucket-interpolated.  Counters and gauges share one lock per
metric set; a counter no key list names appears when first incremented.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

import numpy as np

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


# every counter a fresh predict engine reports, at zero: batching and
# admission, then resilience, then warm-up
_COUNTER_KEYS = (
    "requests", "rows", "batches", "padded_rows",
    "shed", "deadline_missed", "errors", "swaps", "unwarmed_serves",
    "replica_crashes", "replica_hangs", "replica_respawns",
    "respawn_failures", "retries", "poison_isolated", "circuit_opens",
    "warmup_seconds_total",
)


class LatencyHistogram:
    """Millisecond samples (the newest ``max_samples``) with exact
    percentiles."""

    def __init__(self, max_samples: int = 100_000):
        self._lock = threading.Lock()
        self._samples = deque(maxlen=max_samples)
        self.count = 0
        self.sum_ms = 0.0

    def record(self, ms: float) -> None:
        with self._lock:
            self._samples.append(float(ms))
            self.count += 1
            self.sum_ms += float(ms)

    def snapshot(self) -> dict:
        with self._lock:
            xs = np.fromiter(self._samples, float)
            count, total = self.count, self.sum_ms
        out = {"count": count, "sum_ms": total,
               "mean_ms": total / count if count else None,
               "max_ms": float(xs.max()) if xs.size else None}
        for p in (50, 90, 99):
            out[f"p{p}_ms"] = float(np.percentile(xs, p)) if xs.size else None
        return out


class DecodeMetrics:
    """Per-decode-engine metric set: TTFT, TPOT and per-step time
    histograms, throughput/stop/error counters, pool-occupancy gauges."""

    def __init__(self):
        self.ttft = LatencyHistogram()
        self.tpot = LatencyHistogram()
        self.step_time = LatencyHistogram()
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {k: 0 for k in _DECODE_COUNTER_KEYS}
        self._gauges: Dict[str, int] = {"active_slots": 0, "pages_in_use": 0,
                                        "shared_pages": 0, "free_pages": 0,
                                        "free_slots": 0}
        self._t0 = time.monotonic()

    def inc(self, key: str, n: float = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set_gauge(self, key: str, value: int) -> None:
        with self._lock:
            self._gauges[key] = int(value)

    def counter(self, key: str) -> float:
        with self._lock:
            return self._counters.get(key, 0)

    def gauge(self, key: str) -> int:
        with self._lock:
            return self._gauges[key]

    def snapshot(self) -> dict:
        with self._lock:
            c = dict(self._counters)
            g = dict(self._gauges)
        elapsed = time.monotonic() - self._t0
        return {
            "counters": c,
            **g,
            "accepted_tokens_per_step": (c["spec_committed"] / c["spec_steps"]
                                         if c["spec_steps"] else None),
            "tokens_per_sec": c["tokens_out"] / elapsed if elapsed > 0 else None,
            "uptime_sec": elapsed,
            "ttft_ms": self.ttft.snapshot(),
            "tpot_ms": self.tpot.snapshot(),
            "decode_step_ms": self.step_time.snapshot(),
        }


class ServingMetrics:
    """Per-predict-engine metric set: queue-wait, device-time and
    end-to-end latency histograms, the batching/admission/resilience
    counters, and the largest batch seen.  Batch occupancy,
    ``rows / (rows + padded_rows)``, is the padding waste."""

    def __init__(self):
        self.queue_wait = LatencyHistogram()
        self.device_time = LatencyHistogram()
        self.e2e = LatencyHistogram()
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {k: 0 for k in _COUNTER_KEYS}
        self._batch_rows_max = 0
        self._t0 = time.monotonic()

    def inc(self, key: str, n: float = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def record_batch(self, n_requests: int, rows: int, padded_rows: int,
                     device_ms: float) -> None:
        with self._lock:
            c = self._counters
            c["batches"] += 1
            c["requests"] += n_requests
            c["rows"] += rows
            c["padded_rows"] += padded_rows
            self._batch_rows_max = max(self._batch_rows_max, rows)
        self.device_time.record(device_ms)

    def snapshot(self) -> dict:
        with self._lock:
            c = {k: int(v) if float(v).is_integer() else v
                 for k, v in self._counters.items()}
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
