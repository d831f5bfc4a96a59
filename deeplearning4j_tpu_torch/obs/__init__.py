"""Observability: span tracing and one metrics registry (copies of
``deeplearning4j_tpu/obs``, pure Python).

- :mod:`~.trace`: a thread-safe span recorder (bounded ring buffer,
  monotonic clocks) with a Chrome trace-event JSON export and
  ``merge_traces``, which stitches the launcher's per-worker files into
  one pod timeline.  Tracing is off by default; the disabled path is one
  global read.
- :mod:`~.metrics`: a typed ``MetricsRegistry`` (counters, gauges,
  fixed-bucket histograms, labeled) with the reference's snapshot
  schema; the elastic trainer's recovery counters and the launcher's
  membership stats surface through it.

The snapshot dict and the trace JSON are the reference's, so files and
snapshots from both packages merge into one view.
"""

from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
    merge_snapshots,
)
from .trace import (
    TraceRecorder, disable_tracing, enable_tracing, get_recorder, instant,
    merge_traces, span, span_tree, tracing_enabled, traced,
    validate_chrome_trace,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "TraceRecorder",
    "disable_tracing", "enable_tracing", "get_recorder", "get_registry",
    "instant", "merge_snapshots", "merge_traces", "span", "span_tree",
    "traced", "tracing_enabled", "validate_chrome_trace",
]
