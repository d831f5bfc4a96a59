"""Span tracing: bounded ring buffer -> Chrome trace events -> pod merge
(a copy of ``deeplearning4j_tpu/obs/trace.py``: the event schema is the
reference's, so a pod timeline merges files written by either package).

One :class:`TraceRecorder` per process records *complete spans* (name +
start + duration), *instant events* (faults, recoveries, canary
decisions, membership epochs), and nothing else — the two event shapes
Chrome's trace-event format needs to render a timeline.  Design
constraints, in order:

1. **Low overhead when off.**  Tracing is opt-in (``enable_tracing`` /
   CLI ``--trace``).  The module-level ``span()``/``instant()`` helpers
   the hot paths call do ONE global read when disabled and return a
   shared no-op context manager — no allocation, no lock, no clock
   read.  Instrumented code is bit-identical with tracing off.
2. **Low overhead when on.**  Recording is two monotonic clock reads
   plus one dict build plus one deque append under a lock; the ring
   buffer is bounded (oldest events evicted, eviction counted) so a
   week-long run cannot OOM the host.
3. **Mergeable across processes.**  Events are stamped on a wall-clock
   base (``time.time()`` anchor + monotonic deltas), each process gets
   its own Chrome ``pid`` track (the launcher's worker index where
   available), and :func:`merge_traces` stitches N per-worker files —
   including multiple incarnations of a relaunched worker — into one
   pod timeline that shows a ``proc_kill`` instant on one track
   followed by the relaunched incarnation's resume/recovery spans.

Export is the Chrome trace-event JSON object format
(``{"traceEvents": [...]}``): load it in chrome://tracing or
https://ui.perfetto.dev.  ``validate_chrome_trace`` is the schema check
tests and the A/B gate run against the export.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from functools import wraps
from typing import Any, Callable, Dict, Iterable, List, Optional

# the launcher's per-worker env contract (parallel/distributed.py defines
# the same literals; obs imports nothing of the rest of the package)
_ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"
_ENV_INCARNATION = "DL4J_TPU_INCARNATION"

DEFAULT_CAPACITY = 65536


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled —
    also what ``span()`` hands back so callers can unconditionally call
    ``.set(...)``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span: records a complete ("X") event when the context
    exits.  ``set(**args)`` attaches arguments discovered mid-span."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Optional[dict]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> "_Span":
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        self._rec.complete_at(self.name, self._t0, self._rec.clock(),
                              cat=self.cat,
                              **(self.args or {}))
        return False


class TraceRecorder:
    """Thread-safe bounded ring buffer of Chrome trace events.

    ``clock`` is the monotonic span clock (``time.monotonic`` — the same
    clock the serving engine/batcher stamp requests with, so their
    timestamps can be replayed into post-hoc spans via
    :meth:`complete_at`).  Exported timestamps ride a wall-clock anchor
    captured at construction, so traces from different processes share a
    time base and merge without negotiation.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: Optional[str] = None,
                 process_id: Optional[int] = None,
                 process_name: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = max(1, int(capacity))
        self.path = path
        self.clock = clock
        self._t0_mono = clock()
        # the one wall read: it lets per-process monotonic timelines merge
        self._t0_wall = time.time()
        if process_id is None:
            process_id = _env_int(_ENV_PROCESS_ID, 0)
        self.process_id = int(process_id)
        inc = _env_int(_ENV_INCARNATION, 0)
        self.process_name = process_name or (
            f"worker{self.process_id}.inc{inc} (pid {os.getpid()})")
        self._events: deque = deque(maxlen=self.capacity)
        self._threads: Dict[int, str] = {}
        self._lock = threading.Lock()
        self.dropped = 0

    # -- recording ---------------------------------------------------------

    def _abs_us(self, t_mono: float) -> float:
        """Monotonic instant -> wall-clock microseconds (the merge base)."""
        return (self._t0_wall + (t_mono - self._t0_mono)) * 1e6

    def _record(self, ev: dict) -> None:
        tid = threading.get_ident()
        ev["pid"] = self.process_id
        ev["tid"] = tid
        with self._lock:
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def complete_at(self, name: str, t_start: float, t_end: float,
                    cat: str = "", **args) -> None:
        """Record a complete span from two instants of ``self.clock`` —
        the post-hoc path (e.g. a request's queue wait, stamped at
        submit time on another thread)."""
        ev = {"name": name, "ph": "X", "cat": cat or "span",
              "ts": round(self._abs_us(t_start), 1),
              "dur": round(max(0.0, t_end - t_start) * 1e6, 1)}
        if args:
            ev["args"] = args
        self._record(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record an instant event (fault, recovery, canary decision,
        membership epoch...)."""
        ev = {"name": name, "ph": "i", "s": "p", "cat": cat or "instant",
              "ts": round(self._abs_us(self.clock()), 1)}
        if args:
            ev["args"] = args
        self._record(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    # -- export ------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self) -> dict:
        """The Chrome trace-event JSON object (perfetto-loadable), plus a
        ``metadata`` block the merge tool and tests read."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
            dropped = self.dropped
        meta: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": self.process_id,
             "tid": 0, "args": {"name": self.process_name}},
        ]
        for tid, tname in sorted(threads.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self.process_id, "tid": tid,
                         "args": {"name": tname}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {
                "process_id": self.process_id,
                "process_name": self.process_name,
                "os_pid": os.getpid(),
                "t0_wall": self._t0_wall,
                "events": len(events),
                "dropped": dropped,
            },
        }

    def save(self, path: Optional[str] = None) -> str:
        """Write the export atomically; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no trace path: pass save(path=...) or "
                             "enable_tracing(path=...)")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.export(), f)
        os.replace(tmp, path)
        return path


# -- module-level fast path (what instrumented code calls) -----------------

_recorder: Optional[TraceRecorder] = None


def enable_tracing(path: Optional[str] = None,
                   capacity: int = DEFAULT_CAPACITY,
                   process_id: Optional[int] = None,
                   process_name: Optional[str] = None) -> TraceRecorder:
    """Install (and return) the process-global recorder.  ``path`` is
    where ``flush()`` writes the Chrome trace."""
    global _recorder
    _recorder = TraceRecorder(capacity=capacity, path=path,
                              process_id=process_id,
                              process_name=process_name)
    return _recorder


def disable_tracing() -> None:
    global _recorder
    _recorder = None


def set_recorder(rec: Optional[TraceRecorder]) -> Optional[TraceRecorder]:
    """Install a pre-built recorder (or None to disable) — lets an A/B
    harness toggle ONE accumulating recorder across interleaved arms."""
    global _recorder
    _recorder = rec
    return rec


def get_recorder() -> Optional[TraceRecorder]:
    return _recorder


def tracing_enabled() -> bool:
    return _recorder is not None


def span(name: str, cat: str = "", **args):
    """``with span("train/step", iteration=i): ...`` — a no-op when
    tracing is disabled (one global read, shared null object)."""
    r = _recorder
    if r is None:
        return _NULL_SPAN
    return r.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    r = _recorder
    if r is not None:
        r.instant(name, cat, **args)


def complete_at(name: str, t_start: float, t_end: float,
                cat: str = "", **args) -> None:
    """Post-hoc complete span from two ``time.monotonic`` instants."""
    r = _recorder
    if r is not None:
        r.complete_at(name, t_start, t_end, cat, **args)


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form: ``@traced("serve/warmup")``."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*a, **kw):
            r = _recorder
            if r is None:
                return fn(*a, **kw)
            with r.span(span_name, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the global recorder's trace to ``path`` (or its configured
    path); None when tracing is disabled or no path is known.  Safe to
    call right before a chaos SIGKILL — the write is atomic."""
    r = _recorder
    if r is None:
        return None
    if path is None and r.path is None:
        return None
    try:
        return r.save(path)
    except OSError:
        return None


# -- merge + schema --------------------------------------------------------

def merge_traces(paths: Iterable[str], out_path: Optional[str] = None) -> dict:
    """Stitch N per-process trace files into ONE pod timeline.

    Events already share a wall-clock base (every recorder anchors its
    monotonic clock to ``time.time()`` at construction), so merging is
    concatenation plus pid disambiguation: two files claiming the same
    Chrome pid (a relaunched worker's incarnations, or a foreign file)
    are offset into distinct tracks, and each incarnation keeps its own
    ``process_name`` metadata row.  Returns the merged trace object;
    writes it to ``out_path`` when given.
    """
    merged: List[dict] = []
    meta: List[dict] = []
    used_pids: Dict[int, int] = {}   # requested pid -> next free remap
    sources = []
    for path in sorted(paths):
        with open(path) as f:
            obj = json.load(f)
        events = obj.get("traceEvents", [])
        pids = sorted({int(e.get("pid", 0)) for e in events})
        remap: Dict[int, int] = {}
        for pid in pids:
            new = pid
            while new in used_pids:
                new += 1000          # distinct track, stable ordering
            used_pids[new] = pid
            remap[pid] = new
        for e in events:
            e = dict(e)
            e["pid"] = remap.get(int(e.get("pid", 0)), e.get("pid", 0))
            (meta if e.get("ph") == "M" else merged).append(e)
        sources.append({"path": os.path.basename(path),
                        "pids": {str(k): v for k, v in remap.items()},
                        "metadata": obj.get("metadata", {})})
    merged.sort(key=lambda e: e.get("ts", 0.0))
    out = {"traceEvents": meta + merged, "displayTimeUnit": "ms",
           "metadata": {"merged_from": sources, "events": len(merged)}}
    if out_path:
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, out_path)
    return out


_REQUIRED_BY_PHASE = {"X": ("name", "ts", "dur", "pid", "tid"),
                      "i": ("name", "ts", "pid", "tid"),
                      "M": ("name", "pid")}


def validate_chrome_trace(obj: Any) -> List[str]:
    """Check ``obj`` against the Chrome trace-event JSON object format
    (the subset this module emits: X / i / M phases).  Returns a list of
    human-readable problems — empty means the trace is loadable."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = e.get("ph")
        if ph not in _REQUIRED_BY_PHASE:
            problems.append(f"event {i} ({e.get('name')!r}) has "
                            f"unsupported phase {ph!r}")
            continue
        for field in _REQUIRED_BY_PHASE[ph]:
            if field not in e:
                problems.append(f"event {i} ({e.get('name')!r}, ph={ph}) "
                                f"missing {field!r}")
        for num in ("ts", "dur"):
            if num in e and not isinstance(e[num], (int, float)):
                problems.append(f"event {i} {num} not numeric")
        if "dur" in e and isinstance(e["dur"], (int, float)) and e["dur"] < 0:
            problems.append(f"event {i} has negative dur")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"event {i} args not an object")
        if len(problems) > 20:
            problems.append("... (truncated)")
            break
    return problems


def span_tree(obj_or_events) -> List[dict]:
    """Complete-span forest by (pid, tid) timestamp containment: each
    node is ``{"name", "event", "children": [...]}`` — what the golden
    span-tree tests and the A/B gate walk."""
    if isinstance(obj_or_events, dict):
        events = obj_or_events.get("traceEvents", [])
    else:
        events = list(obj_or_events)
    spans = [e for e in events if e.get("ph") == "X"]
    by_track: Dict[tuple, List[dict]] = {}
    for e in spans:
        by_track.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    roots: List[dict] = []
    for track in sorted(by_track, key=str):
        evs = sorted(by_track[track],
                     key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[dict] = []
        for e in evs:
            node = {"name": e["name"], "event": e, "children": []}
            end = e["ts"] + e.get("dur", 0.0)
            while stack and e["ts"] >= (stack[-1]["event"]["ts"]
                                        + stack[-1]["event"].get("dur", 0.0)):
                stack.pop()
            if stack:
                stack[-1]["children"].append(node)
            else:
                roots.append(node)
            if end > e["ts"]:   # a child could still start inside us
                stack.append(node)
    return roots


def find_spans(tree: List[dict], name: str) -> List[dict]:
    """All nodes named ``name`` anywhere in a :func:`span_tree` forest."""
    out: List[dict] = []

    def walk(nodes):
        for n in nodes:
            if n["name"] == name:
                out.append(n)
            walk(n["children"])

    walk(tree)
    return out
