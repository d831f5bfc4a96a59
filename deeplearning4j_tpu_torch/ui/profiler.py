"""torch.profiler integration — the deep-performance seam (the port of
``deeplearning4j_tpu/ui/profiler.py``).

The reference polls SystemInfo/JVM stats (ui/module SystemInfoController);
here ``profile_trace(logdir)`` records a ``torch.profiler`` trace (host
operators, and on a card every CUDA kernel, the port's hand-written ones
by name) around any training region and writes it into ``logdir`` as a
Chrome trace-event JSON file (chrome://tracing, ui.perfetto.dev)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List


def input_pipeline_snapshot() -> List[dict]:
    """Stall-fraction / queue-depth snapshots of every live
    DevicePrefetchIterator (datasets/device_prefetch.py): stall_fraction ~0
    means input feeding is fully hidden under device compute, → 1 means
    the step is input-bound.  Collected by StatsListener each iteration;
    empty list when no prefetcher is active."""
    from ..datasets.device_prefetch import live_pipelines

    return [p.stall_stats() for p in live_pipelines()]


@contextlib.contextmanager
def profile_trace(logdir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Context manager: ``with profile_trace('/tmp/trace'): train()``
    writes ``trace_<pid>_<ms>.json`` into ``logdir``, CPU activity always
    and CUDA activity where a card is (``create_perfetto_link`` is the
    reference's signature; the written file opens in ui.perfetto.dev as
    it is).  Degrades gracefully when the profiler cannot start: instead of
    raising, the region runs untraced and a ``profiler/unavailable``
    instant event is recorded into the span trace (obs/trace.py) so the gap
    is visible in the timeline rather than silent; a trace that cannot be
    stopped or written records ``profiler/stop_failed``."""
    import torch

    from ..obs import trace as obs_trace

    prof = None
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:   # profiler unavailable in this build / process
        prof = None
        obs_trace.instant("profiler/unavailable", cat="profiler",
                          logdir=logdir, error=f"{type(e).__name__}: {e}")
    try:
        with obs_trace.span("profiler/trace", cat="profiler", logdir=logdir,
                            backend_started=prof is not None):
            yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
            except Exception as e:
                # a failed stop loses the device trace: record it on the
                # span timeline instead of dropping it silently
                obs_trace.instant("profiler/stop_failed", cat="profiler",
                                  logdir=logdir,
                                  error=f"{type(e).__name__}: {e}")
