"""Training listeners — iteration/epoch callbacks (a copy of
``deeplearning4j_tpu/optimize/listeners.py``; the port keeps its own).

Parity targets (reference optimize/listeners/): ScoreIterationListener,
PerformanceListener (samples/batches per sec — PerformanceListener.java:
19-58), CollectScoresIterationListener, TimeIterationListener,
EvaluativeListener; checkpoint saving mirrors the early-stopping savers
(earlystopping/saver/LocalFileModelSaver.java).

Contract: ``iteration_done(model, iteration, score)`` after every optimizer
step (called from MultiLayerNetwork.fit_batch / ComputationGraph.fit_batch),
``epoch_done(model, epoch)`` after each epoch.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """Base no-op listener (reference IterationListener/TrainingListener).

    ``score`` is a float-like LazyScore — reading it (format, compare,
    ``float()``) syncs the device; listeners that only log every N
    iterations therefore only sync every N iterations.

    ``requires_model_state``: set True on listeners whose callback acts on
    the model's *current* params (checkpointing, evaluation).  Fused
    multi-step paths (TBPTT scan) fall back to stepping one chunk per
    dispatch when such a listener is attached, so the callback sees each
    iteration's params rather than end-of-batch params."""

    requires_model_state = False

    def iteration_done(self, model, iteration: int, score: float) -> None:
        pass

    def epoch_done(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_every: int = 10, out: Optional[Callable[[str], None]] = None):
        self.print_every = max(print_every, 1)
        self._out = out or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_every == 0:
            self._out(f"Score at iteration {iteration} is {score:.6f}")


class PerformanceListener(TrainingListener):
    """Throughput tracking: samples/sec + batches/sec per reporting window
    (reference PerformanceListener.java:22-58)."""

    def __init__(self, report_every: int = 10, batch_size_fn: Optional[Callable] = None,
                 out: Optional[Callable[[str], None]] = None):
        self.report_every = max(report_every, 1)
        self._out = out or (lambda s: logger.info(s))
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._batch_size = 0
        self.history: List[Tuple[float, float]] = []  # (samples/sec, batches/sec)
        self._batch_size_fn = batch_size_fn

    def set_batch_size(self, n: int) -> None:
        self._batch_size = n

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter >= self.report_every:
            elapsed = now - self._last_time
            batches = iteration - self._last_iter
            bps = batches / elapsed
            sps = bps * (self._batch_size or 0)
            self.history.append((sps, bps))
            self._out(f"iteration {iteration}: {bps:.1f} batches/sec"
                      + (f", {sps:.1f} samples/sec" if self._batch_size else ""))
            self._last_time, self._last_iter = now, iteration


class CollectScoresIterationListener(TrainingListener):
    """Accumulate (iteration, score) pairs (reference CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(frequency, 1)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, score))


class TimeIterationListener(TrainingListener):
    """ETA logging from measured iteration rate (reference TimeIterationListener)."""

    def __init__(self, total_iterations: int, out: Optional[Callable[[str], None]] = None):
        self.total = total_iterations
        self._start: Optional[float] = None
        self._out = out or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, score):
        if self._start is None:
            self._start = time.perf_counter()
            return
        elapsed = time.perf_counter() - self._start
        rate = iteration / max(elapsed, 1e-9)
        remaining = max(self.total - iteration, 0) / max(rate, 1e-9)
        self._out(f"iteration {iteration}/{self.total}, ETA {remaining:.0f}s")


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (reference EvaluativeListener)."""

    requires_model_state = True

    def __init__(self, data, frequency: int = 100, evaluation_factory=None,
                 out: Optional[Callable[[str], None]] = None):
        self.data = data
        self.frequency = max(frequency, 1)
        self._factory = evaluation_factory
        self._out = out or (lambda s: logger.info(s))
        self.evaluations: List[Tuple[int, object]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0:
            return
        ev = model.evaluate(self.data, self._factory() if self._factory else None)
        self.evaluations.append((iteration, ev))
        self._out(f"evaluation at iteration {iteration}: accuracy={ev.accuracy():.4f}")


class CheckpointListener(TrainingListener):
    """Periodic checkpointing to a directory, keeping the last N
    (reference CheckpointListener semantics; format = utils.serializer zip)."""

    requires_model_state = True

    def __init__(self, directory: str, save_every_iterations: Optional[int] = None,
                 save_every_epochs: Optional[int] = None, keep_last: int = 3):
        self.dir = directory
        self.every_iter = save_every_iterations
        self.every_epoch = save_every_epochs
        self.keep_last = keep_last
        self.saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str) -> None:
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        model.save(path)
        self.saved.append(path)
        while len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, model, iteration, score):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def epoch_done(self, model, epoch):
        if self.every_epoch and epoch % self.every_epoch == 0:
            self._save(model, f"epoch_{epoch}")


class ComposableListener(TrainingListener):
    """Fan-out to several listeners (reference ComposableIterationListener)."""

    def __init__(self, *listeners: TrainingListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)

    def epoch_done(self, model, epoch):
        for l in self.listeners:
            l.epoch_done(model, epoch)
