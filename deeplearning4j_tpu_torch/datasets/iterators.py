"""DataSetIterator pipeline — composable minibatch iterators (a copy of
``deeplearning4j_tpu/datasets/iterators.py``; the port keeps its own).

Parity with reference datasets/iterator/ (SURVEY.md §2.1 "Dataset iterator
layer"): AsyncDataSetIterator (background prefetch thread wrapped around any
iterator — reference AsyncDataSetIterator.java:30, used by
MultiLayerNetwork.fit():1169-1172), MultipleEpochsIterator,
EarlyTerminationDataSetIterator, SamplingDataSetIterator.

Iterators follow the reference's contract: ``reset()``, ``has_next()``,
``next()`` → DataSet, ``batch_size``, plus Python iteration sugar.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from .dataset import DataSet


class DataSetIterator:
    """Abstract base (reference org.nd4j.linalg.dataset.api.iterator).

    ``set_pre_processor`` attaches a normalizer (datasets/normalizers.py)
    — the reference's ``iterator.setPreProcessor(normalizer)`` hook.  Like
    the reference, the preprocessor runs inside ``next()`` (every subclass
    override is auto-wrapped via ``__init_subclass__``), so wrapper
    iterators that pull batches through an inner iterator's ``next()``
    (AsyncDataSetIterator's producer thread, MultipleEpochs, ...) see
    normalized batches too — and async prefetch genuinely overlaps the
    normalization with device compute."""

    batch_size: int = 0
    pre_processor = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        nxt = cls.__dict__.get("next")
        if nxt is not None and not getattr(nxt, "_applies_pre", False):
            import functools

            @functools.wraps(nxt)
            def wrapped(self, *a, **kw):
                # reentrancy guard: a subclass next() that delegates via
                # super().next() hits TWO wraps on the same instance —
                # only the outermost may apply the preprocessor, or a
                # fitted normalizer would run twice
                if getattr(self, "_in_next", False):
                    return nxt(self, *a, **kw)
                self._in_next = True
                try:
                    ds = nxt(self, *a, **kw)
                finally:
                    self._in_next = False
                if self.pre_processor is not None and ds is not None:
                    ds = self.pre_processor.pre_process(ds)
                return ds

            wrapped._applies_pre = True
            cls.next = wrapped

    def set_pre_processor(self, pre_processor) -> "DataSetIterator":
        self.pre_processor = pre_processor
        return self

    def reset(self) -> None:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()

    def total_examples(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-built minibatches (reference ListDataSetIterator
    / ExistingDataSetIterator)."""

    def __init__(self, batches: List[DataSet]):
        self._batches = list(batches)
        self._pos = 0
        self.batch_size = batches[0].num_examples() if batches else 0

    @staticmethod
    def from_arrays(features: np.ndarray, labels: np.ndarray, batch_size: int,
                    shuffle: bool = False, seed: Optional[int] = None) -> "ListDataSetIterator":
        ds = DataSet(features, labels)
        if shuffle:
            ds = ds.shuffle(seed)
        return ListDataSetIterator(ds.batch_by(batch_size))

    def reset(self) -> None:
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def next(self) -> DataSet:
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def total_examples(self) -> int:
        return sum(b.num_examples() for b in self._batches)


class _ProducerFailure:
    """Exception carrier for background-producer iterators: a raise on the
    producer thread is enqueued instead of a batch and re-raised in
    ``next()``/``has_next()`` on the CONSUMER thread — never swallowed
    into a silently truncated epoch.  Shared with
    ``device_prefetch.DevicePrefetchIterator``."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference AsyncDataSetIterator.java:30:
    'used to load batches in the background while training proceeds').

    ``prefetch`` matches the reference's queue capacity (default 2×).
    The producer thread fills a bounded queue; a sentinel marks exhaustion;
    a producer exception is enqueued and re-raised on the consumer thread.
    """

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 4):
        self._base = base
        self._prefetch = prefetch
        self.batch_size = base.batch_size
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._peeked = None
        self._start()

    def _start(self) -> None:
        self._queue = queue.Queue(maxsize=self._prefetch)
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
            err = None
            try:
                self._base.reset()
                while self._base.has_next() and not stop.is_set():
                    _enqueue(self._base.next())
            except BaseException as e:  # noqa: BLE001 — carried to consumer
                # a raise in base.next() used to hit the finally, enqueue
                # the sentinel, and truncate the epoch SILENTLY; carry it
                err = e
            finally:
                _enqueue(self._SENTINEL if err is None
                         else _ProducerFailure(err))

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def reset(self) -> None:
        """Tear down the producer (deadlock-free even mid-stream or after
        exhaustion) and start a fresh pass."""
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():
                try:  # unblock a producer stuck on a full queue
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._thread.join()
        self._peeked = None
        self._start()

    def _peek(self):
        if self._peeked is None:
            self._peeked = self._queue.get()
        return self._peeked

    def has_next(self) -> bool:
        item = self._peek()
        if isinstance(item, _ProducerFailure):
            # stays peeked: every subsequent call re-raises until reset()
            raise item.exc
        return item is not self._SENTINEL

    def next(self) -> DataSet:
        item = self._peek()
        if isinstance(item, _ProducerFailure):
            raise item.exc
        if item is self._SENTINEL:
            raise StopIteration
        self._peeked = None
        return item

    def total_examples(self):
        return self._base.total_examples()


class MultipleEpochsIterator(DataSetIterator):
    """Replays a base iterator for N epochs (reference MultipleEpochsIterator)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self._base = base
        self._epochs = epochs
        self._epoch = 0
        self.batch_size = base.batch_size
        base.reset()

    def reset(self) -> None:
        self._epoch = 0
        self._base.reset()

    def has_next(self) -> bool:
        if self._base.has_next():
            return True
        if self._epoch + 1 < self._epochs:
            self._epoch += 1
            self._base.reset()
            return self._base.has_next()
        return False

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self._base.next()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches per epoch (reference
    EarlyTerminationDataSetIterator)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self._base = base
        self._max = max_batches
        self._count = 0
        self.batch_size = base.batch_size

    def reset(self) -> None:
        self._count = 0
        self._base.reset()

    def has_next(self) -> bool:
        return self._count < self._max and self._base.has_next()

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        self._count += 1
        return self._base.next()


class SamplingDataSetIterator(DataSetIterator):
    """Samples minibatches with replacement from a full DataSet (reference
    SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch_size: int, batches_per_epoch: int,
                 seed: Optional[int] = None):
        self._ds = dataset
        self.batch_size = batch_size
        self._n_batches = batches_per_epoch
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def reset(self) -> None:
        self._count = 0

    def has_next(self) -> bool:
        return self._count < self._n_batches

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        self._count += 1
        idx = self._rng.integers(0, self._ds.num_examples(), size=self.batch_size)
        return self._ds.get_rows(idx)


class KFoldIterator(DataSetIterator):
    """K-fold cross-validation over a DataSet (reference KFoldIterator):
    each ``next()`` yields the TRAIN split of the current fold; the
    held-out fold is available as ``test_fold()`` until the next call.

    >>> kf = KFoldIterator(ds, k=5)
    >>> for train in kf:
    ...     net.fit(train); scores.append(net.evaluate(kf.test_fold()))
    """

    def __init__(self, dataset: DataSet, k: int = 10,
                 shuffle_seed: Optional[int] = None):
        n = dataset.num_examples()
        if not 2 <= k <= n:
            raise ValueError(f"k must be in [2, num_examples={n}], got {k}")
        self._ds = dataset.shuffle(shuffle_seed) if shuffle_seed is not None \
            else dataset
        self.k = k
        # reference semantics: n % k remainder goes to the LAST fold
        base = n // k
        sizes = [base] * k
        sizes[-1] += n - base * k
        self._bounds = np.cumsum([0] + sizes)
        self._fold = 0
        self._test: Optional[DataSet] = None

    def reset(self) -> None:
        self._fold = 0
        self._test = None

    def has_next(self) -> bool:
        return self._fold < self.k

    def _take(self, idx) -> DataSet:
        return self._ds.get_rows(idx)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        lo, hi = self._bounds[self._fold], self._bounds[self._fold + 1]
        n = self._ds.num_examples()
        test_idx = np.arange(lo, hi)
        train_idx = np.concatenate([np.arange(0, lo), np.arange(hi, n)])
        self._test = self._take(test_idx)
        self._fold += 1
        return self._take(train_idx)

    def test_fold(self) -> DataSet:
        """The held-out fold for the most recent ``next()`` — normalized by
        the attached pre_processor like the train split (evaluating raw
        features against a model trained on normalized ones would produce
        near-chance scores silently)."""
        if self._test is None:
            raise ValueError("call next() first")
        if self.pre_processor is not None:
            return self.pre_processor.pre_process(self._test)
        return self._test
