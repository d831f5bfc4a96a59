"""ctypes binding for the C++ data loader (``native/data_loader.cpp``), the
port of ``deeplearning4j_tpu/datasets/native_loader.py``.

The reference's data path crosses into native code for decode + minibatch
assembly (DataVec + libnd4j; AsyncDataSetIterator feeds device queues from
a Java prefetch thread — AsyncDataSetIterator.java:30).  Here the native
piece is a C++ shuffle/gather ring: registration once, a background thread
assembles shuffled float32 minibatches, Python pops buffers (GIL-free, no
per-batch numpy fancy-indexing) and a ``DevicePrefetchIterator`` moves them
to the card.  The port compiles the repository's ``native/data_loader.cpp``
as it is (``utils/native_build.py``), so for one seed its batches are the
reference's, bit for bit; ``plain_order`` is the same shuffle in Python.

Build-on-first-use with g++; when the build fails the loader logs it and
``NativeDataSetIterator`` raises, so callers take the Python iterators.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator

logger = logging.getLogger("deeplearning4j_tpu_torch")

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "data_loader.cpp")

_MASK = (1 << 64) - 1


def _splitmix64(state: int):
    """The loader's SplitMix64 stream from ``state`` (an infinite generator)."""
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _MASK
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        yield z ^ (z >> 31)


def plain_order(n: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The row order the native loader serves in ``epoch`` (0 = the pass
    before the first ``reset``), in Python: ``shuffle_epoch``'s
    Fisher-Yates with Lemire's bounded draws, applied to the previous
    epoch's order as the loader does."""
    perm = list(range(n))
    for e in range(epoch + 1):
        rng = _splitmix64((seed + 0x51ED2701 * (e + 1)) & _MASK)
        for i in range(n - 1, 0, -1):
            j = (next(rng) * (i + 1)) >> 64
            perm[i], perm[j] = perm[j], perm[i]
    return np.asarray(perm, np.int64)


def load_native_lib() -> Optional[ctypes.CDLL]:
    """Compile (once) and dlopen the loader; None if unavailable."""
    from ..utils.native_build import build_and_load
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB or None
        lib = build_and_load(_SRC, "libdl4jtpu_data.so", ("-lpthread",))
        if lib is None:
            logger.warning("native data loader unavailable: NativeDataSetIterator "
                           "raises; use ListDataSetIterator")
            _LIB = False
            return None
        lib.dl4j_loader_create.restype = ctypes.c_void_p
        lib.dl4j_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        lib.dl4j_loader_next.restype = ctypes.c_int
        lib.dl4j_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dl4j_loader_reset.argtypes = [ctypes.c_void_p]
        lib.dl4j_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeDataSetIterator(DataSetIterator):
    """Shuffled minibatch iterator backed by the C++ prefetch ring.

    Epoch semantics match ListDataSetIterator(shuffle=True): a fresh
    deterministic shuffle per epoch (seed + epoch), remainder batch kept
    unless ``drop_remainder``.
    """

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, seed: int = 123, prefetch: int = 3,
                 drop_remainder: bool = False):
        lib = load_native_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable — use ListDataSetIterator")
        self._lib = lib
        # keep flat float32 copies alive for the C++ side to borrow
        self._x = np.ascontiguousarray(features, dtype=np.float32)
        self._y = None if labels is None else np.ascontiguousarray(labels, np.float32)
        self._feat_shape = self._x.shape[1:]
        self._lab_shape = None if self._y is None else self._y.shape[1:]
        n = self._x.shape[0]
        row_f = int(np.prod(self._feat_shape)) if self._feat_shape else 1
        row_y = int(np.prod(self._lab_shape)) if self._lab_shape else 0
        self.batch_size = batch_size
        self._row_f, self._row_y, self._n = row_f, row_y, n
        self._out_x = np.empty((batch_size, row_f), np.float32)
        self._out_y = np.empty((batch_size, max(row_y, 1)), np.float32)
        self._handle = lib.dl4j_loader_create(
            self._x.ctypes.data_as(ctypes.c_void_p),
            None if self._y is None else self._y.ctypes.data_as(ctypes.c_void_p),
            n, row_f, row_y, batch_size, prefetch, seed, int(drop_remainder))
        self._peeked: Optional[DataSet] = None
        self._done = False

    def _pull(self) -> Optional[DataSet]:
        rows = self._lib.dl4j_loader_next(
            self._handle,
            self._out_x.ctypes.data_as(ctypes.c_void_p),
            self._out_y.ctypes.data_as(ctypes.c_void_p))
        if rows == 0:
            return None
        x = self._out_x[:rows].reshape((rows,) + self._feat_shape).copy()
        y = None
        if self._y is not None:
            y = self._out_y[:rows, :self._row_y].reshape(
                (rows,) + self._lab_shape).copy()
        return DataSet(x, y)

    def has_next(self) -> bool:
        if self._done:
            return False
        if self._peeked is None:
            self._peeked = self._pull()
            if self._peeked is None:
                self._done = True
        return self._peeked is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._peeked = self._peeked, None
        return ds

    def reset(self) -> None:
        self._lib.dl4j_loader_reset(self._handle)
        self._peeked = None
        self._done = False

    def total_examples(self) -> int:
        return self._n

    def close(self) -> None:
        if self._handle:
            self._lib.dl4j_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except (OSError, AttributeError):
            # interpreter teardown: the ctypes lib or attrs may already
            # be gone — nothing to release at that point
            pass
