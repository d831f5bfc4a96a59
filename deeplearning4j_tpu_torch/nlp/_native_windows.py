"""ctypes binding for the C++ skip-gram window generator
(``native/w2v_window.cpp``), the port of
``deeplearning4j_tpu/nlp/_native_windows.py``.

The source is the repository's own, compiled as it is with ``g++`` by
``utils.native_build.build_and_load`` into the port's build directory
(``utils.cuda_build.BUILD_DIR``) under a name carrying the source's
digest.  Pair semantics match the numpy path (position-major centers,
ascending context offsets, per-center dynamic window, sentence-bounded);
only the dynamic-window RNG stream differs (splitmix64 against numpy
PCG64), both deterministic per seed.  As in the reference, a failed build
makes ``sg_windows`` return None and the caller takes the numpy path; the
port logs that fallback (once, naming the pair stream) beside the build's
own warning, because the two streams give different fits from one seed.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "w2v_window.cpp")


def load_window_lib() -> Optional[ctypes.CDLL]:
    """The built library, or None (logged once) when it cannot be built."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB or None
        from ..utils.native_build import build_and_load

        lib = build_and_load(_SRC, "libdl4jtpu_w2v.so")
        if lib is None:
            logger.warning("native skip-gram window generator unavailable: the "
                           "numpy pair stream is used (its dynamic-window draws "
                           "differ from the native library's)")
            _LIB = False
            return None
        lib.dl4j_sg_windows.restype = ctypes.c_int64
        lib.dl4j_sg_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
        return lib


def sg_windows(tokens: np.ndarray, sids: np.ndarray, window: int,
               seed: int) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(centers, targets, center_positions) for the block, or None when the
    native library is unavailable (caller falls back to numpy)."""
    if window < 1:  # the C++ modulo would SIGFPE — fail in Python instead
        raise ValueError(f"window must be >= 1, got {window}")
    lib = load_window_lib()
    if lib is None:
        return None
    n = len(tokens)
    cap = n * 2 * window
    t = np.ascontiguousarray(tokens, np.int32)
    s = np.ascontiguousarray(sids, np.int32)
    centers = np.empty(cap, np.int32)
    targets = np.empty(cap, np.int32)
    pos = np.empty(cap, np.int64)
    k = lib.dl4j_sg_windows(
        t.ctypes.data, s.ctypes.data, n, window, np.uint64(seed),
        centers.ctypes.data, targets.ctypes.data, pos.ctypes.data)
    return centers[:k], targets[:k], pos[:k]
