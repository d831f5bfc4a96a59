"""Build-on-first-use loader for the C++ native pieces (``native/*.cpp``),
the port of ``deeplearning4j_tpu/utils/native_build.py``.

The port compiles the repository's sources as they are, with ``g++``, into
its own build directory (``utils/cuda_build.BUILD_DIR``: the package's
``_build/``, or the compile cache ``enable_compile_cache`` points it at).
A library's name carries a digest of its source and flags, so an edited
source builds anew and a stale library is never loaded; the write is a
temp file renamed over the target, so concurrent builders never expose a
half-linked ``.so``.  Like the reference, ANY failure (no ``g++``, a
compile error, a library that does not load) logs a warning and returns
None, and callers fall back to their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional, Sequence

logger = logging.getLogger("deeplearning4j_tpu_torch")

FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path(src: str, so_name: str, extra_flags: Sequence[str] = ()) -> str:
    """Where ``src`` builds to: ``<BUILD_DIR>/<stem>-<digest>.so``, the
    digest over the source's bytes and the flags."""
    from . import cuda_build

    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join((*FLAGS, *extra_flags)).encode())
    stem = so_name[:-3] if so_name.endswith(".so") else so_name
    return os.path.join(str(cuda_build.BUILD_DIR), f"{stem}-{h.hexdigest()[:16]}.so")


def build_and_load(src: str, so_name: str,
                   extra_flags: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """Compile ``src`` (once per source digest) and dlopen it; None, with a
    logged warning, on any failure."""
    try:
        so = library_path(src, so_name, extra_flags)
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *FLAGS, src, "-o", tmp, *extra_flags],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        return ctypes.CDLL(so)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired, OSError) as e:
        logger.warning("native library %s unavailable (%s); using the Python "
                       "fallback", so_name, e)
        return None
