"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each source under ``deeplearning4j_tpu_torch/csrc/`` has a plain C
interface and becomes one shared library for ``sm_90a`` (Hopper),
compiled at first use into ``deeplearning4j_tpu_torch/_build/`` (listed
in ``.gitignore``), or into the directory the ``DL4J_TPU_COMPILE_CACHE``
variable names (``serving.warmcache.enable_compile_cache``), where a
later process finds the libraries built and runs no ``nvcc``.  Sources may include the ``csrc/*.cuh`` headers.  The
library name carries a digest of the source, the headers and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded.  A missing ``nvcc`` or a failed build raises: no path falls back
to a plain PyTorch version.

Nothing here runs at import time; ``build`` starts one ``nvcc`` per
source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = Path(os.environ.get("DL4J_TPU_COMPILE_CACHE") or PKG_DIR / "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: names of the sources this process ran ``nvcc`` for
compiled: List[str] = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first use and have no fallback")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/`` (``<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` process each, all started together.  Returns name → path."""
    names = list(names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out[n])     # atomic: a reader never sees half a file
        compiled.append(n)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
