"""Dataset fetchers of the port: Iris and MNIST (mirrors
``deeplearning4j_tpu/datasets/fetchers.py``; the other fetchers are still
to port).

There is no download.  ``load_mnist`` reads the standard IDX files from a
local cache directory (``DL4J_TPU_DATA_DIR``, default
``~/.deeplearning4j_tpu``), the reference's; without them it makes the
reference's deterministic synthetic surrogate (same shapes, classes and
seed, so both packages get the same arrays).  Iris ships embedded.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")


def data_dir() -> str:
    return os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(*names: str) -> Optional[str]:
    for name in names:
        for root in (data_dir(), os.path.join(data_dir(), "mnist"),
                     os.path.join(data_dir(), "cifar10")):
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return None


# ---------------------------------------------------------------------------
# IDX (MNIST/EMNIST) readers — reference MnistManager/MnistImageFile
# ---------------------------------------------------------------------------


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file → [n, rows, cols] uint8."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def _synthetic_images(n: int, h: int, w: int, c: int, classes: int, seed: int):
    """Deterministic class-dependent image surrogate: each class lights a
    distinct spatial cell pattern + noise — learnable, MNIST-shaped."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, classes, size=n)
    xs = rng.normal(0, 0.15, size=(n, h, w, c)).astype(np.float32)
    gh, gw = max(h // 4, 1), max(w // 4, 1)
    for cls in range(classes):
        mask = ys == cls
        r, col = divmod(cls, 4)
        r, col = r % 4, col % 4
        xs[mask, r * gh:(r + 1) * gh, col * gw:(col + 1) * gw, :] += 1.0
    return xs, ys.astype(np.int32)


def load_mnist(train: bool = True, allow_synthetic: bool = True,
               synthetic_n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """→ (images [n,28,28,1] float32 in [0,1]-ish, labels [n] int32)."""
    prefix = "train" if train else "t10k"
    img = _find(f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz")
    lbl = _find(f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels-idx1-ubyte.gz")
    if img and lbl:
        xs = read_idx_images(img).astype(np.float32)[..., None] / 255.0
        ys = read_idx_labels(lbl).astype(np.int32)
        return xs, ys
    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {data_dir()} (zero-egress: no "
            "auto-download; place the canonical files there)")
    logger.warning("MNIST files not found under %s — using synthetic surrogate",
                   data_dir())
    xs, ys = _synthetic_images(synthetic_n, 28, 28, 1, 10, seed=42 if train else 43)
    return xs, ys


_IRIS = None


def load_iris() -> Tuple[np.ndarray, np.ndarray]:
    """Fisher's Iris, 150×4 + 3 classes (public domain)."""
    global _IRIS
    if _IRIS is None:
        from ._iris_data import IRIS_DATA
        arr = np.asarray(IRIS_DATA, dtype=np.float32)
        _IRIS = (arr[:, :4], arr[:, 4].astype(np.int32))
    return _IRIS
