"""Dataset fetchers of the port — MNIST / EMNIST / CIFAR-10 / SVHN /
TinyImageNet / LFW / UCI synthetic control / Iris, and their iterator
constructors (a copy of ``deeplearning4j_tpu/datasets/fetchers.py``).

There is no download.  The fetchers read the standard files from a local
cache directory (``DL4J_TPU_DATA_DIR``, default ``~/.deeplearning4j_tpu``),
the reference's; without them they make the reference's deterministic
synthetic surrogates (same shapes, classes and seeds, so both packages get
the same arrays), and log that they did.  Iris ships embedded.  The
arrays stay numpy on the host; a network or ``DevicePrefetchIterator``
moves them to its device.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

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


def load_cifar10(train: bool = True, allow_synthetic: bool = True,
                 synthetic_n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """→ (images [n,32,32,3] float32, labels [n] int32).  Reads the
    canonical cifar-10-batches-bin format (reference CifarDataSetIterator)."""
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    found = []
    for name in names:
        p = (_find(name)
             or _find(os.path.join("cifar-10-batches-bin", name)))
        if p:
            found.append(p)
    if len(found) == len(names):
        xs_list, ys_list = [], []
        for p in found:
            raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
            ys_list.append(raw[:, 0].astype(np.int32))
            imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            xs_list.append(imgs.astype(np.float32) / 255.0)
        return np.concatenate(xs_list), np.concatenate(ys_list)
    if not allow_synthetic:
        raise FileNotFoundError(f"CIFAR-10 binaries not found under {data_dir()}")
    logger.warning("CIFAR-10 files not found under %s — using synthetic surrogate",
                   data_dir())
    return _synthetic_images(synthetic_n, 32, 32, 3, 10, seed=44 if train else 45)


# ---------------------------------------------------------------------------
# EMNIST — IDX like MNIST, stored transposed (reference EmnistDataFetcher)
# ---------------------------------------------------------------------------

#: split → class count (reference EmnistDataSetIterator.Set)
EMNIST_SPLITS = {"balanced": 47, "byclass": 62, "bymerge": 47,
                 "digits": 10, "letters": 26, "mnist": 10}


def load_emnist(split: str = "balanced", train: bool = True,
                allow_synthetic: bool = True,
                synthetic_n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """→ ([n,28,28,1] float32, [n] int32).  Canonical emnist-<split>-...
    IDX files; EMNIST images are stored transposed vs MNIST and are
    un-transposed here (reference EmnistDataFetcher)."""
    if split not in EMNIST_SPLITS:
        raise ValueError(f"unknown EMNIST split '{split}' — one of "
                         f"{sorted(EMNIST_SPLITS)}")
    kind = "train" if train else "test"
    img = _find(f"emnist-{split}-{kind}-images-idx3-ubyte",
                f"emnist-{split}-{kind}-images-idx3-ubyte.gz",
                os.path.join("emnist", f"emnist-{split}-{kind}-images-idx3-ubyte.gz"))
    lbl = _find(f"emnist-{split}-{kind}-labels-idx1-ubyte",
                f"emnist-{split}-{kind}-labels-idx1-ubyte.gz",
                os.path.join("emnist", f"emnist-{split}-{kind}-labels-idx1-ubyte.gz"))
    classes = EMNIST_SPLITS[split]
    if img and lbl:
        xs = read_idx_images(img).astype(np.float32)[..., None] / 255.0
        xs = np.transpose(xs, (0, 2, 1, 3))  # EMNIST stores transposed
        ys = read_idx_labels(lbl).astype(np.int32)
        if split == "letters":
            ys = ys - 1  # letters labels are 1-based
        return xs, ys
    if not allow_synthetic:
        raise FileNotFoundError(f"EMNIST({split}) IDX files not found under {data_dir()}")
    logger.warning("EMNIST(%s) files not found under %s — synthetic surrogate",
                   split, data_dir())
    return _synthetic_images(synthetic_n, 28, 28, 1, classes, seed=46 if train else 47)


# ---------------------------------------------------------------------------
# SVHN — .mat cropped-digits format (reference SvhnDataFetcher)
# ---------------------------------------------------------------------------


def load_svhn(train: bool = True, allow_synthetic: bool = True,
              synthetic_n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """→ ([n,32,32,3] float32, [n] int32).  Canonical train_32x32.mat /
    test_32x32.mat (X [32,32,3,N], y [N] with '10' meaning digit 0)."""
    name = "train_32x32.mat" if train else "test_32x32.mat"
    p = _find(name, os.path.join("svhn", name))
    if p:
        import scipy.io
        mat = scipy.io.loadmat(p)
        xs = np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.float32) / 255.0
        ys = mat["y"].reshape(-1).astype(np.int32)
        ys = np.where(ys == 10, 0, ys)
        return xs, ys
    if not allow_synthetic:
        raise FileNotFoundError(f"SVHN {name} not found under {data_dir()}")
    logger.warning("SVHN files not found under %s — synthetic surrogate", data_dir())
    return _synthetic_images(synthetic_n, 32, 32, 3, 10, seed=48 if train else 49)


# ---------------------------------------------------------------------------
# TinyImageNet — directory-of-JPEGs layout (reference TinyImageNetFetcher)
# ---------------------------------------------------------------------------


def load_tiny_imagenet(train: bool = True, allow_synthetic: bool = True,
                       synthetic_n: int = 1024,
                       limit_per_class: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """→ ([n,64,64,3] float32, [n] int32, 200 classes).  Reads the standard
    tiny-imagenet-200/ layout (train/<wnid>/images/*.JPEG; val via
    val_annotations.txt)."""
    root = os.path.join(data_dir(), "tiny-imagenet-200")
    if os.path.isdir(root):
        from PIL import Image
        wnids = sorted(os.listdir(os.path.join(root, "train")))
        wnid_to_idx = {w: i for i, w in enumerate(wnids)}
        xs_list, ys_list = [], []
        if train:
            for w in wnids:
                img_dir = os.path.join(root, "train", w, "images")
                files = sorted(os.listdir(img_dir))[:limit_per_class]
                for fn in files:
                    img = Image.open(os.path.join(img_dir, fn)).convert("RGB")
                    xs_list.append(np.asarray(img, np.float32) / 255.0)
                    ys_list.append(wnid_to_idx[w])
        else:
            ann = os.path.join(root, "val", "val_annotations.txt")
            with open(ann) as f:
                for line in f:
                    parts = line.split("\t")
                    img = Image.open(os.path.join(root, "val", "images",
                                                  parts[0])).convert("RGB")
                    xs_list.append(np.asarray(img, np.float32) / 255.0)
                    ys_list.append(wnid_to_idx[parts[1]])
        return np.stack(xs_list), np.asarray(ys_list, np.int32)
    if not allow_synthetic:
        raise FileNotFoundError(f"tiny-imagenet-200/ not found under {data_dir()}")
    logger.warning("TinyImageNet not found under %s — synthetic surrogate", data_dir())
    return _synthetic_images(synthetic_n, 64, 64, 3, 200, seed=50 if train else 51)


def load_lfw(train: bool = True, allow_synthetic: bool = True,
             synthetic_n: int = 256, min_faces_per_person: int = 2,
             image_size: int = 250,
             limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled Faces in the Wild → ([n,S,S,3] float32 in [0,1], [n] int32).

    Reads the standard ``lfw/<person_name>/<person>_NNNN.jpg`` layout
    (reference LFWDataSetIterator.java:31 / LFWLoader); labels are person
    indices over people with ≥ ``min_faces_per_person`` images, and the
    deterministic 80/20 per-person split replaces the reference's random
    train/test sampling.  Falls back to a synthetic surrogate when the
    archive is absent (zero-egress environments)."""
    root = os.path.join(data_dir(), "lfw")
    if os.path.isdir(root):
        from PIL import Image
        people = sorted(d for d in os.listdir(root)
                        if os.path.isdir(os.path.join(root, d)))
        kept = []
        for p in people:
            files = sorted(f for f in os.listdir(os.path.join(root, p))
                           if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if len(files) >= min_faces_per_person:
                kept.append((p, files))
        if not kept:
            raise ValueError(f"no people with >= {min_faces_per_person} "
                             f"faces under {root}")
        xs_list, ys_list = [], []
        for idx, (p, files) in enumerate(kept):
            cut = max(1, int(len(files) * 0.8))
            use = files[:cut] if train else files[cut:]
            for fn in use:
                img = Image.open(os.path.join(root, p, fn)).convert("RGB")
                if img.size != (image_size, image_size):
                    img = img.resize((image_size, image_size))
                xs_list.append(np.asarray(img, np.float32) / 255.0)
                ys_list.append(idx)
                if limit and len(xs_list) >= limit:
                    return np.stack(xs_list), np.asarray(ys_list, np.int32)
        if not xs_list:  # tiny archives can have empty test splits
            raise ValueError("empty LFW split — lower min_faces_per_person")
        return np.stack(xs_list), np.asarray(ys_list, np.int32)
    if not allow_synthetic:
        raise FileNotFoundError(f"lfw/ not found under {data_dir()}")
    logger.warning("LFW not found under %s — synthetic surrogate", data_dir())
    return _synthetic_images(synthetic_n, image_size, image_size, 3, 5,
                             seed=60 if train else 61)


# ---------------------------------------------------------------------------
# UCI synthetic control — sequence classification (reference
# UciSequenceDataFetcher: 600 series × 60 steps, 6 classes)
# ---------------------------------------------------------------------------


def load_uci_synthetic_control(train: bool = True, allow_synthetic: bool = True
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (sequences [n,60,1] float32, labels [n] int32).  Canonical
    synthetic_control.data: 600 whitespace rows, 100 per class in order;
    the reference's 75/25 train/test split per class is reproduced."""
    p = _find("synthetic_control.data", os.path.join("uci", "synthetic_control.data"))
    if p:
        raw = np.loadtxt(p, dtype=np.float64)
        if raw.shape != (600, 60):
            raise ValueError(f"{p}: expected 600x60, got {raw.shape}")
        xs = raw.reshape(600, 60, 1).astype(np.float32)
        ys = np.repeat(np.arange(6), 100).astype(np.int32)
    else:
        if not allow_synthetic:
            raise FileNotFoundError(f"synthetic_control.data not found under {data_dir()}")
        logger.warning("UCI synthetic_control not found under %s — surrogate",
                       data_dir())
        rng = np.random.default_rng(52)
        t = np.arange(60)
        rows = []
        for cls in range(6):
            base = {0: np.zeros(60), 1: 0.5 * np.sin(t / 4), 2: 0.08 * t,
                    3: -0.08 * t, 4: np.where(t > 30, 3.0, 0.0),
                    5: np.where(t > 30, -3.0, 0.0)}[cls]
            rows.append(base[None, :] + rng.normal(0, 0.3, (100, 60)))
        xs = np.concatenate(rows).reshape(600, 60, 1).astype(np.float32)
        ys = np.repeat(np.arange(6), 100).astype(np.int32)
    # per-class 75/25 split (reference UciSequenceDataFetcher)
    sel = np.zeros(600, bool)
    for cls in range(6):
        sel[cls * 100: cls * 100 + 75] = True
    keep = sel if train else ~sel
    return xs[keep], ys[keep]


# ---------------------------------------------------------------------------
# IRIS — embedded (reference IrisDataFetcher hardcodes the 150 rows too)
# ---------------------------------------------------------------------------

_IRIS = None


def load_iris() -> Tuple[np.ndarray, np.ndarray]:
    """Fisher's Iris, 150×4 + 3 classes (public domain)."""
    global _IRIS
    if _IRIS is None:
        from ._iris_data import IRIS_DATA
        arr = np.asarray(IRIS_DATA, dtype=np.float32)
        _IRIS = (arr[:, :4], arr[:, 4].astype(np.int32))
    return _IRIS


# ---------------------------------------------------------------------------
# iterator constructors (reference iterator/impl/*DataSetIterator)
# ---------------------------------------------------------------------------


def _one_hot(ys: np.ndarray, classes: int) -> np.ndarray:
    return np.eye(classes, dtype=np.float32)[ys]


def MnistDataSetIterator(batch_size: int, train: bool = True, seed: int = 123,
                         flatten: bool = False, **kw) -> ListDataSetIterator:
    xs, ys = load_mnist(train=train, **kw)
    if flatten:
        xs = xs.reshape(xs.shape[0], -1)
    ds = DataSet(xs, _one_hot(ys, 10)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def Cifar10DataSetIterator(batch_size: int, train: bool = True, seed: int = 123,
                           **kw) -> ListDataSetIterator:
    xs, ys = load_cifar10(train=train, **kw)
    ds = DataSet(xs, _one_hot(ys, 10)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def IrisDataSetIterator(batch_size: int = 150, seed: int = 123) -> ListDataSetIterator:
    xs, ys = load_iris()
    ds = DataSet(xs, _one_hot(ys, 3)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def EmnistDataSetIterator(batch_size: int, split: str = "balanced",
                          train: bool = True, seed: int = 123,
                          **kw) -> ListDataSetIterator:
    xs, ys = load_emnist(split=split, train=train, **kw)
    ds = DataSet(xs, _one_hot(ys, EMNIST_SPLITS[split])).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def SvhnDataSetIterator(batch_size: int, train: bool = True, seed: int = 123,
                        **kw) -> ListDataSetIterator:
    xs, ys = load_svhn(train=train, **kw)
    ds = DataSet(xs, _one_hot(ys, 10)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def TinyImageNetDataSetIterator(batch_size: int, train: bool = True,
                                seed: int = 123, **kw) -> ListDataSetIterator:
    xs, ys = load_tiny_imagenet(train=train, **kw)
    ds = DataSet(xs, _one_hot(ys, 200)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def LFWDataSetIterator(batch_size: int, train: bool = True, seed: int = 123,
                       **kw) -> ListDataSetIterator:
    """Face classification batches (reference LFWDataSetIterator.java:31);
    label width adapts to the people found in the archive."""
    xs, ys = load_lfw(train=train, **kw)
    n_classes = int(ys.max()) + 1
    ds = DataSet(xs, _one_hot(ys, n_classes)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))


def UciSequenceDataSetIterator(batch_size: int, train: bool = True,
                               seed: int = 123, **kw) -> ListDataSetIterator:
    """Sequence classification: [mb,60,1] features, per-sequence one-hot
    labels (reference UciSequenceDataSetIterator)."""
    xs, ys = load_uci_synthetic_control(train=train, **kw)
    ds = DataSet(xs, _one_hot(ys, 6)).shuffle(seed)
    return ListDataSetIterator(ds.batch_by(batch_size))
