"""RecordReader bridge — the DataVec layer.

Parity targets: reference deeplearning4j-core
datasets/datavec/RecordReaderDataSetIterator.java and
SequenceRecordReaderDataSetIterator.java, with the datavec-api readers
they consume (CSVRecordReader, CSVSequenceRecordReader, ImageRecordReader).

Readers yield plain python/numpy records; the iterators assemble padded,
masked DataSet batches — the ETL work stays on host (numpy), only the
finished batches go to device, which is the right split for an
accelerator: feed the card, don't compute on it.

A copy of ``deeplearning4j_tpu/datasets/records.py``: the readers and
the batch assembly are numpy on the host, and PIL stays a lazy import
of ``ImageRecordReader``'s iteration.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


# ---------------------------------------------------------------------------
# record readers (datavec-api parity)
# ---------------------------------------------------------------------------


class CSVRecordReader:
    """Line-per-record CSV reader (reference CSVRecordReader: skipNumLines,
    delimiter).  Yields List[str] records."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._records: Optional[List[List[str]]] = None

    def initialize(self, path: str) -> "CSVRecordReader":
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self.delimiter))
        self._records = [r for r in rows[self.skip_lines:] if r]
        return self

    def __iter__(self) -> Iterator[List[str]]:
        if self._records is None:
            raise ValueError("call initialize(path) first")
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records or [])


class CSVSequenceRecordReader:
    """One CSV file per sequence (reference CSVSequenceRecordReader).
    initialize() takes a list of file paths; each yields [T, cols] rows."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._paths: List[str] = []

    def initialize(self, paths: Sequence[str]) -> "CSVSequenceRecordReader":
        self._paths = list(paths)
        return self

    def __iter__(self) -> Iterator[List[List[str]]]:
        for p in self._paths:
            with open(p, newline="") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
            yield [r for r in rows[self.skip_lines:] if r]

    def __len__(self) -> int:
        return len(self._paths)


class ImageRecordReader:
    """Directory-of-images reader, label = parent directory name
    (reference datavec ImageRecordReader + ParentPathLabelGenerator).
    Yields (image [h,w,c] float32 in [0,1], label_index)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height = height
        self.width = width
        self.channels = channels
        self.labels: List[str] = []
        self._files: List[Tuple[str, int]] = []

    def initialize(self, root: str,
                   extensions: Tuple[str, ...] = (".png", ".jpg", ".jpeg", ".bmp")
                   ) -> "ImageRecordReader":
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.labels = classes
        self._files = []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(extensions):
                    self._files.append((os.path.join(cdir, fn), idx))
        return self

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        from PIL import Image

        for path, idx in self._files:
            img = Image.open(path)
            img = img.convert("L" if self.channels == 1 else "RGB")
            img = img.resize((self.width, self.height))
            arr = np.asarray(img, np.float32) / 255.0
            if self.channels == 1:
                arr = arr[..., None]
            yield arr, idx

    def __len__(self) -> int:
        return len(self._files)


# ---------------------------------------------------------------------------
# iterators (deeplearning4j-core datasets/datavec parity)
# ---------------------------------------------------------------------------


class _AssembledIterator(DataSetIterator):
    """Shared reset/has_next/next plumbing: subclasses implement
    ``_assemble() -> List[DataSet]``; batches materialize lazily on first
    use and are cached, so the full DataSetIterator contract works (Async
    prefetch wrappers, EarlyTermination, MultipleEpochs all drive it)."""

    _cache: Optional[List[DataSet]] = None
    _pos: int = 0

    def _assemble(self) -> List[DataSet]:
        raise NotImplementedError

    def _ensure(self) -> List[DataSet]:
        if self._cache is None:
            self._cache = self._assemble()
        return self._cache

    def reset(self) -> None:
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._ensure())

    def next(self) -> DataSet:
        b = self._ensure()[self._pos]
        self._pos += 1
        return b

    def total_examples(self) -> int:
        return sum(b.num_examples() for b in self._ensure())


class RecordReaderDataSetIterator(_AssembledIterator):
    """CSV records → classification/regression DataSet batches (reference
    RecordReaderDataSetIterator: labelIndex + numPossibleLabels, or
    regression=True with labelIndexFrom/To)."""

    def __init__(self, reader, batch_size: int, label_index: int,
                 num_classes: Optional[int] = None, regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to if label_index_to is not None else label_index
        if not regression and num_classes is None:
            raise ValueError("num_classes is required for classification")

    def _assemble(self) -> List[DataSet]:
        feats, labels = [], []
        for rec in self.reader:
            vals = [v for v in rec]
            li, lt = self.label_index, self.label_index_to
            lab_vals = vals[li:lt + 1]
            feat_vals = vals[:li] + vals[lt + 1:]
            feats.append([float(v) for v in feat_vals])
            labels.append([float(v) for v in lab_vals])
        xs = np.asarray(feats, np.float32)
        if self.regression:
            ys = np.asarray(labels, np.float32)
        else:
            idx = np.asarray(labels, np.float32).astype(np.int32).reshape(-1)
            ys = np.eye(self.num_classes, dtype=np.float32)[idx]
        ds = DataSet(xs, ys)
        return ds.batch_by(self.batch_size)


class ImageRecordReaderDataSetIterator(_AssembledIterator):
    """Image records → [mb,h,w,c] DataSet batches with one-hot labels."""

    def __init__(self, reader: ImageRecordReader, batch_size: int):
        self.reader = reader
        self.batch_size = batch_size

    def _assemble(self) -> List[DataSet]:
        num_classes = len(self.reader.labels)
        xs, ys = [], []
        for arr, idx in self.reader:
            xs.append(arr)
            ys.append(idx)
        ds = DataSet(np.stack(xs),
                     np.eye(num_classes, dtype=np.float32)[np.asarray(ys)])
        return ds.batch_by(self.batch_size)


class SequenceRecordReaderDataSetIterator(_AssembledIterator):
    """Aligned feature/label sequence readers → padded+masked rank-3
    batches.  Sequences are LEFT-aligned (data from t=0, zero padding +
    mask 0 at the tail — the reference's ALIGN_START mode); masked
    consumers (RnnOutputLayer loss, LastTimeStep) handle variable lengths
    through the masks."""

    def __init__(self, features_reader, labels_reader, batch_size: int,
                 num_classes: Optional[int] = None, regression: bool = False):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        if not regression and num_classes is None:
            raise ValueError("num_classes is required for classification")

    def _assemble(self) -> List[DataSet]:
        fseqs = [np.asarray([[float(v) for v in row] for row in seq], np.float32)
                 for seq in self.features_reader]
        lseqs = [np.asarray([[float(v) for v in row] for row in seq], np.float32)
                 for seq in self.labels_reader]
        if len(fseqs) != len(lseqs):
            raise ValueError(f"{len(fseqs)} feature sequences vs {len(lseqs)} label")
        out = []
        for s in range(0, len(fseqs), self.batch_size):
            fs = fseqs[s:s + self.batch_size]
            ls = lseqs[s:s + self.batch_size]
            T = max(len(a) for a in fs)
            mb = len(fs)
            fdim = fs[0].shape[1]
            x = np.zeros((mb, T, fdim), np.float32)
            fm = np.zeros((mb, T), np.float32)
            if self.regression:
                ldim = ls[0].shape[1]
            else:
                ldim = self.num_classes
            y = np.zeros((mb, T, ldim), np.float32)
            lm = np.zeros((mb, T), np.float32)
            for i, (fa, la) in enumerate(zip(fs, ls)):
                x[i, :len(fa)] = fa
                fm[i, :len(fa)] = 1.0
                if self.regression:
                    y[i, :len(la)] = la
                else:
                    idx = la.astype(np.int32).reshape(-1)
                    y[i, np.arange(len(la)), idx] = 1.0
                lm[i, :len(la)] = 1.0
            out.append(DataSet(x, y, features_mask=fm, labels_mask=lm))
        return out
