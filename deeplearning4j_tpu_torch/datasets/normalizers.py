"""Data normalizers — fit statistics on an iterator, apply per batch (the
port of ``deeplearning4j_tpu/datasets/normalizers.py``).

Parity targets (nd4j dataset API, used by every reference example):
``NormalizerStandardize`` (zero-mean/unit-variance, optional label
normalization), ``NormalizerMinMaxScaler`` (range scaling),
``ImagePreProcessingScaler`` (pixel [0,255] → [min,max]), the
``DataSetIterator.setPreProcessor`` hook, ``revert*`` inverses, and
``NormalizerSerializer`` persistence (a model shipped for inference needs
its training-time statistics).

Normalizers are FUNCTIONAL — ``pre_process`` returns a new DataSet (the
reference mutates INDArrays in place).  Statistics are accumulated with a
streaming one-pass sum/sum-of-squares in f64 on the host, so fitting an
iterator never materializes the corpus; the host transforms are the
reference's numpy, bit for bit, and ``save``/``load`` write and read the
reference's ``.npz``.  ``device_transform()`` is the on-device path for a
``DevicePrefetchIterator``: the batch uploads raw or narrow and
normalizes on the card, as plain torch ops in f32 on the batch's device
(the reference's is a ``jax.jit`` of ``transform``, which XLA fuses; the
port keeps it plain PyTorch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .dataset import DataSet


class _Stats:
    """Streaming mean/std + min/max accumulator over [N, ...] batches,
    reduced over all axes except the trailing feature axes pattern used by
    DL4J: statistics are PER-FEATURE for rank-2 [mb, f], per-feature over
    (mb, t) for rank-3 [mb, t, f], and per-channel for rank-4 [mb, h, w, c].
    """

    def __init__(self):
        self.n = 0
        self.s1 = None
        self.s2 = None
        self.mn = None
        self.mx = None

    @staticmethod
    def _axes(arr: np.ndarray):
        return tuple(range(arr.ndim - 1))

    def update(self, arr: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """``mask`` [mb, t] (variable-length sequences, rank-3 data):
        zero-padded timesteps are EXCLUDED from the statistics — the
        reference's DistributionStats masked-fit semantics; padding zeros
        would otherwise pull means toward 0 and lock minima at 0."""
        a = np.asarray(arr, np.float64)
        axes = self._axes(a)
        if (mask is not None and a.ndim == 3
                and np.asarray(mask).shape == a.shape[:2]):
            w = np.asarray(mask, np.float64)[..., None]
            cnt = int(w.sum())
            s1 = (a * w).sum(axis=axes)
            s2 = (a * a * w).sum(axis=axes)
            live = w != 0
            mn = np.where(live, a, np.inf).min(axis=axes)
            mx = np.where(live, a, -np.inf).max(axis=axes)
        else:
            cnt = int(np.prod([a.shape[i] for i in axes])) if axes else 1
            s1 = a.sum(axis=axes)
            s2 = (a * a).sum(axis=axes)
            mn = a.min(axis=axes)
            mx = a.max(axis=axes)
        if self.s1 is None:
            self.n, self.s1, self.s2, self.mn, self.mx = cnt, s1, s2, mn, mx
        else:
            self.n += cnt
            self.s1 += s1
            self.s2 += s2
            self.mn = np.minimum(self.mn, mn)
            self.mx = np.maximum(self.mx, mx)

    @property
    def mean(self) -> np.ndarray:
        return self.s1 / max(self.n, 1)

    @property
    def std(self) -> np.ndarray:
        var = self.s2 / max(self.n, 1) - self.mean ** 2
        return np.sqrt(np.maximum(var, 0.0))


class AbstractNormalizer:
    """Shared fit/pre_process plumbing.  ``fit`` accepts a DataSet or any
    DataSetIterator; ``pre_process`` returns a NEW DataSet."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self._feat: Optional[_Stats] = None
        self._lab: Optional[_Stats] = None

    # -- fitting -----------------------------------------------------------

    def fit(self, data) -> "AbstractNormalizer":
        self._feat, self._lab = _Stats(), _Stats()
        for ds in self._iterate(data):
            self._feat.update(ds.features, ds.features_mask)
            if self.fit_labels and ds.labels is not None:
                self._lab.update(ds.labels, ds.labels_mask)
        if self._feat.s1 is None:
            raise ValueError("fit() saw no data")
        self._finalize()
        return self

    @staticmethod
    def _iterate(data):
        if isinstance(data, DataSet):
            yield data
            return
        # statistics must come from RAW data: if the source iterator
        # already has a normalizer attached (re-fit after more data, or a
        # second normalizer over the same iterator), suspend it for the
        # scan — fitting on transformed batches would yield a near-identity
        # normalizer silently
        pp = getattr(data, "pre_processor", None)
        if pp is not None:
            data.pre_processor = None
        try:
            for ds in data:
                yield ds
        finally:
            if pp is not None:
                data.pre_processor = pp

    def _finalize(self) -> None:
        pass

    def _check_fitted(self) -> None:
        if self._feat is None:
            raise ValueError(f"{type(self).__name__}: fit() before use "
                             "(or load() saved statistics)")

    # -- application -------------------------------------------------------

    def transform(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def revert_features(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_labels(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def revert_labels(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def pre_process(self, ds: DataSet) -> DataSet:
        """DataSet → normalized DataSet (the setPreProcessor hook target)."""
        self._check_fitted()
        labels = ds.labels
        if self.fit_labels and labels is not None:
            labels = self.transform_labels(np.asarray(labels))
        return DataSet(self.transform(np.asarray(ds.features)), labels,
                       ds.features_mask, ds.labels_mask)

    __call__ = pre_process

    def device_transform(self):
        """DataSet→DataSet transform for DEVICE-resident batches (the
        DevicePrefetchIterator hook): the fitted statistics move to the
        batch's device once (as float32 constants, at the first batch on
        that device) and the transform runs there as torch ops, in the
        reference's order of operations.  Masks pass through; labels
        transform only when ``fit_labels`` was set (a dict of labels entry
        by entry).

        Caveats: statistics are still FITTED on the host (``fit`` scans raw
        numpy batches in f64) — re-fitting needs a fresh device transform;
        and the device math runs in f32 (host numpy upcasts to f64 before
        the final f32 cast), so outputs can differ from ``pre_process`` by
        ~1 ulp unless the transform is exact (e.g. power-of-two pixel
        scales)."""
        self._check_fitted()
        fx = self._device_ops(labels=False)
        fy = self._device_ops(labels=True) if self.fit_labels else None
        consts: dict = {}

        def on(device, which, ops):
            key = (str(device), which)
            if key not in consts:
                consts[key] = [torch.as_tensor(np.asarray(c, np.float64), dtype=torch.float32,
                                               device=device) for c in ops[0]]
            return consts[key]

        def run(ops, which, a):
            if isinstance(a, dict):
                return {k: run(ops, which, v) for k, v in a.items()}
            return ops[1](a.to(torch.float32), *on(a.device, which, ops))

        def apply(ds: DataSet) -> DataSet:
            labels = ds.labels
            if fy is not None and labels is not None:
                labels = run(fy, "labels", labels)
            return DataSet(run(fx, "features", ds.features), labels,
                           ds.features_mask, ds.labels_mask)

        return apply

    def _device_ops(self, labels: bool):
        """→ (host constants, fn(x_f32, *constants on x's device)): the
        transform's arithmetic as the reference's jitted op runs it (the
        constants folded in f64 on the host, then float32)."""
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        self._check_fitted()
        labels = ds.labels
        if self.fit_labels and labels is not None:
            labels = self.revert_labels(np.asarray(labels))
        return DataSet(self.revert_features(np.asarray(ds.features)), labels,
                       ds.features_mask, ds.labels_mask)

    # -- persistence (NormalizerSerializer parity) -------------------------

    _SAVE_KEYS = ()

    def save(self, path: str) -> None:
        self._check_fitted()
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 __class__=np.bytes_(type(self).__name__),
                 fit_labels=np.asarray(self.fit_labels),
                 **{k: getattr(self, k) for k in self._SAVE_KEYS})

    @classmethod
    def load(cls, path: str) -> "AbstractNormalizer":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            saved_cls = z["__class__"].item().decode()
            if cls is AbstractNormalizer:
                # polymorphic restore (reference NormalizerSerializer.restore
                # reads the type header and dispatches); walk the whole
                # subclass tree so user classes deriving from a concrete
                # normalizer restore too
                def walk(c):
                    for s in c.__subclasses__():
                        yield s
                        yield from walk(s)
                by_name = {c.__name__: c for c in walk(cls)}
                if saved_cls not in by_name:
                    raise ValueError(f"{path} holds unknown normalizer "
                                     f"{saved_cls}")
                cls = by_name[saved_cls]
            if saved_cls != cls.__name__:
                raise ValueError(f"{path} holds a {saved_cls}, not {cls.__name__}")
            # bypass subclass __init__ (signatures differ — e.g.
            # ImagePreProcessingScaler takes no fit_labels); every field a
            # transform needs is in _SAVE_KEYS
            obj = cls.__new__(cls)
            AbstractNormalizer.__init__(obj, fit_labels=bool(z["fit_labels"]))
            obj._feat = _Stats()  # mark fitted
            for k in cls._SAVE_KEYS:
                setattr(obj, k, z[k])
        return obj


class NormalizerStandardize(AbstractNormalizer):
    """Zero-mean / unit-variance per feature (reference
    NormalizerStandardize; rank-3 stats pool over time, rank-4 per channel).
    """

    _SAVE_KEYS = ("mean", "std", "label_mean", "label_std")

    def __init__(self, fit_labels: bool = False):
        super().__init__(fit_labels)
        self.mean = self.std = self.label_mean = self.label_std = None

    def _finalize(self) -> None:
        self.mean = self._feat.mean
        self.std = np.maximum(self._feat.std, 1e-8)
        if self.fit_labels and self._lab.s1 is not None:
            self.label_mean = self._lab.mean
            self.label_std = np.maximum(self._lab.std, 1e-8)
        else:
            self.label_mean = np.zeros(1)
            self.label_std = np.ones(1)

    def transform(self, arr):
        return ((arr - self.mean) / self.std).astype(np.float32)

    def revert_features(self, arr):
        return (arr * self.std + self.mean).astype(np.float32)

    def transform_labels(self, arr):
        return ((arr - self.label_mean) / self.label_std).astype(np.float32)

    def revert_labels(self, arr):
        return (arr * self.label_std + self.label_mean).astype(np.float32)

    def _device_ops(self, labels: bool):
        mean, std = ((self.label_mean, self.label_std) if labels
                     else (self.mean, self.std))
        return (mean, std), lambda x, m, s: (x - m) / s


class NormalizerMinMaxScaler(AbstractNormalizer):
    """Scale features to [min_range, max_range] per feature (reference
    NormalizerMinMaxScaler, default [0, 1])."""

    _SAVE_KEYS = ("data_min", "data_max", "label_min", "label_max",
                  "min_range", "max_range")

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 fit_labels: bool = False):
        super().__init__(fit_labels)
        if max_range <= min_range:
            raise ValueError(f"max_range {max_range} <= min_range {min_range}")
        self.min_range = np.float64(min_range)
        self.max_range = np.float64(max_range)
        self.data_min = self.data_max = None
        self.label_min = self.label_max = None

    def _finalize(self) -> None:
        self.data_min = self._feat.mn
        self.data_max = self._feat.mx
        if self.fit_labels and self._lab.s1 is not None:
            self.label_min, self.label_max = self._lab.mn, self._lab.mx
        else:
            self.label_min, self.label_max = np.zeros(1), np.ones(1)

    @staticmethod
    def _scale(arr, lo, hi, a, b):
        span = np.maximum(hi - lo, 1e-12)
        return ((arr - lo) / span * (b - a) + a).astype(np.float32)

    @staticmethod
    def _unscale(arr, lo, hi, a, b):
        span = np.maximum(hi - lo, 1e-12)
        return ((arr - a) / (b - a) * span + lo).astype(np.float32)

    def transform(self, arr):
        return self._scale(arr, self.data_min, self.data_max,
                           self.min_range, self.max_range)

    def revert_features(self, arr):
        return self._unscale(arr, self.data_min, self.data_max,
                             self.min_range, self.max_range)

    def transform_labels(self, arr):
        return self._scale(arr, self.label_min, self.label_max,
                           self.min_range, self.max_range)

    def revert_labels(self, arr):
        return self._unscale(arr, self.label_min, self.label_max,
                             self.min_range, self.max_range)

    def _device_ops(self, labels: bool):
        lo, hi = ((self.label_min, self.label_max) if labels
                  else (self.data_min, self.data_max))
        span = np.maximum(hi - lo, 1e-12)
        return ((lo, span, self.max_range - self.min_range, self.min_range),
                lambda x, lo, span, scale, a: (x - lo) / span * scale + a)


class ImagePreProcessingScaler(AbstractNormalizer):
    """Pixels [0, max_pixel] → [min_range, max_range] (reference
    ImagePreProcessingScaler; stateless — no fit required)."""

    _SAVE_KEYS = ("min_range", "max_range", "max_pixel")

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        super().__init__(fit_labels=False)
        if max_range <= min_range:
            raise ValueError(f"max_range {max_range} <= min_range {min_range}")
        self.min_range = np.float64(min_range)
        self.max_range = np.float64(max_range)
        self.max_pixel = np.float64(max_pixel)
        self._feat = _Stats()  # stateless: always "fitted"

    def fit(self, data):  # fit is a no-op (kept for API parity)
        return self

    def transform(self, arr):
        return (arr / self.max_pixel
                * (self.max_range - self.min_range)
                + self.min_range).astype(np.float32)

    def revert_features(self, arr):
        return ((arr - self.min_range)
                / (self.max_range - self.min_range)
                * self.max_pixel).astype(np.float32)

    def _device_ops(self, labels: bool):
        return ((self.max_pixel, self.max_range - self.min_range, self.min_range),
                lambda x, mp, scale, a: x / mp * scale + a)
