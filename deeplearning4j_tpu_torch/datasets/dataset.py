"""DataSet / MultiDataSet — minibatch containers (mirrors
``deeplearning4j_tpu/datasets/dataset.py``).

Fields are numpy arrays or tensors on any device; the network moves them
to its own device.  ``get_rows``, ``split_test_and_train``, ``shuffle`` and
``batch_by`` index the fields, so they work on either; ``merge``
concatenates numpy arrays, as the reference's does.  Labels may be a dict
of arrays (``Yolo2OutputLayer``'s targets): these operations act on each
entry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np


def _pick(a, idx):
    """Rows ``idx`` of an array, tensor or dict of them (None stays None)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _pick(v, idx) for k, v in a.items()}
    return a[idx]


def _cat(xs):
    """Row-concatenation of numpy arrays (or of dicts of them, entrywise)."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], dict):
        return {k: _cat([x[k] for x in xs]) for k in xs[0]}
    return np.concatenate(xs, axis=0)


@dataclasses.dataclass
class DataSet:
    features: Any
    labels: Optional[Any] = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def get_rows(self, idx) -> "DataSet":
        """Row-select all four fields by an index array or permutation."""
        return DataSet(self.features[idx], _pick(self.labels, idx),
                       _pick(self.features_mask, idx), _pick(self.labels_mask, idx))

    def split_test_and_train(self, n_train: int) -> tuple["DataSet", "DataSet"]:
        def cut(a, lo, hi):
            return _pick(a, slice(lo, hi))
        n = self.num_examples()
        return (
            DataSet(self.features[:n_train], cut(self.labels, 0, n_train),
                    cut(self.features_mask, 0, n_train), cut(self.labels_mask, 0, n_train)),
            DataSet(self.features[n_train:], cut(self.labels, n_train, n),
                    cut(self.features_mask, n_train, n), cut(self.labels_mask, n_train, n)),
        )

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        """Rows in the permutation numpy's ``default_rng(seed)`` gives (the
        reference's, so a seed orders both packages' batches alike)."""
        rng = np.random.default_rng(seed)
        return self.get_rows(rng.permutation(self.num_examples()))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            cut = lambda a: _pick(a, slice(i, i + batch_size))  # noqa: E731
            out.append(DataSet(self.features[i:i + batch_size], cut(self.labels),
                               cut(self.features_mask), cut(self.labels_mask)))
        return out

    @staticmethod
    def merge(sets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in sets], axis=0),
            _cat([d.labels for d in sets]),
            _cat([d.features_mask for d in sets]),
            _cat([d.labels_mask for d in sets]),
        )


@dataclasses.dataclass
class MultiDataSet:
    features: List[Any]
    labels: List[Any]
    features_masks: Optional[List[Optional[Any]]] = None
    labels_masks: Optional[List[Optional[Any]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
