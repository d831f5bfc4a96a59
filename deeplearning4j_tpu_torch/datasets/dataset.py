"""DataSet / MultiDataSet — minibatch containers (mirrors
``deeplearning4j_tpu/datasets/dataset.py``).

Fields are numpy arrays or tensors on any device; the network moves them
to its own device.  ``get_rows``, ``split_test_and_train``, ``shuffle`` and
``batch_by`` index the fields, so they work on either; ``merge``
concatenates numpy arrays, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np


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
        pick = lambda a: None if a is None else a[idx]  # noqa: E731
        return DataSet(self.features[idx], pick(self.labels),
                       pick(self.features_mask), pick(self.labels_mask))

    def split_test_and_train(self, n_train: int) -> tuple["DataSet", "DataSet"]:
        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]
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
            cut = lambda a: None if a is None else a[i:i + batch_size]  # noqa: E731
            out.append(DataSet(self.features[i:i + batch_size], cut(self.labels),
                               cut(self.features_mask), cut(self.labels_mask)))
        return out

    @staticmethod
    def merge(sets: Sequence["DataSet"]) -> "DataSet":
        cat = lambda xs: None if xs[0] is None else np.concatenate(xs, axis=0)  # noqa: E731
        return DataSet(
            np.concatenate([d.features for d in sets], axis=0),
            cat([d.labels for d in sets]),
            cat([d.features_mask for d in sets]),
            cat([d.labels_mask for d in sets]),
        )


@dataclasses.dataclass
class MultiDataSet:
    features: List[Any]
    labels: List[Any]
    features_masks: Optional[List[Optional[Any]]] = None
    labels_masks: Optional[List[Optional[Any]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
