"""DataSet — one minibatch (mirrors ``deeplearning4j_tpu/datasets/dataset.py``;
the four fields ``fit_batch`` and ``score`` read).

Fields are numpy arrays or tensors on any device; the network moves them
to its own device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class DataSet:
    features: Any
    labels: Optional[Any] = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])
