"""EvaluationBinary — per-output binary classification metrics.

Parity with reference eval/EvaluationBinary.java: independent binary
accuracy/precision/recall/F1 per output column (multi-label networks with
sigmoid outputs), with optional decision threshold per column.

A copy of ``deeplearning4j_tpu/evaluation/binary.py`` (numpy on the
host; the port keeps its own, so the numbers are the reference's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvaluationBinary:
    def __init__(self, n_columns: Optional[int] = None, decision_threshold: float = 0.5):
        self.n_columns = n_columns
        self.threshold = decision_threshold
        self._init = False

    def _ensure(self, n: int) -> None:
        if not self._init:
            self.n_columns = n
            z = lambda: np.zeros(n, dtype=np.int64)
            self.tp, self.fp, self.tn, self.fn = z(), z(), z(), z()
            self._init = True

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.atleast_2d(np.asarray(labels))
        p = np.atleast_2d(np.asarray(predictions))
        if y.ndim == 3:
            c = y.shape[-1]
            y, p = y.reshape(-1, c), p.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                y, p = y[m], p[m]
        self._ensure(y.shape[1])
        yb = y >= 0.5
        pb = p >= self.threshold
        self.tp += (yb & pb).sum(0)
        self.fp += (~yb & pb).sum(0)
        self.tn += (~yb & ~pb).sum(0)
        self.fn += (yb & ~pb).sum(0)

    def merge(self, other: "EvaluationBinary") -> None:
        if not other._init:
            return
        if not self._init:
            self._ensure(other.n_columns)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn

    def accuracy(self, col: int = 0) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / max(total, 1))

    def precision(self, col: int = 0) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col] / d) if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col] / d) if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        lines = ["Column    Accuracy     Precision    Recall       F1"]
        for c in range(self.n_columns):
            lines.append(f"col_{c:<5} {self.accuracy(c):<12.4f} {self.precision(c):<12.4f} "
                         f"{self.recall(c):<12.4f} {self.f1(c):<12.4f}")
        return "\n".join(lines)
