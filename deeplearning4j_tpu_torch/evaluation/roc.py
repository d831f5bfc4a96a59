"""ROC / AUC — parity with reference eval/ROC.java (706 LoC), ROCBinary,
ROCMultiClass.

Like the reference's thresholded mode, probabilities are bucketed into
``threshold_steps`` bins so accumulation is streaming and mergeable; AUC is
computed by trapezoidal integration over the resulting curve.  (The
reference also has an exact mode; the binned mode is the default there too
for large data.)

A copy of ``deeplearning4j_tpu/evaluation/roc.py`` (numpy on the
host; the port keeps its own, so the numbers are the reference's).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ROC:
    """Binary ROC: labels [n] or [n,1] in {0,1} (or two-column one-hot with
    column 1 = positive, reference convention)."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        # counts[i] accumulates at threshold i/steps
        self.tp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.pos = 0
        self.neg = 0

    @staticmethod
    def _binary_prob(labels, predictions) -> Tuple[np.ndarray, np.ndarray]:
        y = np.asarray(labels)
        p = np.asarray(predictions)
        if y.ndim == 2 and y.shape[1] == 2:
            y, p = y[:, 1], p[:, 1]
        elif y.ndim == 2 and y.shape[1] == 1:
            y, p = y[:, 0], p[:, 0]
        return y.astype(np.float64), p.astype(np.float64)

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = self._binary_prob(labels, predictions)
        thresholds = np.linspace(0.0, 1.0, self.steps + 1)
        pos_mask = y >= 0.5
        self.pos += int(pos_mask.sum())
        self.neg += int((~pos_mask).sum())
        # vectorized: for each threshold, count p >= t among pos/neg
        p_pos = np.sort(p[pos_mask])
        p_neg = np.sort(p[~pos_mask])
        self.tp += len(p_pos) - np.searchsorted(p_pos, thresholds, side="left")
        self.fp += len(p_neg) - np.searchsorted(p_neg, thresholds, side="left")

    def merge(self, other: "ROC") -> None:
        self.tp += other.tp
        self.fp += other.fp
        self.pos += other.pos
        self.neg += other.neg

    def get_roc_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        tpr = self.tp / max(self.pos, 1)
        fpr = self.fp / max(self.neg, 1)
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self.get_roc_curve()
        order = np.argsort(fpr, kind="stable")
        return float(np.trapezoid(tpr[order], fpr[order]))

    def calculate_auprc(self) -> float:
        """Area under precision-recall curve (reference calculateAUCPR)."""
        tp = self.tp.astype(np.float64)
        fp = self.fp.astype(np.float64)
        recall = tp / max(self.pos, 1)
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 1.0)
        order = np.argsort(recall, kind="stable")
        return float(np.trapezoid(precision[order], recall[order]))


class ROCBinary:
    """Per-output-column binary ROC (reference ROCBinary: multi-label)."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self.rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.atleast_2d(np.asarray(labels))
        p = np.atleast_2d(np.asarray(predictions))
        if self.rocs is None:
            self.rocs = [ROC(self.steps) for _ in range(y.shape[1])]
        for i, roc in enumerate(self.rocs):
            roc.eval(y[:, i], p[:, i])

    def calculate_auc(self, col: int) -> float:
        return self.rocs[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass)."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self.rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.asarray(labels)
        p = np.asarray(predictions)
        if y.ndim == 3:
            c = y.shape[-1]
            y, p = y.reshape(-1, c), p.reshape(-1, c)
        if self.rocs is None:
            self.rocs = [ROC(self.steps) for _ in range(y.shape[1])]
        for i, roc in enumerate(self.rocs):
            roc.eval(y[:, i], p[:, i])

    def calculate_auc(self, cls: int) -> float:
        return self.rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))
