"""Classification evaluation — accuracy/precision/recall/F1/confusion (a
copy of ``deeplearning4j_tpu/evaluation/evaluation.py``; the port keeps
its own, so ``stats()`` prints the reference's text).

Parity target: reference eval/Evaluation.java (1,627 LoC) + ConfusionMatrix.
Streamable (eval() accumulates per batch) and mergeable (merge()), the two
properties Spark/parallel evaluation rely on
(spark: IEvaluateFlatMapFunction aggregates Evaluation objects).
Accumulation is numpy on the host — metric math is not device work.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ConfusionMatrix:
    """Dense class-by-class count matrix (reference eval/ConfusionMatrix.java)."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def grow_to(self, n: int) -> None:
        if n > self.n_classes:
            m = np.zeros((n, n), dtype=np.int64)
            m[: self.n_classes, : self.n_classes] = self.matrix
            self.matrix = m
            self.n_classes = n

    def add(self, actual: np.ndarray, predicted: np.ndarray) -> None:
        hi = int(max(actual.max(initial=-1), predicted.max(initial=-1))) + 1
        self.grow_to(hi)
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix") -> None:
        self.grow_to(other.n_classes)
        self.matrix[: other.n_classes, : other.n_classes] += other.matrix


class Evaluation:
    """Multiclass classification metrics (reference eval/Evaluation.java).

    ``eval(labels, predictions)`` accepts one-hot or index labels and
    probability or index predictions; rank-3 ``[mb, t, c]`` time series are
    flattened with the labels mask applied (reference evalTimeSeries).
    """

    def __init__(self, n_classes: Optional[int] = None):
        self.n_classes = n_classes
        self.confusion: Optional[ConfusionMatrix] = None

    # -- accumulation ------------------------------------------------------
    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # [mb, t, c] time series
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:  # per-example mask on 2-D labels
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        actual = labels.argmax(-1) if labels.ndim == 2 else labels.astype(np.int64)
        pred = predictions.argmax(-1) if predictions.ndim == 2 else predictions.astype(np.int64)
        if self.confusion is None:
            n = self.n_classes or int(max(labels.shape[-1] if labels.ndim == 2 else actual.max() + 1,
                                          predictions.shape[-1] if predictions.ndim == 2 else pred.max() + 1))
            self.n_classes = n
            self.confusion = ConfusionMatrix(n)
        self.confusion.add(actual, pred)
        self.n_classes = self.confusion.n_classes  # may have grown (index labels)

    def merge(self, other: "Evaluation") -> None:
        if other.confusion is None:
            return
        if self.confusion is None:
            self.n_classes = other.n_classes
            self.confusion = ConfusionMatrix(other.n_classes)
        self.confusion.merge(other.confusion)
        self.n_classes = self.confusion.n_classes

    # -- per-class counts --------------------------------------------------
    def _m(self) -> np.ndarray:
        if self.confusion is None:
            raise ValueError("no data accumulated; call eval() first")
        return self.confusion.matrix

    def true_positives(self) -> np.ndarray:
        return np.diag(self._m())

    def false_positives(self) -> np.ndarray:
        return self._m().sum(0) - np.diag(self._m())

    def false_negatives(self) -> np.ndarray:
        return self._m().sum(1) - np.diag(self._m())

    def true_negatives(self) -> np.ndarray:
        total = self._m().sum()
        return total - self.true_positives() - self.false_positives() - self.false_negatives()

    # -- aggregate metrics -------------------------------------------------
    def accuracy(self) -> float:
        m = self._m()
        return float(np.diag(m).sum() / max(m.sum(), 1))

    def precision(self, cls: Optional[int] = None) -> float:
        tp, fp = self.true_positives(), self.false_positives()
        if cls is not None:
            denom = tp[cls] + fp[cls]
            return float(tp[cls] / denom) if denom else 0.0
        # macro-average over classes that appear (reference: excludes classes
        # with no predictions from the average)
        denom = tp + fp
        valid = denom > 0
        return float(np.mean(tp[valid] / denom[valid])) if valid.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        tp, fn = self.true_positives(), self.false_negatives()
        if cls is not None:
            denom = tp[cls] + fn[cls]
            return float(tp[cls] / denom) if denom else 0.0
        denom = tp + fn
        valid = denom > 0
        return float(np.mean(tp[valid] / denom[valid])) if valid.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp = float(self.true_positives()[cls])
        tn = float(self.true_negatives()[cls])
        fp = float(self.false_positives()[cls])
        fn = float(self.false_negatives()[cls])
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / denom if denom else 0.0

    def stats(self) -> str:
        """Printable summary (reference Evaluation.stats())."""
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.n_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "=================================================================",
        ]
        return "\n".join(lines)
