"""Regression metrics — parity with reference eval/RegressionEvaluation.java:
per-column MSE, MAE, RMSE, RSE, PC (Pearson correlation), R².  Streaming
accumulation via sufficient statistics so batches merge exactly.

A copy of ``deeplearning4j_tpu/evaluation/regression.py`` (numpy on the
host; the port keeps its own, so the numbers are the reference's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n_columns = n_columns
        self._init = False

    def _ensure(self, n: int) -> None:
        if not self._init:
            self.n_columns = n
            z = lambda: np.zeros(n, dtype=np.float64)
            self.count = z()
            self.sum_err2 = z()       # Σ(y-ŷ)²
            self.sum_abs_err = z()    # Σ|y-ŷ|
            self.sum_y = z()
            self.sum_y2 = z()
            self.sum_p = z()
            self.sum_p2 = z()
            self.sum_yp = z()
            self._init = True

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.asarray(labels, dtype=np.float64)
        p = np.asarray(predictions, dtype=np.float64)
        if y.ndim == 3:
            c = y.shape[-1]
            y, p = y.reshape(-1, c), p.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                y, p = y[m], p[m]
        self._ensure(y.shape[-1])
        err = y - p
        self.count += y.shape[0]
        self.sum_err2 += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_y += y.sum(0)
        self.sum_y2 += (y ** 2).sum(0)
        self.sum_p += p.sum(0)
        self.sum_p2 += (p ** 2).sum(0)
        self.sum_yp += (y * p).sum(0)

    def merge(self, other: "RegressionEvaluation") -> None:
        if not getattr(other, "_init", False):
            return
        if not self._init:
            self._ensure(other.n_columns)
        for f in ("count", "sum_err2", "sum_abs_err", "sum_y", "sum_y2",
                  "sum_p", "sum_p2", "sum_yp"):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / max(self.count[col], 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / max(self.count[col], 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int = 0) -> float:
        n = self.count[col]
        mean_y = self.sum_y[col] / n
        ss_tot = self.sum_y2[col] - n * mean_y ** 2
        return float(self.sum_err2[col] / ss_tot) if ss_tot else float("inf")

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.count[col]
        cov = self.sum_yp[col] - self.sum_y[col] * self.sum_p[col] / n
        vy = self.sum_y2[col] - self.sum_y[col] ** 2 / n
        vp = self.sum_p2[col] - self.sum_p[col] ** 2 / n
        denom = np.sqrt(vy * vp)
        return float(cov / denom) if denom else 0.0

    def r_squared(self, col: int = 0) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err2 / np.maximum(self.count, 1)))

    def stats(self) -> str:
        cols = range(self.n_columns)
        lines = ["Column    MSE          MAE          RMSE         RSE          PC           R^2"]
        for c in cols:
            lines.append(
                f"col_{c:<5} {self.mean_squared_error(c):<12.5g} {self.mean_absolute_error(c):<12.5g} "
                f"{self.root_mean_squared_error(c):<12.5g} {self.relative_squared_error(c):<12.5g} "
                f"{self.pearson_correlation(c):<12.5g} {self.r_squared(c):<12.5g}")
        return "\n".join(lines)
