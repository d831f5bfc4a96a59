"""EvaluationCalibration — reliability diagram + histogram data.

Parity with reference eval/EvaluationCalibration.java: accumulates
reliability-diagram bins (mean predicted probability vs. observed frequency
per bin), residual-plot and probability histograms.

A copy of ``deeplearning4j_tpu/evaluation/calibration.py`` (numpy on the
host; the port keeps its own, so the numbers are the reference's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.n_bins = reliability_bins
        self.hist_bins = histogram_bins
        self._init = False

    def _ensure(self, n_classes: int) -> None:
        if not self._init:
            self.n_classes = n_classes
            self.bin_counts = np.zeros((n_classes, self.n_bins), dtype=np.int64)
            self.bin_pos = np.zeros((n_classes, self.n_bins), dtype=np.int64)
            self.bin_prob_sum = np.zeros((n_classes, self.n_bins), dtype=np.float64)
            self.prob_hist = np.zeros((n_classes, self.hist_bins), dtype=np.int64)
            self._init = True

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.asarray(labels)
        p = np.asarray(predictions)
        if y.ndim == 3:
            c = y.shape[-1]
            y, p = y.reshape(-1, c), p.reshape(-1, c)
        self._ensure(y.shape[1])
        bins = np.clip((p * self.n_bins).astype(int), 0, self.n_bins - 1)
        hbins = np.clip((p * self.hist_bins).astype(int), 0, self.hist_bins - 1)
        for c in range(self.n_classes):
            np.add.at(self.bin_counts[c], bins[:, c], 1)
            np.add.at(self.bin_pos[c], bins[:, c], (y[:, c] >= 0.5).astype(np.int64))
            np.add.at(self.bin_prob_sum[c], bins[:, c], p[:, c])
            np.add.at(self.prob_hist[c], hbins[:, c], 1)

    def reliability_diagram(self, cls: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mean predicted prob, observed frequency) per bin."""
        counts = np.maximum(self.bin_counts[cls], 1)
        mean_pred = self.bin_prob_sum[cls] / counts
        obs_freq = self.bin_pos[cls] / counts
        return mean_pred, obs_freq

    def expected_calibration_error(self, cls: int) -> float:
        counts = self.bin_counts[cls]
        total = max(counts.sum(), 1)
        mean_pred, obs_freq = self.reliability_diagram(cls)
        return float(np.sum(counts / total * np.abs(mean_pred - obs_freq)))
