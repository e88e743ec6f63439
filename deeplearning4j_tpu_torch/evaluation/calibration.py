"""Calibration evaluation (reference ``eval/EvaluationCalibration.java``):
reliability diagram bins, residual-probability histogram, expected
calibration error.

Counterpart of ``deeplearning4j_tpu/evaluation/calibration.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import as_array


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = int(reliability_bins)
        self.histogram_bins = int(histogram_bins)
        self._init_done = False

    def _ensure(self, c: int):
        if not self._init_done:
            self.n_classes = c
            self.bin_counts = np.zeros((c, self.reliability_bins), np.int64)
            self.bin_pos = np.zeros((c, self.reliability_bins), np.int64)
            self.bin_prob_sum = np.zeros((c, self.reliability_bins), np.float64)
            self.residual_hist = np.zeros(self.histogram_bins, np.int64)
            self.prob_hist = np.zeros((c, self.histogram_bins), np.int64)
            self._init_done = True

    def eval(self, labels, predictions, mask=None) -> None:
        labels = as_array(labels)
        p = as_array(predictions)
        if mask is not None:
            m = as_array(mask).reshape(-1).astype(bool)
            labels, p = labels[m], p[m]
        self._ensure(p.shape[1])
        bins = np.clip((p * self.reliability_bins).astype(int), 0, self.reliability_bins - 1)
        for c in range(self.n_classes):
            np.add.at(self.bin_counts[c], bins[:, c], 1)
            np.add.at(self.bin_pos[c], bins[:, c], (labels[:, c] > 0.5).astype(np.int64))
            np.add.at(self.bin_prob_sum[c], bins[:, c], p[:, c])
            hb = np.clip((p[:, c] * self.histogram_bins).astype(int), 0, self.histogram_bins - 1)
            np.add.at(self.prob_hist[c], hb, 1)
        resid = np.abs(labels - p).reshape(-1)
        rb = np.clip((resid * self.histogram_bins).astype(int), 0, self.histogram_bins - 1)
        np.add.at(self.residual_hist, rb, 1)

    def reliability_curve(self, cls: int):
        """(mean predicted prob, empirical frequency) per bin."""
        cnt = np.maximum(self.bin_counts[cls], 1)
        mean_p = self.bin_prob_sum[cls] / cnt
        freq = self.bin_pos[cls] / cnt
        return mean_p, freq, self.bin_counts[cls]

    def expected_calibration_error(self, cls: int = 0) -> float:
        mean_p, freq, counts = self.reliability_curve(cls)
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(mean_p - freq)))

    def merge(self, other: "EvaluationCalibration") -> None:
        if not other._init_done:
            return
        if not self._init_done:
            self._ensure(other.n_classes)
        self.bin_counts += other.bin_counts
        self.bin_pos += other.bin_pos
        self.bin_prob_sum += other.bin_prob_sum
        self.residual_hist += other.residual_hist
        self.prob_hist += other.prob_hist
