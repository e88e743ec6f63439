"""Regression evaluation: MSE, MAE, RMSE, RSE, PC (Pearson), R².

Reference: ``eval/RegressionEvaluation.java`` — per-column accumulators,
merge-able (sum of sufficient statistics).

Counterpart of ``deeplearning4j_tpu/evaluation/regression.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import as_array


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.n_columns = n_columns
        self._init_done = False

    def _ensure(self, c: int):
        if not self._init_done:
            self.n_columns = self.n_columns or c
            z = np.zeros(self.n_columns, dtype=np.float64)
            self.sum_err_sq = z.copy()
            self.sum_abs_err = z.copy()
            self.sum_label = z.copy()
            self.sum_label_sq = z.copy()
            self.sum_pred = z.copy()
            self.sum_pred_sq = z.copy()
            self.sum_label_pred = z.copy()
            self.count = np.zeros(self.n_columns, dtype=np.int64)
            self._init_done = True

    def eval(self, labels, predictions, mask=None) -> None:
        labels = as_array(labels, np.float64)
        predictions = as_array(predictions, np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = as_array(mask).reshape(b * t).astype(bool)
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[1])
        err = predictions - labels
        self.sum_err_sq += np.sum(err**2, axis=0)
        self.sum_abs_err += np.sum(np.abs(err), axis=0)
        self.sum_label += labels.sum(axis=0)
        self.sum_label_sq += np.sum(labels**2, axis=0)
        self.sum_pred += predictions.sum(axis=0)
        self.sum_pred_sq += np.sum(predictions**2, axis=0)
        self.sum_label_pred += np.sum(labels * predictions, axis=0)
        self.count += labels.shape[0]

    def merge(self, other: "RegressionEvaluation") -> None:
        if not other._init_done:
            return
        if not self._init_done:
            self._ensure(other.n_columns)
        for attr in ("sum_err_sq", "sum_abs_err", "sum_label", "sum_label_sq",
                     "sum_pred", "sum_pred_sq", "sum_label_pred", "count"):
            setattr(self, attr, getattr(self, attr) + getattr(other, attr))

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err_sq[col] / self.count[col])

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        ss_tot = self.sum_label_sq[col] - n * mean_label**2
        ss_res = self.sum_err_sq[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err_sq / self.count))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self.sum_abs_err / self.count))

    def stats(self) -> str:
        cols = range(self.n_columns)
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in cols:
            lines.append(
                f"{c:<9} {self.mean_squared_error(c):<14.6f} {self.mean_absolute_error(c):<14.6f} "
                f"{self.root_mean_squared_error(c):<14.6f} {self.r_squared(c):<10.6f}"
            )
        return "\n".join(lines)
