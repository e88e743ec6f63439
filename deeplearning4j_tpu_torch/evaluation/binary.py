"""Multilabel binary evaluation (reference ``eval/EvaluationBinary.java``):
per-output TP/FP/TN/FN counts with an optional decision threshold.

Counterpart of ``deeplearning4j_tpu/evaluation/binary.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import as_array


class EvaluationBinary:
    def __init__(self, n_outputs: Optional[int] = None, decision_threshold: float = 0.5):
        self.n_outputs = n_outputs
        self.threshold = float(decision_threshold)
        self._init_done = False

    def _ensure(self, c: int):
        if not self._init_done:
            self.n_outputs = self.n_outputs or c
            z = np.zeros(self.n_outputs, np.int64)
            self.tp, self.fp, self.tn, self.fn = z.copy(), z.copy(), z.copy(), z.copy()
            self._init_done = True

    def eval(self, labels, predictions, mask=None) -> None:
        labels = as_array(labels)
        predictions = as_array(predictions)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = as_array(mask).reshape(b * t).astype(bool)
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[1])
        pred = predictions >= self.threshold
        act = labels > 0.5
        self.tp += np.sum(pred & act, axis=0)
        self.fp += np.sum(pred & ~act, axis=0)
        self.tn += np.sum(~pred & ~act, axis=0)
        self.fn += np.sum(~pred & act, axis=0)

    def merge(self, other: "EvaluationBinary") -> None:
        if not other._init_done:
            return
        if not self._init_done:
            self._ensure(other.n_outputs)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn

    def accuracy(self, out: int = 0) -> float:
        tot = self.tp[out] + self.fp[out] + self.tn[out] + self.fn[out]
        return float((self.tp[out] + self.tn[out]) / tot) if tot else 0.0

    def precision(self, out: int = 0) -> float:
        d = self.tp[out] + self.fp[out]
        return float(self.tp[out] / d) if d else 0.0

    def recall(self, out: int = 0) -> float:
        d = self.tp[out] + self.fn[out]
        return float(self.tp[out] / d) if d else 0.0

    def f1(self, out: int = 0) -> float:
        p, r = self.precision(out), self.recall(out)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        lines = ["Output  Acc     Precision  Recall  F1"]
        for i in range(self.n_outputs):
            lines.append(
                f"{i:<7} {self.accuracy(i):<7.4f} {self.precision(i):<10.4f} "
                f"{self.recall(i):<7.4f} {self.f1(i):<7.4f}"
            )
        return "\n".join(lines)
