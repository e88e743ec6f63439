"""ROC / AUC evaluation — exact (threshold per distinct score) and
thresholded (fixed steps) modes, plus per-class multiclass and multilabel
binary variants.

Reference: ``eval/ROC.java`` (720 LoC; thresholdSteps=0 → exact mode),
``eval/ROCMultiClass.java``, ``eval/ROCBinary.java``. AUROC via
trapezoidal integration; AUPRC likewise over the PR curve. Merge-able:
exact mode concatenates score/label buffers, thresholded mode sums count
bins.

Counterpart of ``deeplearning4j_tpu/evaluation/roc.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import as_array


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(x)
    return float(np.trapezoid(y[order], x[order]))


class ROC:
    """Binary ROC. probs column convention: predictions (n,1) prob of class 1
    or (n,2) [P(0), P(1)] (reference single/two-column support)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)  # 0 → exact
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        # thresholded mode bins
        if self.threshold_steps > 0:
            n = self.threshold_steps + 1
            self._tp = np.zeros(n, np.int64)
            self._fp = np.zeros(n, np.int64)
            self._pos = 0
            self._neg = 0

    def eval(self, labels, predictions, mask=None) -> None:
        labels = as_array(labels)
        predictions = as_array(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            y = labels[:, 1]
        else:
            y = labels.reshape(-1)
        if predictions.ndim == 2 and predictions.shape[1] == 2:
            p = predictions[:, 1]
        else:
            p = predictions.reshape(-1)
        if mask is not None:
            m = as_array(mask).reshape(-1).astype(bool)
            y, p = y[m], p[m]
        if self.threshold_steps > 0:
            th = np.linspace(0, 1, self.threshold_steps + 1)
            pos = y > 0.5
            self._pos += int(pos.sum())
            self._neg += int((~pos).sum())
            for i, t in enumerate(th):
                pred_pos = p >= t
                self._tp[i] += int(np.sum(pred_pos & pos))
                self._fp[i] += int(np.sum(pred_pos & ~pos))
        else:
            self._scores.append(p.astype(np.float64))
            self._labels.append(y.astype(np.float64))

    def _exact_curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = np.concatenate(self._scores)
        y = np.concatenate(self._labels)
        order = np.argsort(-s)
        y = y[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        P, N = tps[-1], fps[-1]
        tpr = np.concatenate([[0], tps / max(P, 1)])
        fpr = np.concatenate([[0], fps / max(N, 1)])
        prec = np.concatenate([[1], tps / np.maximum(tps + fps, 1)])
        return fpr, tpr, prec

    def calculate_auc(self) -> float:
        if self.threshold_steps > 0:
            tpr = np.concatenate([[0], (self._tp / max(self._pos, 1))[::-1], [1]])
            fpr = np.concatenate([[0], (self._fp / max(self._neg, 1))[::-1], [1]])
            return _auc(fpr, tpr)
        fpr, tpr, _ = self._exact_curve()
        return _auc(fpr, tpr)

    def calculate_auprc(self) -> float:
        if self.threshold_steps > 0:
            rec = (self._tp / max(self._pos, 1))[::-1]
            prec = (self._tp / np.maximum(self._tp + self._fp, 1))[::-1]
            return _auc(np.concatenate([[0], rec]), np.concatenate([[1], prec]))
        fpr, tpr, prec = self._exact_curve()
        return _auc(tpr, prec)

    def get_roc_curve(self):
        if self.threshold_steps > 0:
            raise ValueError("curve export supported in exact mode")
        fpr, tpr, _ = self._exact_curve()
        return fpr, tpr

    def get_precision_recall_curve(self):
        """(recall, precision) points of the exact PR curve (reference
        ``PrecisionRecallCurve`` returned by
        ``ROC.getPrecisionRecallCurve()``; area = calculate_auprc)."""
        if self.threshold_steps > 0:
            raise ValueError("curve export supported in exact mode")
        _, tpr, prec = self._exact_curve()
        return tpr, prec

    def merge(self, other: "ROC") -> None:
        if self.threshold_steps != other.threshold_steps:
            raise ValueError("Cannot merge ROC with different threshold modes")
        if self.threshold_steps > 0:
            self._tp += other._tp
            self._fp += other._fp
            self._pos += other._pos
            self._neg += other._neg
        else:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)


class ROCMultiClass:
    """One-vs-all ROC per class (reference ``ROCMultiClass``)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = as_array(labels)
        predictions = as_array(predictions)
        c = labels.shape[1]
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(c)]
        for i in range(c):
            self._rocs[i].eval(labels[:, i], predictions[:, i], mask)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def merge(self, other: "ROCMultiClass") -> None:
        if other._rocs is None:
            return
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in other._rocs]
        for a, b in zip(self._rocs, other._rocs):
            a.merge(b)


class ROCBinary(ROCMultiClass):
    """Per-output independent binary ROC (multilabel; reference
    ``ROCBinary``). Same accumulation as one-vs-all."""
