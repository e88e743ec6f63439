"""Classification evaluation: accuracy/precision/recall/F1, confusion
matrix, top-N accuracy — merge-able for distributed eval.

Reference: ``eval/Evaluation.java`` (1,774 LoC), ``eval/ConfusionMatrix.java``.
Accumulation is a (numClasses × numClasses) count matrix, so ``merge()`` is
a sum — the property the reference relies on for distributed evaluation
(``IEvaluateFlatMapFunction``) and we rely on for multi-host eval.

Sequence labels (b, T, C) are flattened over time with the label mask
applied, matching reference time-series evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/classification.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def as_array(a, dtype=None) -> np.ndarray:
    """``a`` (numpy, a list, or a torch tensor anywhere, bf16/f16 widened to
    f32) as a numpy array of ``dtype``."""
    if hasattr(a, "detach"):  # a torch tensor: this module does not import torch
        a = a.detach()
        if a.dtype.is_floating_point and a.element_size() < 4:
            a = a.float()
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray) -> None:
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix") -> None:
        self.matrix += other.matrix

    def __str__(self):
        return str(self.matrix)


class Prediction:
    """One recorded (actual, predicted, metadata) triple (reference
    ``eval/meta/Prediction`` — the record-metadata error-inspection
    surface)."""

    def __init__(self, actual: int, predicted: int, record_meta_data=None):
        self.actual = int(actual)
        self.predicted = int(predicted)
        self.record_meta_data = record_meta_data

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, "
                f"predicted={self.predicted}, "
                f"meta={self.record_meta_data!r})")


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = list(labels) if labels else None
        self.top_n = int(top_n)
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0
        self._predictions: List[Prediction] = []

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None,
             record_meta_data: Optional[Sequence] = None) -> None:
        """``record_meta_data``: optional per-example metadata (any
        objects, e.g. source-record indices); when given, per-example
        Predictions are recorded for the error-inspection getters
        (reference ``eval(labels, preds, metaData)``). Not supported
        together with time-series inputs."""
        labels = as_array(labels)
        predictions = as_array(predictions)
        if record_meta_data is not None and labels.ndim == 3:
            raise ValueError(
                "record_meta_data is per example; time-series inputs "
                "flatten over time")
        if labels.ndim == 3:  # (b, T, C) time series → flatten with mask
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = as_array(mask).reshape(b * t).astype(bool)
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = as_array(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
            if record_meta_data is not None:
                record_meta_data = [r for r, keep in
                                    zip(record_meta_data, m) if keep]
        if labels.ndim == 2 and labels.shape[1] > 1:
            actual = np.argmax(labels, axis=1)
        else:
            actual = labels.reshape(-1).astype(np.int64)
        if record_meta_data is not None and \
                len(record_meta_data) != len(actual):
            # validate before ANY mutation (incl. _ensure pinning
            # num_classes) so a failed eval() leaves the Evaluation
            # truly unchanged
            raise ValueError(
                f"record_meta_data has {len(record_meta_data)} "
                f"entries for {len(actual)} (unmasked) examples")
        if predictions.ndim == 2 and predictions.shape[1] == 1:
            # single sigmoid output: threshold at 0.5 (reference Evaluation
            # single-column handling), confusion matrix is 2x2
            pred_cls = (predictions[:, 0] >= 0.5).astype(np.int64)
            self._ensure(2)
        else:
            pred_cls = np.argmax(predictions, axis=1)
            self._ensure(predictions.shape[1])
        self.confusion.add(actual, pred_cls)
        if record_meta_data is not None:
            self._predictions.extend(
                Prediction(a, p, m) for a, p, m in
                zip(actual, pred_cls, record_meta_data))
        if self.top_n > 1:
            probs = predictions
            if probs.ndim == 2 and probs.shape[1] == 1:
                # single sigmoid column → explicit 2-class probabilities so
                # the top-N ranking is over real classes, not one column
                probs = np.concatenate([1.0 - probs, probs], axis=1)
            top = np.argsort(-probs, axis=1)[:, : self.top_n]
            self.top_n_correct += int(np.sum(top == actual[:, None]))
            self.top_n_total += len(actual)

    # -- metrics (reference Evaluation getters) -------------------------------
    def _m(self) -> np.ndarray:
        if self.confusion is None:
            raise ValueError("No data evaluated")
        return self.confusion.matrix

    def accuracy(self) -> float:
        m = self._m()
        tot = m.sum()
        return float(np.trace(m) / tot) if tot else 0.0

    def top_n_accuracy(self) -> float:
        if self.top_n_total == 0:
            return self.accuracy()
        return self.top_n_correct / self.top_n_total

    def true_positives(self) -> np.ndarray:
        return np.diag(self._m())

    def false_positives(self) -> np.ndarray:
        m = self._m()
        return m.sum(axis=0) - np.diag(m)

    def false_negatives(self) -> np.ndarray:
        m = self._m()
        return m.sum(axis=1) - np.diag(m)

    def precision(self, cls: Optional[int] = None,
                  averaging: str = "macro") -> float:
        tp, fp = self.true_positives(), self.false_positives()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        if averaging == "micro":  # reference EvaluationAveraging.Micro
            d = tp.sum() + fp.sum()
            return float(tp.sum() / d) if d else 0.0
        # macro-average over classes that appear (reference default)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(tp + fp > 0, tp / (tp + fp), np.nan)
        valid = ~np.isnan(per)
        return float(np.nanmean(per)) if valid.any() else 0.0

    def recall(self, cls: Optional[int] = None,
               averaging: str = "macro") -> float:
        tp, fn = self.true_positives(), self.false_negatives()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        if averaging == "micro":
            d = tp.sum() + fn.sum()
            return float(tp.sum() / d) if d else 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(tp + fn > 0, tp / (tp + fn), np.nan)
        valid = ~np.isnan(per)
        return float(np.nanmean(per)) if valid.any() else 0.0

    def f1(self, cls: Optional[int] = None,
           averaging: str = "macro") -> float:
        """Macro: mean of per-class F1 over classes with defined F1,
        with the reference's 2-class special case (binary F1 of class 1);
        micro: F1 of micro-P/micro-R (reference ``Evaluation.fBeta``,
        ``eval/Evaluation.java:1193-1203``)."""
        if cls is not None:
            p = self.precision(cls)
            r = self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        n = self._m().shape[0]
        if n == 2:
            # reference special case: binary problems return the F1 of
            # class 1 REGARDLESS of averaging (Evaluation.fBeta checks
            # binaryPositiveClass before dispatching on the averaging
            # mode), so f1(averaging='micro') matches fBeta too
            return self.f1(1)
        if averaging == "micro":
            p = self.precision(averaging="micro")
            r = self.recall(averaging="micro")
            return 2 * p * r / (p + r) if (p + r) else 0.0
        tp = self.true_positives()
        fp = self.false_positives()
        fn = self.false_negatives()
        per = []
        for i in range(n):
            if tp[i] + fp[i] + fn[i] == 0:
                continue  # F1 undefined for a class that never appears
            p_i = tp[i] / (tp[i] + fp[i]) if tp[i] + fp[i] else 0.0
            r_i = tp[i] / (tp[i] + fn[i]) if tp[i] + fn[i] else 0.0
            per.append(2 * p_i * r_i / (p_i + r_i) if (p_i + r_i) else 0.0)
        return float(np.mean(per)) if per else 0.0

    def merge(self, other: "Evaluation") -> None:
        if other.confusion is None:
            return
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.merge(other.confusion)
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        self._predictions.extend(other._predictions)

    # -- recorded-prediction getters (reference record-metadata surface) ----
    def get_prediction_errors(self) -> List[Prediction]:
        """Misclassified examples (reference ``getPredictionErrors`` —
        requires eval() calls with ``record_meta_data``)."""
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [p for p in self._predictions if p.actual == int(cls)]

    def get_predictions_by_predicted_class(self, cls: int
                                           ) -> List[Prediction]:
        return [p for p in self._predictions if p.predicted == int(cls)]

    def stats(self) -> str:
        m = self._m()
        n = m.shape[0]
        names = self.label_names or [str(i) for i in range(n)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("=========================Confusion Matrix=========================")
        header = "     " + " ".join(f"{i:>6}" for i in range(n))
        lines.append(header)
        for i in range(n):
            lines.append(f"{names[i]:>4} " + " ".join(f"{m[i, j]:>6}" for j in range(n)))
        return "\n".join(lines)
