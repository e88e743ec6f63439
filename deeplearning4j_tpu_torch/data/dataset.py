"""DataSet / MultiDataSet containers.

Counterpart of ``deeplearning4j_tpu/data/dataset.py`` (the part ``fit``
consumes): host-side numpy arrays, features and labels with optional
masks. They cross to the device once per batch, in the train step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class DataSet:
    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray] = None,
                 features_mask: Optional[np.ndarray] = None,
                 labels_mask: Optional[np.ndarray] = None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def __repr__(self):
        ls = None if self.labels is None else self.labels.shape
        return f"DataSet(features={self.features.shape}, labels={ls})"


class MultiDataSet:
    """Several feature/label arrays, for ComputationGraph training."""

    def __init__(self, features: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                 features_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
                 labels_masks: Optional[Sequence[Optional[np.ndarray]]] = None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(lab) for lab in labels]
        self.features_masks = (list(features_masks) if features_masks
                               else [None] * len(self.features))
        self.labels_masks = (list(labels_masks) if labels_masks
                             else [None] * len(self.labels))

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
