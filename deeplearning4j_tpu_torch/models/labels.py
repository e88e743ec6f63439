"""Zoo prediction labels: ``ClassPrediction``, ``BaseLabels`` and the
ImageNet, Darknet, COCO and VOC label sets.

Counterpart of ``deeplearning4j_tpu/models/labels.py``.
``decode_predictions(probs, n)`` turns a (batch, classes) probability
array into each example's top-n ``ClassPrediction(number, label,
probability)``. The COCO-80 and VOC-20 lists are embedded; the 1000-class
ImageNet and Darknet lists are read from ``labels/imagenet_labels.txt`` and
``labels/darknet_labels.txt`` in the zoo's cache directory
(``models/zoo.CACHE_DIR``, one label a line), or are ``class_%04d``
placeholders when the file is absent. Nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from deeplearning4j_tpu_torch.models import zoo as _zoo


class ClassPrediction:
    """One decoded class: its index, label and probability."""

    def __init__(self, number: int, label: str, probability: float):
        self.number = int(number)
        self.label = label
        self.probability = float(probability)

    def __repr__(self):
        return (f"ClassPrediction(number={self.number}, "
                f"label={self.label!r}, probability={self.probability:.4f})")


class BaseLabels:
    """A label list: lookup and top-n decoding."""

    def __init__(self, labels: List[str]):
        self._labels = list(labels)

    def get_label(self, n: int) -> str:
        return self._labels[n]

    def num_classes(self) -> int:
        return len(self._labels)

    def decode_predictions(self, predictions: np.ndarray, n: int = 5
                           ) -> List[List[ClassPrediction]]:
        p = np.asarray(predictions)
        if p.ndim == 1:
            p = p[None]
        if p.shape[1] != len(self._labels):
            raise ValueError(
                f"predictions have {p.shape[1]} classes, labels have "
                f"{len(self._labels)}")
        out = []
        for row in p:
            top = np.argsort(-row)[:n]
            out.append([ClassPrediction(int(i), self._labels[int(i)],
                                        float(row[int(i)]))
                        for i in top])
        return out


def _cached_or_placeholder(filename: str, n: int, what: str) -> List[str]:
    """The labels of the cached file (one a line), else placeholders."""
    path = os.path.join(_zoo.CACHE_DIR, "labels", filename)
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            labels = [line.strip() for line in f if line.strip()]
        if len(labels) != n:
            raise ValueError(
                f"{path} has {len(labels)} labels, expected {n}")
        return labels
    return [f"{what}_{i:04d}" for i in range(n)]


class ImageNetLabels(BaseLabels):
    """The 1000 ILSVRC classes (names from the cached file)."""

    def __init__(self):
        super().__init__(_cached_or_placeholder(
            "imagenet_labels.txt", 1000, "class"))


class DarknetLabels(BaseLabels):
    """Darknet19's 1000 classes (names from the cached file)."""

    def __init__(self):
        super().__init__(_cached_or_placeholder(
            "darknet_labels.txt", 1000, "class"))


_COCO_80 = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

_VOC_20 = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class COCOLabels(BaseLabels):
    """The 80 COCO detection classes in Darknet's order (YOLO2's)."""

    def __init__(self):
        super().__init__(list(_COCO_80))


class VOCLabels(BaseLabels):
    """The 20 PASCAL VOC classes (TinyYOLO's)."""

    def __init__(self):
        super().__init__(list(_VOC_20))
