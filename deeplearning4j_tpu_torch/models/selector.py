"""ModelSelector and PretrainedType: name-based zoo lookup.

Counterpart of ``deeplearning4j_tpu/models/selector.py``: the reference's
13 zoo names. A zoo name initializes fresh seeded weights
(``ZooModel.init``); pretrained weights come through
``ZooModel.init_pretrained``.
"""

from __future__ import annotations

import os
from typing import Dict, Type

from deeplearning4j_tpu_torch.models.alexnet import AlexNet
from deeplearning4j_tpu_torch.models.darknet import YOLO2, Darknet19, TinyYOLO
from deeplearning4j_tpu_torch.models.facenet import FaceNetNN4Small2, InceptionResNetV1
from deeplearning4j_tpu_torch.models.googlenet import GoogLeNet
from deeplearning4j_tpu_torch.models.lenet import LeNet
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50
from deeplearning4j_tpu_torch.models.simplecnn import SimpleCNN
from deeplearning4j_tpu_torch.models.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19
from deeplearning4j_tpu_torch.models.zoo import ZooModel


class PretrainedType:
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


ZOO: Dict[str, Type[ZooModel]] = {
    m.name: m
    for m in (AlexNet, Darknet19, FaceNetNN4Small2, GoogLeNet, InceptionResNetV1, LeNet,
              ResNet50, SimpleCNN, TextGenerationLSTM, TinyYOLO, VGG16, VGG19, YOLO2)}


class UnknownZooModelError(KeyError):
    """Requested zoo model name is not registered."""


class ModelSelector:
    @staticmethod
    def select(name: str, **kwargs) -> ZooModel:
        key = name.lower()
        if key not in ZOO:
            raise UnknownZooModelError(
                f"Unknown zoo model '{name}'; available: {sorted(ZOO)}")
        return ZOO[key](**kwargs)

    @staticmethod
    def available() -> list:
        return sorted(ZOO)

    @staticmethod
    def load_or_init(source: str, device=None, **kwargs):
        """Resolve ``source`` into an initialized network on ``device``
        (default the CUDA card): a zoo name inits fresh seeded weights, a
        checkpoint zip restores it, a checkpoint directory restores its
        newest valid zip. Returns ``(model, origin)``."""
        key = source.lower()
        if key in ZOO:
            return ModelSelector.select(source, **kwargs).init(device=device), key
        from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser

        if os.path.isdir(source):
            from deeplearning4j_tpu_torch.train.faults import latest_valid_checkpoint

            path = latest_valid_checkpoint(source)
            return ModelGuesser.load_model_guess(path, device=device), path
        if os.path.isfile(source):
            return ModelGuesser.load_model_guess(source, device=device), source
        raise ValueError(
            f"model source {source!r} is neither a zoo model "
            f"({sorted(ZOO)}), a checkpoint zip, nor a checkpoint directory")
