"""ModelSelector: name-based zoo lookup.

Counterpart of ``deeplearning4j_tpu/models/selector.py``. The port's zoo
holds the architectures ported so far; the reference's other names
(AlexNet, Darknet19, FaceNet, GoogLeNet, SimpleCNN, TextGenerationLSTM,
TinyYOLO, YOLO2) raise :class:`ZooModelNotPortedError`. A zoo name always
initializes fresh seeded weights: there is no pretrained lookup and no
download.
"""

from __future__ import annotations

import os
from typing import Dict, Type

from deeplearning4j_tpu_torch.models.lenet import LeNet
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19
from deeplearning4j_tpu_torch.models.zoo import ZooModel

ZOO: Dict[str, Type[ZooModel]] = {m.name: m for m in (LeNet, ResNet50, VGG16, VGG19)}

#: zoo names of the reference that the port does not have yet
NOT_PORTED = ("alexnet", "darknet19", "facenetnn4small2", "googlenet",
              "inceptionresnetv1", "simplecnn", "textgenlstm", "tinyyolo", "yolo2")


class UnknownZooModelError(KeyError):
    """Requested zoo model name is not registered."""


class ZooModelNotPortedError(NotImplementedError):
    """A zoo model of the reference that the port does not have yet."""


class ModelSelector:
    @staticmethod
    def select(name: str, **kwargs) -> ZooModel:
        key = name.lower()
        if key in NOT_PORTED:
            raise ZooModelNotPortedError(
                f"zoo model '{name}' is not ported yet (ROADMAP § A); "
                f"ported: {sorted(ZOO)}")
        if key not in ZOO:
            raise UnknownZooModelError(
                f"Unknown zoo model '{name}'; available: {sorted(ZOO)}")
        return ZOO[key](**kwargs)

    @staticmethod
    def load_or_init(source: str, device=None, **kwargs):
        """Resolve ``source`` into an initialized network on ``device``
        (default the CUDA card): a zoo name inits fresh seeded weights, a
        checkpoint zip restores it, a checkpoint directory restores its
        newest valid zip. Returns ``(model, origin)``."""
        key = source.lower()
        if key in ZOO or key in NOT_PORTED:
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
