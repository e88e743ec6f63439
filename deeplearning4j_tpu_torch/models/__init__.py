"""Model zoo (slice 1: ResNet-50)."""

from deeplearning4j_tpu_torch.models.resnet50 import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.models.zoo import ZooModel  # noqa: F401
