"""Model zoo (ResNet-50, LeNet, VGG16, VGG19)."""

from deeplearning4j_tpu_torch.models.lenet import LeNet  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.models.selector import ZOO, ModelSelector  # noqa: F401
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19  # noqa: F401
from deeplearning4j_tpu_torch.models.zoo import ZooModel  # noqa: F401
