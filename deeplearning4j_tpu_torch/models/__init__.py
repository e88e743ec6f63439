"""Model zoo (ResNet-50, LeNet, VGG16, VGG19, TextGenerationLSTM) and the
TransformerLM, which the zoo selector does not list (as in the reference)."""

from deeplearning4j_tpu_torch.models.lenet import LeNet  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.models.selector import ZOO, ModelSelector  # noqa: F401
from deeplearning4j_tpu_torch.models.textgen_lstm import TextGenerationLSTM  # noqa: F401
from deeplearning4j_tpu_torch.models.transformer_lm import TransformerLM  # noqa: F401
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19  # noqa: F401
from deeplearning4j_tpu_torch.models.zoo import ZooModel  # noqa: F401
