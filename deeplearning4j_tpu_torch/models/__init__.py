"""Model zoo (the reference's 13 architectures, their label sets) and the
TransformerLM, which the zoo selector does not list (as in the reference)."""

from deeplearning4j_tpu_torch.models.alexnet import AlexNet  # noqa: F401
from deeplearning4j_tpu_torch.models.darknet import YOLO2, Darknet19, TinyYOLO  # noqa: F401
from deeplearning4j_tpu_torch.models.facenet import (  # noqa: F401
    FaceNetNN4Small2,
    InceptionResNetV1,
)
from deeplearning4j_tpu_torch.models.googlenet import GoogLeNet  # noqa: F401
from deeplearning4j_tpu_torch.models.labels import (  # noqa: F401
    BaseLabels,
    ClassPrediction,
    COCOLabels,
    DarknetLabels,
    ImageNetLabels,
    VOCLabels,
)
from deeplearning4j_tpu_torch.models.lenet import LeNet  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.models.selector import (  # noqa: F401
    ZOO,
    ModelSelector,
    PretrainedType,
)
from deeplearning4j_tpu_torch.models.simplecnn import SimpleCNN  # noqa: F401
from deeplearning4j_tpu_torch.models.textgen_lstm import TextGenerationLSTM  # noqa: F401
from deeplearning4j_tpu_torch.models.transformer_lm import TransformerLM  # noqa: F401
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19  # noqa: F401
from deeplearning4j_tpu_torch.models.zoo import ZooModel  # noqa: F401
