"""The ported layer catalog: what the zoo (ResNet-50, VGG16/19, LeNet,
AlexNet, SimpleCNN, GoogLeNet, the Darknet family, the face-embedding
models), the recurrent networks (TextGenerationLSTM) and the transformer
layers need, and the dropout and weight-noise classes a layer takes
(``nn/conf/dropouts.py``)."""

from deeplearning4j_tpu_torch.nn.conf.dropouts import (  # noqa: F401
    AlphaDropout,
    DropConnect,
    Dropout,
    GaussianDropout,
    GaussianNoise,
    IDropout,
    IWeightNoise,
    WeightNoise,
)

from deeplearning4j_tpu_torch.nn.conf.layers.attention import (  # noqa: F401
    LayerNormalization,
    PositionalEmbeddingLayer,
    SelfAttentionLayer,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.conf.layers.base import (  # noqa: F401
    FeedForwardLayer,
    GlobalConf,
    Layer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.conv import (  # noqa: F401
    BaseConvLayer,
    ConvolutionLayer,
    SpaceToDepthLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.core import (  # noqa: F401
    ActivationLayer,
    BaseOutputLayer,
    DenseLayer,
    LossLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.fused_block import (  # noqa: F401
    FusedResNetBottleneck,
)
from deeplearning4j_tpu_torch.nn.conf.layers.norm import (  # noqa: F401
    BatchNormalization,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.conf.layers.objdetect import (  # noqa: F401
    CnnLossLayer,
    DetectedObject,
    Yolo2OutputLayer,
    iou,
    non_max_suppression,
)
from deeplearning4j_tpu_torch.nn.conf.layers.pooling import GlobalPoolingLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (  # noqa: F401
    LSTM,
    BaseRecurrentLayer,
    Bidirectional,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LastTimeStep,
    MaskZeroLayer,
    RnnLossLayer,
    RnnOutputLayer,
    SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.conf.layers.special import CenterLossOutputLayer  # noqa: F401
