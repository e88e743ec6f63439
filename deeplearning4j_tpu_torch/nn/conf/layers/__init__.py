"""The ported layer catalog: what ResNet-50, VGG16/LeNet, the recurrent
networks (TextGenerationLSTM) and the transformer layers need."""

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
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.core import (  # noqa: F401
    ActivationLayer,
    BaseOutputLayer,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.fused_block import (  # noqa: F401
    FusedResNetBottleneck,
)
from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization  # noqa: F401
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
