"""The ported layer catalog (slice 1: what ResNet-50 serving needs)."""

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
