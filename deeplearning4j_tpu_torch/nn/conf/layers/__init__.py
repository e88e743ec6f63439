"""The layer catalog: every layer of the reference's
``nn/conf/layers`` but the mixture-of-experts layers (``MixtureOfExpertsLayer``,
``MoETransformerBlock``), and the dropout and weight-noise classes a layer
takes (``nn/conf/dropouts.py``)."""

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
    Convolution1DLayer,
    ConvolutionLayer,
    Cropping2D,
    Deconvolution2D,
    DepthwiseConvolution2D,
    Pooling1D,
    Pooling2D,
    SeparableConvolution2D,
    SpaceToBatchLayer,
    SpaceToDepthLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.core import (  # noqa: F401
    ActivationLayer,
    AutoEncoder,
    BaseOutputLayer,
    DenseLayer,
    DropoutLayer,
    DummyLayer,
    ElementWiseMultiplicationLayer,
    EmbeddingLayer,
    EmbeddingSequenceLayer,
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
from deeplearning4j_tpu_torch.nn.conf.layers.pooling import (  # noqa: F401
    GlobalPoolingLayer,
    MaskLayer,
)
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
from deeplearning4j_tpu_torch.nn.conf.layers.special import (  # noqa: F401
    CenterLossOutputLayer,
    FrozenLayer,
)
from deeplearning4j_tpu_torch.nn.conf.layers.variational import (  # noqa: F401
    BernoulliReconstructionDistribution,
    CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution,
    GaussianReconstructionDistribution,
    LossFunctionWrapper,
    VariationalAutoencoder,
)
