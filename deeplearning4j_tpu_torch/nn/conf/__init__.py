"""Configuration: builders, input types, preprocessors, layer catalog, JSON serde."""

from deeplearning4j_tpu_torch.nn.conf.builders import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType  # noqa: F401
