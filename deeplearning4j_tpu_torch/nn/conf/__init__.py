"""Configuration: builders, input types, layer catalog, JSON serde."""

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType  # noqa: F401
