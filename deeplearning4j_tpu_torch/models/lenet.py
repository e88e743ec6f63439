"""LeNet: conv5x5-20 -> pool -> conv5x5-50 -> pool -> dense500 -> softmax.

Counterpart of ``deeplearning4j_tpu/models/lenet.py``; ``conf()`` mirrors
it line for line and builds the same configuration dict (the reference's
MNIST smoke model, BASELINE.json config #1).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import Adam


class LeNet(ZooModel):
    name = "lenet"

    def __init__(self, num_classes: int = 10, height: int = 28, width: int = 28,
                 channels: int = 1, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Adam(1e-3)))
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=5, stride=1,
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel_size=5, stride=1,
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
