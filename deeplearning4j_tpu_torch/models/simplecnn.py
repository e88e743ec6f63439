"""SimpleCNN (reference ``zoo/model/SimpleCNN.java``): small VGG-style
conv stack for 48x48+ inputs.

Counterpart of ``deeplearning4j_tpu/models/simplecnn.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import AdaDelta


class SimpleCNN(ZooModel):
    name = "simplecnn"

    def __init__(self, num_classes: int = 10, height: int = 48, width: int = 48,
                 channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", AdaDelta()))
            .weight_init("relu")
            .list()
        )
        for n_out, pool in [(16, False), (32, True), (64, True), (128, True)]:
            b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=3,
                                         convolution_mode="same", activation="relu"))
            b = b.layer(BatchNormalization())
            if pool:
                b = b.layer(SubsamplingLayer(kernel_size=2, stride=2))
        return (
            b.layer(DenseLayer(n_out=256, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
