"""AlexNet (reference ``zoo/model/AlexNet.java``: the dual-GPU 2012 net
flattened to one tower — conv11/4 + LRN + pool stem, 5 conv layers, two
4096 dense layers with dropout, softmax).

Counterpart of ``deeplearning4j_tpu/models/alexnet.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import Nesterovs


class AlexNet(ZooModel):
    name = "alexnet"

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Nesterovs(1e-2, 0.9)))
            .weight_init("relu")
            .l2(5e-4)
            .list()
            .layer(ConvolutionLayer(n_out=96, kernel_size=11, stride=4,
                                    convolution_mode="same", activation="relu"))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(kernel_size=3, stride=2))
            .layer(ConvolutionLayer(n_out=256, kernel_size=5, stride=1,
                                    convolution_mode="same", activation="relu",
                                    bias_init=1.0))
            .layer(LocalResponseNormalization())
            .layer(SubsamplingLayer(kernel_size=3, stride=2))
            .layer(ConvolutionLayer(n_out=384, kernel_size=3,
                                    convolution_mode="same", activation="relu"))
            .layer(ConvolutionLayer(n_out=384, kernel_size=3,
                                    convolution_mode="same", activation="relu",
                                    bias_init=1.0))
            .layer(ConvolutionLayer(n_out=256, kernel_size=3,
                                    convolution_mode="same", activation="relu",
                                    bias_init=1.0))
            .layer(SubsamplingLayer(kernel_size=3, stride=2))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
