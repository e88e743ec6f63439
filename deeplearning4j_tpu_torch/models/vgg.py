"""VGG16 / VGG19: 3x3 conv blocks [64, 128, 256, 512, 512], two 4096 dense
layers (dropout 0.5) and a softmax output.

Counterpart of ``deeplearning4j_tpu/models/vgg.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict. At 224x224x3 and
1000 classes VGG16 holds 138,357,544 parameters, 123,642,856 of them in
the three dense heads (25088->4096, 4096->4096, 4096->1000), which an
``InferenceEngine(int8_serving=True)`` serves through the int8 kernel.
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
from deeplearning4j_tpu_torch.updaters import Nesterovs


class _VGG(ZooModel):
    block_convs = ()  # convs per block; channels fixed at (64,128,256,512,512)

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Nesterovs(1e-2, 0.9)))
            .weight_init("relu")
            .list()
        )
        for n_out, reps in zip((64, 128, 256, 512, 512), self.block_convs):
            for _ in range(reps):
                b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=3,
                                             convolution_mode="same",
                                             activation="relu"))
            b = b.layer(SubsamplingLayer(kernel_size=2, stride=2))
        return (
            b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )


class VGG16(_VGG):
    name = "vgg16"
    block_convs = (2, 2, 3, 3, 3)


class VGG19(_VGG):
    name = "vgg19"
    block_convs = (2, 2, 4, 4, 4)
