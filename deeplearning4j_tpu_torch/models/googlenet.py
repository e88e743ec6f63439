"""GoogLeNet / Inception-v1 (reference ``zoo/model/GoogLeNet.java``):
stem convs + 9 inception modules (1x1 / 3x3 / 5x5 / pool-proj branches
concatenated) + global average pool + softmax. Aux classifiers omitted
(inference parity; the reference zoo model trains the main head).

Counterpart of ``deeplearning4j_tpu/models/googlenet.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    GlobalPoolingLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import Nesterovs

# (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, poolproj) per inception module
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class GoogLeNet(ZooModel):
    name = "googlenet"

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def _conv(self, gb, name, inp, n_out, kernel, stride=1):
        gb.add_layer(name,
                     ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                      stride=stride, convolution_mode="same",
                                      activation="relu"), inp)
        return name

    def _inception(self, gb, name, inp, spec):
        c1, r3, c3, r5, c5, pp = spec
        b1 = self._conv(gb, f"{name}_1x1", inp, c1, 1)
        b3r = self._conv(gb, f"{name}_3x3r", inp, r3, 1)
        b3 = self._conv(gb, f"{name}_3x3", b3r, c3, 3)
        b5r = self._conv(gb, f"{name}_5x5r", inp, r5, 1)
        b5 = self._conv(gb, f"{name}_5x5", b5r, c5, 5)
        gb.add_layer(f"{name}_pool",
                     SubsamplingLayer(kernel_size=3, stride=1,
                                      convolution_mode="same"), inp)
        bp = self._conv(gb, f"{name}_poolproj", f"{name}_pool", pp, 1)
        gb.add_vertex(f"{name}_out", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_out"

    def conf(self):
        gb = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Nesterovs(1e-2, 0.9)))
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width,
                                                     self.channels))
        )
        x = self._conv(gb, "stem1", "input", 64, 7, 2)
        gb.add_layer("pool1", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), x)
        gb.add_layer("lrn1", LocalResponseNormalization(), "pool1")
        x = self._conv(gb, "stem2r", "lrn1", 64, 1)
        x = self._conv(gb, "stem2", x, 192, 3)
        gb.add_layer("lrn2", LocalResponseNormalization(), x)
        gb.add_layer("pool2", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), "lrn2")
        x = "pool2"
        for name in ("3a", "3b"):
            x = self._inception(gb, f"inc{name}", x, _INCEPTION[name])
        gb.add_layer("pool3", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), x)
        x = "pool3"
        for name in ("4a", "4b", "4c", "4d", "4e"):
            x = self._inception(gb, f"inc{name}", x, _INCEPTION[name])
        gb.add_layer("pool4", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), x)
        x = "pool4"
        for name in ("5a", "5b"):
            x = self._inception(gb, f"inc{name}", x, _INCEPTION[name])
        gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        gb.add_layer("dropout", DenseLayer(n_out=1024, activation="relu",
                                           dropout=0.4), "avgpool")
        gb.add_layer("output",
                     OutputLayer(n_out=self.num_classes, activation="softmax",
                                 loss="mcxent"), "dropout")
        gb.set_outputs("output")
        return gb.build()
