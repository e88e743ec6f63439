"""ResNet-50: stem conv7/2 + maxpool, stages of [3,4,6,3] bottleneck blocks,
global average pool, softmax.

Counterpart of ``deeplearning4j_tpu/models/resnet50.py``; ``conf()`` mirrors
it line for line and builds the same configuration dict. With
``fused_pallas=True`` each bottleneck is one ``FusedResNetBottleneck``,
whose convs run the CUDA kernels in bf16 on the card.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import Nesterovs


class ResNet50(ZooModel):
    name = "resnet50"

    # (blocks, bottleneck width); output channels = 4x width
    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def _conv_bn(self, gb, name, inp, n_out, kernel, stride=1, relu=True):
        gb.add_layer(f"{name}_conv",
                     ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                      stride=stride, convolution_mode="same",
                                      activation="identity", has_bias=False),
                     inp)
        gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if relu:
            gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                         f"{name}_bn")
            return f"{name}_relu"
        return f"{name}_bn"

    def _bottleneck(self, gb, name, inp, width, stride, project):
        """1x1 reduce -> 3x3 -> 1x1 expand (+ identity/projection shortcut);
        one FusedResNetBottleneck vertex with ``fused_pallas=True``."""
        if self.kwargs.get("fused_pallas"):
            from deeplearning4j_tpu_torch.nn.conf.layers import (
                FusedResNetBottleneck,
            )

            gb.add_layer(name, FusedResNetBottleneck(
                width=width, stride=stride, project=project), inp)
            return name
        a = self._conv_bn(gb, f"{name}_a", inp, width, 1, stride)
        b = self._conv_bn(gb, f"{name}_b", a, width, 3, 1)
        c = self._conv_bn(gb, f"{name}_c", b, 4 * width, 1, 1, relu=False)
        if project:
            sc = self._conv_bn(gb, f"{name}_proj", inp, 4 * width, 1, stride,
                               relu=False)
        else:
            sc = inp
        gb.add_vertex(f"{name}_add", ElementWiseVertex("add"), c, sc)
        gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    def conf(self):
        gb = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Nesterovs(1e-1, 0.9)))
            .weight_init("relu")
            .l2(1e-4)
            .compute_dtype(self.kwargs.get("compute_dtype"))
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width,
                                                     self.channels))
        )
        if self.kwargs.get("stem_space_to_depth"):
            raise NotImplementedError(
                "stem_space_to_depth (SpaceToDepthLayer) is not ported yet "
                "(ROADMAP § A)")
        x = self._conv_bn(gb, "stem", "input", 64, 7, 2)
        gb.add_layer("stem_pool",
                     SubsamplingLayer(kernel_size=3, stride=2,
                                      convolution_mode="same"), x)
        x = "stem_pool"
        for si, (blocks, width) in enumerate(self.STAGES):
            for bi in range(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = self._bottleneck(gb, f"s{si}b{bi}", x, width, stride,
                                     project=(bi == 0))
        gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        gb.add_layer("output",
                     OutputLayer(n_out=self.num_classes, activation="softmax",
                                 loss="mcxent"), "avgpool")
        gb.set_outputs("output")
        return gb.build()
