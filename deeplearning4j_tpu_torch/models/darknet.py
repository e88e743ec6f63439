"""Darknet family (reference ``zoo/model/Darknet19.java``,
``TinyYOLO.java``, ``YOLO2.java``).

- Darknet19: 19-conv classifier (BN + leaky-relu, 1x1 bottlenecks),
  1x1 conv to classes + global average pool + softmax.
- TinyYOLO: tiny-darknet trunk (convs 16..1024 with maxpools) + 1x1
  detection head + Yolo2OutputLayer.
- YOLO2: darknet19 trunk + passthrough route (SpaceToDepth of an earlier
  feature map concatenated with the deep path — reference uses the same
  reorg trick) + detection head.


Counterpart of ``deeplearning4j_tpu/models/darknet.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    LossLayer,
    SpaceToDepthLayer,
    SubsamplingLayer,
    Yolo2OutputLayer,
)
from deeplearning4j_tpu_torch.updaters import Adam, Nesterovs

# reference TinyYOLO/YOLO2 anchor priors (grid units, VOC-flavored)
TINY_YOLO_PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38],
                    [9.42, 5.11], [16.62, 10.52]]
YOLO2_PRIORS = [[0.57273, 0.677385], [1.87446, 2.06253], [3.33843, 5.47434],
                [7.88282, 3.52778], [9.77052, 9.16828]]


def _conv_bn_leaky(n_out, kernel):
    """Darknet building block: conv (no bias) → BN → leaky relu."""
    return [
        ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                         convolution_mode="same", activation="identity",
                         has_bias=False),
        BatchNormalization(activation="leakyrelu"),
    ]


class Darknet19(ZooModel):
    name = "darknet19"

    # (channels, kernel) runs separated by maxpools — the 19-conv layout
    BLOCKS = (
        [(32, 3)],
        [(64, 3)],
        [(128, 3), (64, 1), (128, 3)],
        [(256, 3), (128, 1), (256, 3)],
        [(512, 3), (256, 1), (512, 3), (256, 1), (512, 3)],
        [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)],
    )

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Nesterovs(1e-3, 0.9)))
            .weight_init("relu")
            .list()
        )
        for bi, block in enumerate(self.BLOCKS):
            if bi > 0:
                b = b.layer(SubsamplingLayer(kernel_size=2, stride=2))
            for n_out, k in block:
                for layer in _conv_bn_leaky(n_out, k):
                    b = b.layer(layer)
        return (
            b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=1,
                                     convolution_mode="same",
                                     activation="identity"))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(LossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional(self.height, self.width,
                                                    self.channels))
            .build()
        )


class TinyYOLO(ZooModel):
    name = "tinyyolo"

    def __init__(self, num_classes: int = 20, height: int = 416,
                 width: int = 416, channels: int = 3, priors=None, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels
        self.priors = priors if priors is not None else TINY_YOLO_PRIORS

    def conf(self):
        B = len(self.priors)
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Adam(1e-3)))
            .weight_init("relu")
            .list()
        )
        # tiny-darknet trunk: 16..512 with /2 pools, then 1024s at stride 1
        for i, n_out in enumerate((16, 32, 64, 128, 256, 512)):
            for layer in _conv_bn_leaky(n_out, 3):
                b = b.layer(layer)
            stride = 2 if i < 5 else 1
            b = b.layer(SubsamplingLayer(kernel_size=2, stride=stride,
                                         convolution_mode="same"))
        for n_out in (1024, 1024):
            for layer in _conv_bn_leaky(n_out, 3):
                b = b.layer(layer)
        return (
            b.layer(ConvolutionLayer(n_out=B * (5 + self.num_classes),
                                     kernel_size=1, convolution_mode="same",
                                     activation="identity"))
            .layer(Yolo2OutputLayer(bounding_box_priors=self.priors))
            .set_input_type(InputType.convolutional(self.height, self.width,
                                                    self.channels))
            .build()
        )


class YOLO2(ZooModel):
    name = "yolo2"

    def __init__(self, num_classes: int = 20, height: int = 416,
                 width: int = 416, channels: int = 3, priors=None, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels
        self.priors = priors if priors is not None else YOLO2_PRIORS

    def _block(self, gb, name, inp, specs):
        x = inp
        for i, (n_out, k) in enumerate(specs):
            gb.add_layer(f"{name}_c{i}",
                         ConvolutionLayer(n_out=n_out, kernel_size=k,
                                          convolution_mode="same",
                                          activation="identity",
                                          has_bias=False), x)
            gb.add_layer(f"{name}_b{i}",
                         BatchNormalization(activation="leakyrelu"),
                         f"{name}_c{i}")
            x = f"{name}_b{i}"
        return x

    def conf(self):
        B = len(self.priors)
        gb = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", Adam(1e-3)))
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width,
                                                     self.channels))
        )
        x = self._block(gb, "b1", "input", [(32, 3)])
        for bi, block in enumerate((
            [(64, 3)],
            [(128, 3), (64, 1), (128, 3)],
            [(256, 3), (128, 1), (256, 3)],
            [(512, 3), (256, 1), (512, 3), (256, 1), (512, 3)],
        )):
            gb.add_layer(f"pool{bi}", SubsamplingLayer(kernel_size=2, stride=2), x)
            x = self._block(gb, f"b{bi + 2}", f"pool{bi}", block)
        route = x  # 512-ch map at stride 16 — the passthrough source
        gb.add_layer("pool5", SubsamplingLayer(kernel_size=2, stride=2), x)
        x = self._block(gb, "b6", "pool5",
                        [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)])
        x = self._block(gb, "head", x, [(1024, 3), (1024, 3)])
        # passthrough: stride-16 features reorged to stride 32 and concatenated
        gb.add_layer("reorg", SpaceToDepthLayer(block_size=2), route)
        gb.add_vertex("route_cat", MergeVertex(), "reorg", x)
        x = self._block(gb, "fuse", "route_cat", [(1024, 3)])
        gb.add_layer("det_head",
                     ConvolutionLayer(n_out=B * (5 + self.num_classes),
                                      kernel_size=1, convolution_mode="same",
                                      activation="identity"), x)
        gb.add_layer("yolo", Yolo2OutputLayer(bounding_box_priors=self.priors),
                     "det_head")
        gb.set_outputs("yolo")
        return gb.build()
