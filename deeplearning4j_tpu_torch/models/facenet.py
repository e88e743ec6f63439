"""Face-embedding models (reference ``zoo/model/FaceNetNN4Small2.java``
and ``InceptionResNetV1.java``): inception-style trunks producing an
L2-normalized 128-d embedding trained with softmax + center loss.

Both are ComputationGraphs ending in
embedding-dense → L2NormalizeVertex → CenterLossOutputLayer, the
reference's training head (triplet mining is out of scope there too).


Counterpart of ``deeplearning4j_tpu/models/facenet.py``; ``conf()`` mirrors it
line for line and builds the same configuration dict."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    CenterLossOutputLayer,
    ConvolutionLayer,
    DenseLayer,
    GlobalPoolingLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.updaters import Adam


class _FaceEmbeddingModel(ZooModel):
    embedding_size = 128

    def __init__(self, num_classes: int = 1000, height: int = 160,
                 width: int = 160, channels: int = 3,
                 embedding_size: int = 128, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.height, self.width, self.channels = height, width, channels
        self.embedding_size = int(embedding_size)

    def _conv_bn(self, gb, name, inp, n_out, kernel, stride=1):
        gb.add_layer(f"{name}_c",
                     ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                      stride=stride, convolution_mode="same",
                                      activation="identity", has_bias=False),
                     inp)
        gb.add_layer(f"{name}_bn", BatchNormalization(activation="relu"),
                     f"{name}_c")
        return f"{name}_bn"

    def _head(self, gb, trunk_out):
        gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), trunk_out)
        gb.add_layer("embedding",
                     DenseLayer(n_out=self.embedding_size,
                                activation="identity"), "avgpool")
        gb.add_vertex("l2norm", L2NormalizeVertex(), "embedding")
        gb.add_layer("output",
                     CenterLossOutputLayer(n_out=self.num_classes,
                                           activation="softmax", loss="mcxent",
                                           alpha=0.05, lambda_=2e-4), "l2norm")
        gb.set_outputs("output")


class FaceNetNN4Small2(_FaceEmbeddingModel):
    """nn4.small2 (reference ``FaceNetNN4Small2.java``): GoogLeNet-style
    inception modules shrunk for 96-160px faces."""

    name = "facenetnn4small2"

    # (1x1, 3x3r, 3x3, 5x5r, 5x5, poolproj)
    MODULES = (
        (64, 96, 128, 16, 32, 32),
        (64, 96, 128, 32, 64, 64),
        (128, 128, 256, 32, 64, 64),
        (256, 96, 384, 32, 128, 128),
    )

    def _inception(self, gb, name, inp, spec):
        c1, r3, c3, r5, c5, pp = spec
        b1 = self._conv_bn(gb, f"{name}_1x1", inp, c1, 1)
        b3 = self._conv_bn(gb, f"{name}_3x3", self._conv_bn(gb, f"{name}_3x3r", inp, r3, 1), c3, 3)
        b5 = self._conv_bn(gb, f"{name}_5x5", self._conv_bn(gb, f"{name}_5x5r", inp, r5, 1), c5, 5)
        gb.add_layer(f"{name}_pool",
                     SubsamplingLayer(kernel_size=3, stride=1,
                                      convolution_mode="same"), inp)
        bp = self._conv_bn(gb, f"{name}_pp", f"{name}_pool", pp, 1)
        gb.add_vertex(f"{name}_out", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_out"

    def conf(self):
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
        x = self._conv_bn(gb, "stem1", "input", 64, 7, 2)
        gb.add_layer("pool1", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), x)
        x = self._conv_bn(gb, "stem2", "pool1", 192, 3)
        gb.add_layer("pool2", SubsamplingLayer(kernel_size=3, stride=2,
                                               convolution_mode="same"), x)
        x = "pool2"
        for i, spec in enumerate(self.MODULES):
            x = self._inception(gb, f"inc{i}", x, spec)
            if i in (1, 2):
                gb.add_layer(f"incpool{i}",
                             SubsamplingLayer(kernel_size=3, stride=2,
                                              convolution_mode="same"), x)
                x = f"incpool{i}"
        self._head(gb, x)
        return gb.build()


class InceptionResNetV1(_FaceEmbeddingModel):
    """(reference ``InceptionResNetV1.java``): inception-resnet blocks with
    scaled residual adds (A x5, B x10, C x5) + reductions."""

    name = "inceptionresnetv1"

    def _res_block(self, gb, name, inp, branches, n_ch, scale=0.17):
        """Concat branches → 1x1 up → scaled residual add → relu."""
        outs = []
        for bi, chain in enumerate(branches):
            x = inp
            for ci, (n_out, k) in enumerate(chain):
                x = self._conv_bn(gb, f"{name}_b{bi}c{ci}", x, n_out, k)
            outs.append(x)
        if len(outs) > 1:
            gb.add_vertex(f"{name}_cat", MergeVertex(), *outs)
            cat = f"{name}_cat"
        else:
            cat = outs[0]
        gb.add_layer(f"{name}_up",
                     ConvolutionLayer(n_out=n_ch, kernel_size=1,
                                      convolution_mode="same",
                                      activation="identity"), cat)
        gb.add_vertex(f"{name}_scale", ScaleVertex(scale), f"{name}_up")
        gb.add_vertex(f"{name}_add", ElementWiseVertex("add"), inp, f"{name}_scale")
        gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_relu"

    def conf(self):
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
        # stem: 3 convs + pool → 256
        x = self._conv_bn(gb, "stem1", "input", 32, 3, 2)
        x = self._conv_bn(gb, "stem2", x, 64, 3)
        gb.add_layer("stem_pool", SubsamplingLayer(kernel_size=3, stride=2,
                                                   convolution_mode="same"), x)
        x = self._conv_bn(gb, "stem3", "stem_pool", 128, 1)
        x = self._conv_bn(gb, "stem4", x, 256, 3, 2)
        # 5x inception-resnet-A (on 256 ch)
        for i in range(5):
            x = self._res_block(
                gb, f"resA{i}", x,
                [[(32, 1)], [(32, 1), (32, 3)], [(32, 1), (32, 3), (32, 3)]],
                256, scale=0.17,
            )
        # reduction-A → 768
        x = self._conv_bn(gb, "redA", x, 768, 3, 2)
        # 10x inception-resnet-B
        for i in range(10):
            x = self._res_block(
                gb, f"resB{i}", x,
                [[(128, 1)], [(128, 1), (128, (1, 7)), (128, (7, 1))]],
                768, scale=0.10,
            )
        # reduction-B → 1280
        x = self._conv_bn(gb, "redB", x, 1280, 3, 2)
        # 5x inception-resnet-C
        for i in range(5):
            x = self._res_block(
                gb, f"resC{i}", x,
                [[(192, 1)], [(192, 1), (192, (1, 3)), (192, (3, 1))]],
                1280, scale=0.20,
            )
        self._head(gb, x)
        return gb.build()
