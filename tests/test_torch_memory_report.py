"""The analytic memory report (``nn/conf/memory.py``) against the JAX
package's, figure for figure.

For LeNet, VGG16 (at 32x32, which leaves its layers and cuts only the
dense head's input), ResNet-50 (as a graph, fused and unfused), BASELINE
config #3's graph (the masked LSTM sentiment classifier), a narrow
MobileNet-v1 (alpha 0.25, 64x64) and a graph with frozen layers and a VAE,
each configuration built in both packages: every layer report's fields,
``total_memory_bytes`` for training and inference, in bf16, over 4 ZeRO-1
shards and with int8 heads, ``updater_state_bytes`` and ``to_string``
exactly equal. The full-width MobileNet-v1 (alpha 1.0, 224x224, 1000
classes) is reported from its configuration alone, with no network made.
"""

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
import pytest
from deeplearning4j_tpu import models as jmodels
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import memory as jmem
from deeplearning4j_tpu_torch import models as tmodels
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import memory as tmem

JAX = (jconf, jlayers, jupd, jmodels)
PORT = (tconf, tlayers, tupd, tmodels)

#: Howard et al. 2017, Table 1: (pointwise filters, depthwise stride) a block
MOBILENET_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + \
    [(512, 1)] * 5 + [(1024, 2), (1024, 1)]


def mobilenet_v1(pkg, alpha=1.0, size=224, classes=1000):
    """MobileNet-v1 as Keras's ``mobilenet.py`` lays it out: a zero pad of
    (0, 1, 0, 1) before each stride-2 conv in "truncate" mode, convs without
    bias, each followed by BN and relu6; global average pooling and the
    classifier."""
    conf, layers, upd = pkg[:3]

    def bn():
        return layers.BatchNormalization(activation="relu6")

    lb = (conf.NeuralNetConfiguration.builder().seed(11).updater(upd.Adam(1e-3))
          .weight_init("xavier").list())
    lb = (lb.layer(layers.ZeroPaddingLayer(pad=(0, 1, 0, 1)))
          .layer(layers.ConvolutionLayer(n_out=int(32 * alpha), kernel_size=3, stride=2,
                                         has_bias=False, activation="identity"))
          .layer(bn()))
    for filters, stride in MOBILENET_BLOCKS:
        if stride == 2:
            lb = lb.layer(layers.ZeroPaddingLayer(pad=(0, 1, 0, 1)))
        lb = (lb.layer(layers.DepthwiseConvolution2D(
            kernel_size=3, stride=stride, has_bias=False, activation="identity",
            convolution_mode="same" if stride == 1 else "truncate"))
              .layer(bn())
              .layer(layers.ConvolutionLayer(n_out=int(filters * alpha), kernel_size=1,
                                             has_bias=False, activation="identity"))
              .layer(bn()))
    return (lb.layer(layers.GlobalPoolingLayer(pooling_type="avg"))
            .layer(layers.OutputLayer(n_out=classes, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.convolutional(size, size, 3)).build())


def sentiment(pkg):
    """BASELINE config #3 (the masked LSTM sentiment graph)."""
    conf, layers, upd = pkg[:3]
    vertices = __import__(conf.__name__ + ".graph_vertices", fromlist=["LastTimeStepVertex"])
    return (conf.NeuralNetConfiguration.builder().seed(5).updater(upd.Adam(5e-3)).l2(1e-5)
            .graph_builder().add_inputs("tokens")
            .add_layer("lstm", layers.LSTM(n_out=256, activation="tanh"), "tokens")
            .add_vertex("last", vertices.LastTimeStepVertex(mask_input="tokens"), "lstm")
            .add_layer("out", layers.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                       "last")
            .set_outputs("out").set_input_types(conf.InputType.recurrent(300, 256)).build())


def frozen_vae(pkg):
    conf, layers, upd = pkg[:3]
    F = layers.FrozenLayer
    return (conf.NeuralNetConfiguration.builder().seed(5).updater(upd.Nesterovs(0.1, 0.9))
            .graph_builder().add_inputs("in")
            .add_layer("c", F(layer=layers.ConvolutionLayer(n_out=4, kernel_size=3)), "in")
            .add_layer("e", layers.EmbeddingLayer(n_in=10, n_out=3), "in2")
            .add_inputs("in2")
            .add_layer("v", layers.VariationalAutoencoder(n_out=2, encoder_layer_sizes=(8,),
                                                          decoder_layer_sizes=(8,)), "c")
            .add_layer("out", layers.OutputLayer(n_out=3, activation="softmax"), "v")
            .add_layer("out2", layers.OutputLayer(n_out=2, activation="softmax"), "e")
            .set_outputs("out", "out2")
            .set_input_types(conf.InputType.convolutional(6, 6, 2),
                             conf.InputType.feed_forward(1)).build())


CONFS = {
    "lenet": lambda p: p[3].LeNet(num_classes=10).conf(),
    "vgg16_32x32": lambda p: p[3].VGG16(num_classes=10, height=32, width=32).conf(),
    "resnet50": lambda p: p[3].ResNet50(num_classes=1000).conf(),
    "resnet50_fused": lambda p: p[3].ResNet50(num_classes=1000, fused_pallas=True).conf(),
    "config3_sentiment": sentiment,
    "mobilenet_a025_64": lambda p: mobilenet_v1(p, alpha=0.25, size=64, classes=10),
    "mobilenet_full": mobilenet_v1,
    "frozen_vae_graph": frozen_vae,
}


def report(mem, conf):
    if hasattr(conf, "network_inputs"):
        return mem.memory_report_graph(conf, "net")
    return mem.memory_report_mln(conf, "net")


@pytest.mark.parametrize("name", sorted(CONFS))
def test_memory_report_equals_jax(name):
    jr, tr = report(jmem, CONFS[name](JAX)), report(tmem, CONFS[name](PORT))
    fields = ("layer_name", "layer_type", "n_params", "updater_slots",
              "activation_elems_per_example", "int8_weight_params")
    assert [[getattr(r, f) for f in fields] for r in tr.layer_reports] == \
        [[getattr(r, f) for f in fields] for r in jr.layer_reports]
    assert [(r.input_type.to_dict(), r.output_type.to_dict()) for r in tr.layer_reports] == \
        [(r.input_type.to_dict(), r.output_type.to_dict()) for r in jr.layer_reports]
    assert (tr.model_class, tr.dtype, tr.total_params) == (jr.model_class, jr.dtype,
                                                            jr.total_params)
    for batch in (1, 32):
        for kw in ({}, {"dtype": "bfloat16"}, {"data_parallel_shards": 4},
                   {"int8_weights": True}):
            for training in (True, False):
                assert tr.total_memory_bytes(batch, training, **kw) == \
                    jr.total_memory_bytes(batch, training, **kw), (batch, training, kw)
    for shards in (1, 3, 4):
        assert tr.updater_state_bytes(data_parallel_shards=shards) == \
            jr.updater_state_bytes(data_parallel_shards=shards)
    assert tr.to_string(32) == jr.to_string(32)
    assert tr.to_string(8, data_parallel_shards=4) == jr.to_string(8, data_parallel_shards=4)
    assert repr(tr) == repr(jr)


def test_mobilenet_full_width_counts():
    """alpha 1.0: 4,231,976 params, Keras's trainable count of MobileNet
    with its top (its 4,253,864 less the 21,888 BN moving statistics, which
    are layer state here); 1,025,000 of them the classifier's, whose
    1,024,000 weights int8 serving quantizes."""
    r = tmem.memory_report_mln(mobilenet_v1(PORT))
    assert r.total_params == 4_231_976
    assert r.layer_reports[-1].n_params == 1_025_000
    assert sum(x.int8_weight_params for x in r.layer_reports) == 1_024_000
    assert r.total_memory_bytes(32, training=False, int8_weights=True) < \
        r.total_memory_bytes(32, training=False)
