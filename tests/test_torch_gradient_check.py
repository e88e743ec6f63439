"""The port's numerical gradient checker (``nn/gradient_check.py``) on the
cases of the reference's ``tests/test_gradient_check.py`` whose layers the
port trains, each without dropout and with dropout at a fixed noise state
(input dropout on every layer after the first, the output layer's
included, and DropConnect on the first dense or output layer's weights);
and a ComputationGraph case. Where a reference case ends in a layer the
port does not train yet (the ``RnnOutputLayer`` head, ROADMAP § A5; average
subsampling), the case keeps its layers up to it and ends in global
pooling and an ``OutputLayer`` (max subsampling). The checker runs in float64 with the
reference's ε 1e-6, max relative error 1e-3 and min absolute error 1e-8.
A gradient made wrong on purpose (0.1 added to the gradient a layer's
output passes back, the loss unchanged) fails it.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.gradient_check import (
    DEFAULT_EPS,
    DEFAULT_MAX_REL_ERROR,
    DEFAULT_MIN_ABS_ERROR,
    check_gradients,
    check_gradients_graph,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

I = tconf.InputType


def _data(n=4, n_in=3, n_classes=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, n)]
    return DataSet(x, y)


def _build(layers, input_type, dropout, l1=0.0, l2=0.0):
    """The reference test's builder (seed 7, Sgd, xavier); with ``dropout``,
    input dropout 0.2 on every layer after the first and DropConnect 0.8 on
    the first layer that has a ``W``."""
    if dropout:
        for layer in layers[1:]:
            layer.dropout = 0.2
        for layer in layers:
            if isinstance(layer, (L.DenseLayer, L.OutputLayer)):
                layer.weight_noise = L.DropConnect(0.8)
                break
    b = tconf.NeuralNetConfiguration.builder().seed(7).updater(tupd.Sgd(0.1)).weight_init("xavier")
    if l1:
        b = b.l1(l1)
    if l2:
        b = b.l2(l2)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    return MultiLayerNetwork(lb.set_input_type(input_type).build()).init(device="cpu")


def _rnn_data(n, t, n_in, classes, per_step, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, n_in)).astype(np.float32)
    shape = (n, t) if per_step else n
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, shape)]


def case_mlp_mcxent(dropout):
    return _build([L.DenseLayer(n_out=5, activation="tanh"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.feed_forward(3), dropout), _data()


def case_mlp_mse_identity(dropout):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    y = rng.standard_normal((5, 2)).astype(np.float32)
    return _build([L.DenseLayer(n_out=4, activation="sigmoid"),
                   L.OutputLayer(n_out=2, activation="identity", loss="mse")],
                  I.feed_forward(3), dropout), DataSet(x, y)


def case_mlp_with_l1_l2(dropout):
    return _build([L.DenseLayer(n_out=4, activation="relu"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.feed_forward(3), dropout, l1=1e-2, l2=1e-2), _data(seed=3)


def case_cnn(dropout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 2)]
    return _build([L.ConvolutionLayer(n_out=2, kernel_size=3, activation="tanh"),
                   L.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.convolutional(6, 6, 1), dropout), DataSet(x, y)


def case_cnn_maxpool_batchnorm(dropout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 6, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3)]
    return _build([L.ConvolutionLayer(n_out=2, kernel_size=3, activation="identity"),
                   L.BatchNormalization(),
                   L.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.convolutional(6, 6, 1), dropout), DataSet(x, y)


def case_lstm_global_pool(dropout):
    x, y = _rnn_data(3, 5, 2, 2, per_step=False)
    return _build([L.LSTM(n_out=3), L.GlobalPoolingLayer(pooling_type="avg"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.recurrent(2, 5), dropout), DataSet(x, y)


def case_graves_lstm_global_pool(dropout):
    x, y = _rnn_data(2, 4, 2, 2, per_step=False)
    return _build([L.GravesLSTM(n_out=3), L.GlobalPoolingLayer(pooling_type="max"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.recurrent(2, 4), dropout), DataSet(x, y)


def case_simple_rnn_masked_pool(dropout):
    rng = np.random.default_rng(0)
    n, t = 3, 5
    x = rng.standard_normal((n, t, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    mask = (np.arange(t)[None, :] < rng.integers(2, t + 1, n)[:, None]).astype(np.float32)
    return _build([L.SimpleRnn(n_out=3), L.GlobalPoolingLayer(pooling_type="avg"),
                   L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                  I.recurrent(2, t), dropout), DataSet(x, y, features_mask=mask)


def case_self_attention_pool(dropout):
    net = _build([L.SelfAttentionLayer(n_heads=2, causal=True, attention_dropout=0.1 * dropout),
                  L.GlobalPoolingLayer(pooling_type="avg"),
                  L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                 I.recurrent(6, 4), dropout)
    x, y = _rnn_data(2, 4, 6, 2, per_step=False, seed=6)
    return net, DataSet(x, y)


LOSSES = [("xent", "sigmoid"), ("l2", "identity"), ("mae", "identity"),
          ("kl_divergence", "softmax"), ("poisson", "softplus"), ("squared_hinge", "identity")]


def loss_case(loss, act):
    def case(dropout):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((4, 3)).astype(np.float32)
        if loss in ("xent", "kl_divergence"):
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        elif loss == "poisson":
            y = rng.poisson(2.0, (4, 2)).astype(np.float32)
        elif loss == "squared_hinge":
            y = (2 * rng.integers(0, 2, (4, 2)) - 1).astype(np.float32)
        else:
            y = rng.standard_normal((4, 2)).astype(np.float32)
        return _build([L.DenseLayer(n_out=4, activation="tanh"),
                       L.OutputLayer(n_out=2, activation=act, loss=loss)],
                      I.feed_forward(3), dropout), DataSet(x, y)
    return case


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
CASES.update({f"loss_{loss}_{act}": loss_case(loss, act) for loss, act in LOSSES})


def test_reference_thresholds():
    assert (DEFAULT_EPS, DEFAULT_MAX_REL_ERROR, DEFAULT_MIN_ABS_ERROR) == (1e-6, 1e-3, 1e-8)


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_check(name, dropout):
    net, ds = CASES[name](dropout)
    assert check_gradients(net, ds, print_results=True), name
    # the checker leaves the model's forward in its own dtype
    assert net._input_dtype is None


def _graph(dropout):
    b = (tconf.NeuralNetConfiguration.builder().seed(7).updater(tupd.Sgd(0.1))
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("a", L.DenseLayer(n_out=4, activation="tanh"), "in")
         .add_layer("b", L.DenseLayer(n_out=4, activation="sigmoid",
                                      dropout=0.3 if dropout else 0.0), "in")
         .add_vertex("sum", ElementWiseVertex("add"), "a", "b")
         .add_layer("out", L.OutputLayer(n_out=2, activation="softmax", loss="mcxent",
                                         dropout=L.GaussianDropout(0.2) if dropout else 0.0,
                                         weight_noise=L.WeightNoise(0.1) if dropout else None),
                    "sum")
         .set_outputs("out").set_input_types(tconf.InputType.feed_forward(3)))
    return ComputationGraph(b.build()).init(device="cpu")


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_gradient_check_graph(dropout):
    assert check_gradients_graph(_graph(dropout), _data(n=5, seed=4), print_results=True)


class _WrongGrad(torch.autograd.Function):
    """The identity forward whose backward adds 0.1 to the gradient: a
    layer's analytic gradient made wrong, its loss unchanged."""

    @staticmethod
    def forward(ctx, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g + 0.1


def _plant_wrong_gradient(layer):
    apply = layer.apply

    def wrong(params, x, **kw):
        y, st = apply(params, x, **kw)
        return _WrongGrad.apply(y), st

    layer.apply = wrong


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_a_wrong_gradient_fails(kind):
    if kind == "mln":
        net, ds = CASES["mlp_mcxent"](True)
        assert check_gradients(net, ds)
        _plant_wrong_gradient(net.layers[0])
        assert not check_gradients(net, ds)
    else:
        net, ds = _graph(True), _data(n=5, seed=4)
        assert check_gradients_graph(net, ds)
        _plant_wrong_gradient(net._layer("a"))
        assert not check_gradients_graph(net, ds)
