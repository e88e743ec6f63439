"""The rest of the layer catalog against the JAX package on the CPU.

Each layer of the port and of JAX is built by the same constructor call;
the same seeded inputs and params (numpy) go through both, in and out of
train mode, and the gradients of ``sum(y * r)`` (``r`` a seeded cotangent)
with respect to the input and the params are compared too. Tolerance: 1e-5
of the largest magnitude (f32) for outputs and gradients (``TOL``).

- The 2-D layers: Deconvolution2D (kernels 2, 3, 4 x strides 1, 2 x
  "same" and "truncate", XLA's uneven transposed SAME padding),
  DepthwiseConvolution2D and SeparableConvolution2D (depth multipliers 1
  and 2, odd and even kernels, strides, dilation), Upsampling2D,
  ZeroPaddingLayer, Cropping2D, SpaceToBatchLayer (its batch order) and
  the alias Pooling2D.
- The 1-D layers over (b, T, C): Convolution1DLayer (XLA's uneven SAME),
  Subsampling1DLayer (max; avg divided by the in-range count), Upsampling1D,
  ZeroPadding1DLayer and the alias Pooling1D.
- DropoutLayer, EmbeddingLayer and EmbeddingSequenceLayer (float indices,
  repeated rows), ElementWiseMultiplicationLayer, AutoEncoder's forward,
  DummyLayer and MaskLayer.
- Each layer's output type equals JAX's; its deterministic params equal
  JAX's init and its random ones have the moments of the same scheme;
  its configuration dict equals JAX's and decodes in the other package,
  alone and inside a network configuration written by JAX.
- Each gradient passes the port's float64 checker (``nn/gradient_check.py``)
  in a small network, as JAX's ``tests/test_gradient_check.py`` checks it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.nn.conf import layers as J
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as T
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.gradient_check import check_gradients
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1.0))


def _pair(kind, kw, input_type):
    """The layer in both packages, initialized at ``input_type`` (an
    ``InputType`` factory name and its args), and the port's params as
    numpy (carried to JAX)."""
    jl, tl = getattr(J, kind)(**kw), getattr(T, kind)(**kw)
    name, args = input_type
    jt, tt = getattr(jconf.InputType, name)(*args), getattr(tconf.InputType, name)(*args)
    for layer in (jl, tl):
        if hasattr(layer, "activation") and layer.activation is None:
            layer.activation = "identity"
        if hasattr(layer, "weight_init") and layer.weight_init is None:
            layer.weight_init = "xavier"
    jl.initialize(jt)
    tl.initialize(tt)
    assert tl.get_output_type(tt).to_dict() == jl.get_output_type(jt).to_dict()
    params = {k: v.numpy() for k, v in tl.init_params(torch.Generator().manual_seed(0), tt).items()}
    jshapes = {k: tuple(v.shape) for k, v in jl.init_params(jax.random.PRNGKey(0), jt).items()}
    assert {k: v.shape for k, v in params.items()} == jshapes
    return jl, tl, params


def _compare(jl, tl, x, params, *, train=False, mask=None, x_grad=True):
    """Forward and the gradients of sum(y * r) (x and params) in both."""
    def jf(p, a):
        y, _ = jl.apply(p, a, state={}, train=train,
                        mask=None if mask is None else jnp.asarray(mask))
        return y

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    r = _rand(jy.shape, 99)
    jgp, jgx = jax.jit(jax.grad(lambda p, a: jnp.sum(jf(p, a) * r), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=x_grad)
    ty, _ = tl.apply(tp, tx, state={}, train=train,
                     mask=None if mask is None else torch.tensor(mask))
    if ty.requires_grad:
        (ty * torch.from_numpy(r)).sum().backward()
    _close(ty.detach().numpy(), jy)
    if x_grad:
        _close(tx.grad.numpy(), np.asarray(jgx))
    for k in params:  # a param the output does not read has no gradient
        g = tp[k].grad
        _close(np.zeros_like(params[k]) if g is None else g.numpy(), np.asarray(jgp[k]))
    return ty.detach().numpy()


def _json_both_ways(jl, tl):
    jd, td = jserde.encode(jl), tserde.encode(tl)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert td["@class"] == type(jl).__name__
    assert tserde.decode(jd) == tl
    assert jserde.encode(tserde.decode(jd)) == jd
    assert jserde.decode(td) == jl


TRAIN = pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])


def _case(kind, kw, itype, x, train, **more):
    jl, tl, params = _pair(kind, kw, itype)
    y = _compare(jl, tl, x, params, train=train, **more)
    _json_both_ways(jl, tl)
    return y


# --------------------------------------------------------------- 2-D layers
@TRAIN
@pytest.mark.parametrize("mode", ["same", "truncate", "truncate_pad1"])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_deconvolution2d(k, s, mode, train):
    kw = dict(n_out=2, kernel_size=k, stride=s, activation="tanh",
              convolution_mode=mode.split("_")[0], padding=1 if mode.endswith("pad1") else 0)
    y = _case("Deconvolution2D", kw, ("convolutional", (5, 4, 3)), _rand((2, 5, 4, 3), k * s),
              train)
    if mode == "same":
        assert y.shape == (2, 5 * s, 4 * s, 2)


def test_deconvolution2d_is_the_gradient_of_the_forward_conv():
    """With the forward conv's padding p, the transposed conv is that conv's
    input gradient (JAX's own regression)."""
    for p in (0, 1):
        jl, tl, params = _pair("Deconvolution2D", dict(
            n_out=2, kernel_size=3, stride=2, padding=p, activation="identity",
            has_bias=False), ("convolutional", (5, 5, 3)))
        x = _rand((2, 5, 5, 3), 7 + p)
        y, _ = tl.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
        h = 2 * 4 + 3 - 2 * p
        z = torch.zeros((2, 2, h, h), requires_grad=True)
        w = torch.tensor(params["W"]).permute(3, 2, 0, 1)
        fwd = torch.nn.functional.conv2d(z, w, stride=2, padding=p)
        (g,) = torch.autograd.grad(fwd, z, torch.tensor(x).permute(0, 3, 1, 2))
        _close(y.numpy(), g.permute(0, 2, 3, 1).numpy())


SPATIAL = {
    "k3s1_same": dict(kernel_size=3, stride=1, convolution_mode="same"),
    "k3s2_same": dict(kernel_size=3, stride=2, convolution_mode="same"),
    "k2s2_same": dict(kernel_size=2, stride=2, convolution_mode="same"),
    "k2s1_truncate": dict(kernel_size=2, stride=1),
    "k3s2_truncate_pad1": dict(kernel_size=3, stride=2, padding=1),
    "k3x2s1x2_same": dict(kernel_size=(3, 2), stride=(1, 2), convolution_mode="same"),
    "k3s1_same_dil2": dict(kernel_size=3, stride=1, convolution_mode="same", dilation=2),
    "k3s1_truncate_dil2": dict(kernel_size=3, stride=1, dilation=2),
}


@TRAIN
@pytest.mark.parametrize("dm", [1, 2])
@pytest.mark.parametrize("conv", sorted(SPATIAL))
def test_depthwise(conv, dm, train):
    kw = dict(SPATIAL[conv], depth_multiplier=dm, activation="relu")
    y = _case("DepthwiseConvolution2D", kw, ("convolutional", (7, 6, 3)),
              _rand((2, 7, 6, 3), 3), train)
    assert y.shape[-1] == 3 * dm


def test_depthwise_channel_order():
    """Output channel c*dm + m reads input channel c alone."""
    jl, tl, params = _pair("DepthwiseConvolution2D", dict(
        kernel_size=1, depth_multiplier=2, has_bias=False, activation="identity"),
        ("convolutional", (2, 2, 3)))
    w = np.zeros((1, 1, 1, 6), np.float32)
    w[0, 0, 0, :] = [1, 10, 2, 20, 3, 30]
    x = np.tile(np.array([1.0, 100.0, 10000.0], np.float32), (1, 2, 2, 1))
    y, _ = tl.apply({"W": torch.tensor(w)}, torch.tensor(x))
    np.testing.assert_array_equal(y[0, 0, 0].numpy(), [1, 10, 200, 2000, 30000, 300000])


@TRAIN
@pytest.mark.parametrize("dm", [1, 2])
@pytest.mark.parametrize("conv", sorted(SPATIAL))
def test_separable(conv, dm, train):
    kw = dict(SPATIAL[conv], depth_multiplier=dm, n_out=5, activation="identity")
    _case("SeparableConvolution2D", kw, ("convolutional", (7, 6, 3)), _rand((2, 7, 6, 3), 4),
          train)


SHAPE_LAYERS = {
    "upsampling2d_2": ("Upsampling2D", dict(size=2)),
    "upsampling2d_2x3": ("Upsampling2D", dict(size=(2, 3))),
    "zeropad_1": ("ZeroPaddingLayer", dict(pad=1)),
    "zeropad_1x2": ("ZeroPaddingLayer", dict(pad=(1, 2))),
    "zeropad_0101": ("ZeroPaddingLayer", dict(pad=(0, 1, 0, 1))),
    "crop_1": ("Cropping2D", dict(crop=1)),
    "crop_1x0": ("Cropping2D", dict(crop=(1, 0))),
    "crop_0123": ("Cropping2D", dict(crop=(0, 1, 2, 0))),
    "space_to_batch_2": ("SpaceToBatchLayer", dict(blocks=2)),
    "space_to_batch_2x3": ("SpaceToBatchLayer", dict(blocks=(2, 3))),
    "pooling2d_avg_same": ("Pooling2D", dict(pooling_type="avg", kernel_size=3, stride=2,
                                             convolution_mode="same")),
    "pooling2d_max": ("Pooling2D", dict(kernel_size=2, stride=2)),
}


@TRAIN
@pytest.mark.parametrize("case", sorted(SHAPE_LAYERS))
def test_shape_layers(case, train):
    kind, kw = SHAPE_LAYERS[case]
    _case(kind, kw, ("convolutional", (6, 6, 3)), _rand((2, 6, 6, 3), 5), train)


def test_space_to_batch_order():
    """Batch index (i*bw + j)*b + n holds pixel (y*bh + i, x*bw + j) of
    example n."""
    _, tl, _ = _pair("SpaceToBatchLayer", dict(blocks=(2, 3)), ("convolutional", (4, 6, 1)))
    x = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6, 1)
    y = tl.apply({}, torch.tensor(x))[0].numpy()
    for i in range(2):
        for j in range(3):
            for n in range(2):
                np.testing.assert_array_equal(y[(i * 3 + j) * 2 + n], x[n, i::2, j::3])


# --------------------------------------------------------------- 1-D layers
CONV1D = {
    "k3s1_truncate": dict(kernel_size=3, stride=1),
    "k3s2_truncate_pad1": dict(kernel_size=3, stride=2, padding=1),
    "k2s1_same": dict(kernel_size=2, stride=1, convolution_mode="same"),
    "k3s2_same": dict(kernel_size=3, stride=2, convolution_mode="same"),
    "k4s2_same": dict(kernel_size=4, stride=2, convolution_mode="same"),
    "k3s1_same_dil2": dict(kernel_size=3, stride=1, dilation=2, convolution_mode="same"),
}


@TRAIN
@pytest.mark.parametrize("conv", sorted(CONV1D))
def test_convolution1d(conv, train):
    _case("Convolution1DLayer", dict(CONV1D[conv], n_out=4, activation="tanh"),
          ("recurrent", (3, 9)), _rand((2, 9, 3), 6), train)


POOL1D = {
    "k2s2": dict(kernel_size=2, stride=2),
    "k3s2_pad1": dict(kernel_size=3, stride=2, padding=1),
    "k3s1_same": dict(kernel_size=3, stride=1, convolution_mode="same"),
    "k2s2_same": dict(kernel_size=2, stride=2, convolution_mode="same"),
    "k4s3_same": dict(kernel_size=4, stride=3, convolution_mode="same"),
}


@TRAIN
@pytest.mark.parametrize("kind", ["Subsampling1DLayer", "Pooling1D"])
@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("pool", sorted(POOL1D))
def test_subsampling1d(pool, ptype, kind, train):
    _case(kind, dict(POOL1D[pool], pooling_type=ptype), ("recurrent", (3, 9)),
          _rand((2, 9, 3), 7), train)


@TRAIN
@pytest.mark.parametrize("case", ["up2", "up3", "pad1", "pad2x0"])
def test_1d_shape_layers(case, train):
    kind, kw = {"up2": ("Upsampling1D", dict(size=2)), "up3": ("Upsampling1D", dict(size=3)),
                "pad1": ("ZeroPadding1DLayer", dict(pad=1)),
                "pad2x0": ("ZeroPadding1DLayer", dict(pad=(2, 0)))}[case]
    _case(kind, kw, ("recurrent", (3, 5)), _rand((2, 5, 3), 8), train)


# ---------------------------------------------------- core and utility layers
def _ids(shape, vocab, seed):
    """Indices as floats, each id at least twice (repeated rows)."""
    ids = np.random.default_rng(seed).integers(0, vocab, shape)
    ids.reshape(-1)[1] = ids.reshape(-1)[0]
    return ids.astype(np.float32)


@TRAIN
@pytest.mark.parametrize("shape", [(6,), (6, 1)], ids=["b", "b1"])
def test_embedding(shape, train):
    _case("EmbeddingLayer", dict(n_in=5, n_out=4, activation="tanh"),
          ("feed_forward", (1,)), _ids(shape, 5, 9), train, x_grad=False)


@TRAIN
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape", [(3, 7), (3, 7, 1)], ids=["bT", "bT1"])
def test_embedding_sequence(shape, bias, train):
    y = _case("EmbeddingSequenceLayer", dict(n_in=6, n_out=4, has_bias=bias),
              ("recurrent", (1, 7)), _ids(shape, 6, 10), train, x_grad=False)
    assert y.shape == (3, 7, 4)


def test_embedding_gradient_sums_repeated_rows():
    """A row looked up k times gets the sum of its k output gradients."""
    _, tl, params = _pair("EmbeddingSequenceLayer", dict(n_in=4, n_out=3),
                          ("recurrent", (1, 5)))
    w = torch.tensor(params["W"], requires_grad=True)
    ids = torch.tensor([[2.0, 2.0, 0.0, 2.0, 1.0]])
    y, _ = tl.apply({"W": w}, ids)
    g = torch.arange(15, dtype=torch.float32).reshape(1, 5, 3)
    (y * g).sum().backward()
    np.testing.assert_array_equal(w.grad[2].numpy(), (g[0, 0] + g[0, 1] + g[0, 3]).numpy())
    np.testing.assert_array_equal(w.grad[3].numpy(), np.zeros(3, np.float32))


@TRAIN
@pytest.mark.parametrize("itype", [("feed_forward", (5,)), ("recurrent", (5, 4))],
                         ids=["ff", "rnn"])
def test_elementwise_multiplication(itype, train):
    jl, tl, params = _pair("ElementWiseMultiplicationLayer", dict(activation="tanh"), itype)
    np.testing.assert_array_equal(params["W"], np.ones(5, np.float32))
    params["W"] = _rand((5,), 11)
    shape = (3, 5) if itype[0] == "feed_forward" else (3, 4, 5)
    _compare(jl, tl, _rand(shape, 12), params, train=train)
    _json_both_ways(jl, tl)


@TRAIN
def test_autoencoder_forward(train):
    jl, tl, params = _pair("AutoEncoder", dict(n_out=4, corruption_level=0.3,
                                                activation="sigmoid"), ("feed_forward", (6,)))
    np.testing.assert_array_equal(params["vb"], np.zeros(6, np.float32))
    params["vb"] = _rand((6,), 13)
    _compare(jl, tl, _rand((3, 6), 14), params, train=train)
    _json_both_ways(jl, tl)


@TRAIN
@pytest.mark.parametrize("kind", ["DropoutLayer", "DummyLayer", "MaskLayer"])
def test_identity_layers(kind, train):
    kw = {"dropout": 0.3} if kind == "DropoutLayer" else {}
    x = _rand((3, 4, 5), 15)
    _case(kind, kw, ("recurrent", (5, 4)), x, train)


@TRAIN
def test_mask_layer_zeroes_masked_steps(train):
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.float32)
    y = _case("MaskLayer", {}, ("recurrent", (5, 4)), _rand((3, 4, 5), 16), train, mask=mask)
    assert np.all(y[0, 2:] == 0) and np.all(y[2, 1:] == 0)


# ------------------------------------------------------------------- inits
MOMENT_LAYERS = [
    ("Deconvolution2D", dict(n_out=48, kernel_size=3, weight_init="xavier"),
     ("convolutional", (4, 4, 40)), "W"),
    ("DepthwiseConvolution2D", dict(kernel_size=3, depth_multiplier=2, weight_init="relu"),
     ("convolutional", (4, 4, 300)), "W"),
    ("SeparableConvolution2D", dict(n_out=64, kernel_size=3, weight_init="xavier"),
     ("convolutional", (4, 4, 200)), "pW"),
    ("Convolution1DLayer", dict(n_out=64, kernel_size=3, weight_init="xavier"),
     ("recurrent", (80, 10)), "W"),
    ("EmbeddingSequenceLayer", dict(n_in=500, n_out=64, weight_init="xavier"),
     ("recurrent", (1, 10)), "W"),
    ("AutoEncoder", dict(n_out=64, weight_init="xavier"), ("feed_forward", (300,)), "W"),
]


@pytest.mark.parametrize("kind,kw,itype,name", MOMENT_LAYERS, ids=[m[0] for m in MOMENT_LAYERS])
def test_init_moments_and_deterministic_params(kind, kw, itype, name):
    """The random weights: the mean and std of the same scheme at the same
    fans (within 5% of the std); every other param equals JAX's init."""
    jl, tl, params = _pair(kind, dict(kw, bias_init=0.25), itype)
    jt = getattr(jconf.InputType, itype[0])(*itype[1])
    jp = {k: np.asarray(v) for k, v in jl.init_params(jax.random.PRNGKey(3), jt).items()}
    a, b = params[name], jp[name]
    assert abs(a.std() - b.std()) < 0.05 * b.std()
    assert abs(a.mean()) < 0.05 * b.std() and abs(b.mean()) < 0.05 * b.std()
    for k in params:
        if k != name and not (kind == "SeparableConvolution2D" and k == "dW"):
            np.testing.assert_array_equal(params[k], jp[k])


# ------------------------------------------------- configurations written by JAX
def _jax_conf():
    """A list configuration written by JAX holding every new 2-D layer."""
    L = J
    b = jconf.NeuralNetConfiguration.builder().seed(3).weight_init("xavier")
    lb = b.list()
    for layer in [L.ZeroPaddingLayer(pad=(0, 1, 0, 1)),
                  L.DepthwiseConvolution2D(kernel_size=3, stride=2, depth_multiplier=2),
                  L.SeparableConvolution2D(n_out=6, kernel_size=3, convolution_mode="same"),
                  L.Deconvolution2D(n_out=4, kernel_size=2, stride=2),
                  L.Cropping2D(crop=(1, 0, 0, 1)),
                  L.Upsampling2D(size=2),
                  L.SpaceToBatchLayer(blocks=2),
                  L.Pooling2D(pooling_type="max", kernel_size=2, stride=2),
                  L.DropoutLayer(dropout=0.2),
                  L.GlobalPoolingLayer(pooling_type="avg"),
                  L.ElementWiseMultiplicationLayer(activation="identity"),
                  L.AutoEncoder(n_out=5),
                  L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]:
        lb = lb.layer(layer)
    return lb.set_input_type(jconf.InputType.convolutional(9, 9, 3)).build()


def _jax_conf_1d():
    L = J
    lb = jconf.NeuralNetConfiguration.builder().seed(4).list()
    for layer in [L.EmbeddingSequenceLayer(n_in=20, n_out=6, has_bias=True),
                  L.Convolution1DLayer(n_out=5, kernel_size=3, convolution_mode="same"),
                  L.Subsampling1DLayer(pooling_type="avg", kernel_size=2, stride=2),
                  L.Upsampling1D(size=2),
                  L.ZeroPadding1DLayer(pad=(1, 0)),
                  L.Pooling1D(kernel_size=2, stride=1),
                  L.MaskLayer(), L.DummyLayer(),
                  L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")]:
        lb = lb.layer(layer)
    return lb.set_input_type(jconf.InputType.recurrent(1, 8)).build()


@pytest.mark.parametrize("which", ["2d", "1d"])
def test_jax_written_configuration_decodes_and_serves(which):
    """JAX's JSON decodes in the port and re-encodes equal; the network's
    output equals JAX's from the same params."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch import interop

    jc = _jax_conf() if which == "2d" else _jax_conf_1d()
    text = jc.to_json()
    tc = MultiLayerConfiguration.from_json(text)
    assert json.loads(tc.to_json()) == json.loads(text)
    net = MultiLayerNetwork(tc).init(rng=1, device="cpu")
    jnet = JMLN(jc).init()
    jnet.params_ = [{k: jnp.asarray(v) for k, v in p.items()}
                    for p in interop.export_params(net)]
    if which == "2d":
        x = _rand((2, 9, 9, 3), 17)
    else:
        x = _ids((2, 8), 20, 18)
    _close(net.output(x), np.asarray(jnet.output(x)))


# ------------------------------------------------------- the f64 checker
@pytest.fixture
def one_thread():
    """The checker's thousands of tiny float64 ops on one intra-op thread:
    several test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(layers, input_type):
    b = tconf.NeuralNetConfiguration.builder().seed(7).updater(tupd.Sgd(0.1)).weight_init(
        "xavier")
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    return MultiLayerNetwork(lb.set_input_type(input_type).build()).init(device="cpu")


def _labels(n, classes, seed, steps=None):
    rng = np.random.default_rng(seed)
    shape = n if steps is None else (n, steps)
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, shape)]


def _head(n=2):
    return [T.GlobalPoolingLayer(pooling_type="avg"),
            T.OutputLayer(n_out=n, activation="softmax", loss="mcxent")]


I = tconf.InputType
GRAD_CASES = {
    "deconvolution": lambda: (
        [T.ConvolutionLayer(n_out=2, kernel_size=3, stride=2),
         T.Deconvolution2D(n_out=2, kernel_size=3, stride=2)] + _head(),
        I.convolutional(6, 6, 2), (2, 6, 6, 2)),
    "deconvolution_same_even": lambda: (
        [T.Deconvolution2D(n_out=2, kernel_size=2, stride=2, convolution_mode="same",
                           activation="tanh")] + _head(),
        I.convolutional(3, 3, 2), (3, 3, 3, 2)),
    "separable_upsampling": lambda: (
        [T.SeparableConvolution2D(n_out=3, kernel_size=3, depth_multiplier=2),
         T.Upsampling2D(size=2), T.GlobalPoolingLayer(pooling_type="max"),
         T.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
        I.convolutional(5, 5, 2), (2, 5, 5, 2)),
    "depthwise_dilated": lambda: (
        [T.DepthwiseConvolution2D(kernel_size=3, depth_multiplier=2, dilation=2,
                                  convolution_mode="same", activation="tanh")] + _head(),
        I.convolutional(4, 4, 2), (2, 4, 4, 2)),
    "crop_pad_s2b": lambda: (
        [T.ZeroPaddingLayer(pad=(1, 1)), T.Cropping2D(crop=(0, 1, 1, 0)),
         T.SpaceToBatchLayer(blocks=1),
         T.ConvolutionLayer(n_out=3, kernel_size=2, activation="tanh")] + _head(),
        I.convolutional(4, 4, 2), (3, 4, 4, 2)),
    "conv1d_pipeline": lambda: (
        [T.Convolution1DLayer(n_out=3, kernel_size=3),
         T.Subsampling1DLayer(kernel_size=2, stride=2, pooling_type="avg"),
         T.Upsampling1D(size=2), T.ZeroPadding1DLayer(pad=(1, 0)),
         T.GlobalPoolingLayer(pooling_type="avg"),
         T.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
        I.recurrent(2), (2, 8, 2)),
    "elementwise_autoencoder": lambda: (
        [T.ElementWiseMultiplicationLayer(activation="tanh"),
         T.AutoEncoder(n_out=3, activation="sigmoid"),
         T.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
        I.feed_forward(4), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradient_check(name, one_thread):
    layers, itype, shape = GRAD_CASES[name]()
    net = _net(layers, itype)
    ds = DataSet(_rand(shape, 20), _labels(shape[0], 2, 21))
    assert check_gradients(net, ds, print_results=True), name


@pytest.mark.parametrize("kind", ["sequence", "single"])
def test_gradient_check_embedding(kind, one_thread):
    if kind == "sequence":
        # JAX's case ends in an RnnOutputLayer, whose training is the next
        # slice's (ROADMAP § A5): pooling over time and an OutputLayer here
        layers = [T.EmbeddingSequenceLayer(n_in=5, n_out=3), T.LSTM(n_out=3),
                  T.GlobalPoolingLayer(pooling_type="avg"),
                  T.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]
        net = _net(layers, I.recurrent(1))
        ds = DataSet(_ids((2, 4, 1), 5, 22), _labels(2, 3, 23))
    else:
        layers = [T.EmbeddingLayer(n_in=7, n_out=4, activation="tanh"),
                  T.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]
        net = _net(layers, I.feed_forward(1))
        ds = DataSet(_ids((4, 1), 7, 24), _labels(4, 3, 25))
    assert check_gradients(net, ds, print_results=True)
