"""The port's ResNet-50 path against the JAX package, on the CPU.

Weights move from the JAX models into the port through
``interop.load_jax_params`` (the two packages draw different numbers from
one seed). BatchNormalization statistics and affine params are randomized
from a numpy seed so that BN is not the identity; the last BN of each
residual branch gets a small gamma, which keeps the residual stream, and
so the softmax, unsaturated (with identity BN the logits of a random
ResNet-50 are in the hundreds and every probability is 0 or 1).

Tolerances:
- float32: 1e-4 absolute on probabilities (f32 summation order only).
- bfloat16: 0.03 absolute on probabilities, and top-1 agreement on every row
  whose reference top-2 gap exceeds twice the measured difference. The
  packages round to bf16 after the same operations, but XLA may keep
  elementwise chains in f32 (excess precision) and sums in another order,
  so single bf16 roundings differ by a step and the differences compound
  over the 50 conv layers (measured 0.010 on this 32x32 input).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.models.resnet50 import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import ResNet50 as TResNet50
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration as TConf,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph

BF16_PROB_TOL = 0.03
F32_PROB_TOL = 1e-4


def randomize_bn(params, state, seed):
    """Seeded BN running stats and affine params on numpy dicts, in place."""
    rng = np.random.default_rng(seed)
    for v in sorted(params):
        for k in sorted(params[v]):
            a = params[v][k]
            if k.startswith("gamma"):
                small = k == "gamma_c" or v.endswith("_c_bn")
                lo, hi = (0.1, 0.3) if small else (0.5, 1.5)
                params[v][k] = rng.uniform(lo, hi, a.shape).astype(np.float32)
            elif k.startswith("beta"):
                params[v][k] = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    for v in sorted(state):
        for k in sorted(state[v]):
            a = state[v][k]
            if k.startswith("mean"):
                state[v][k] = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            elif k.startswith("var"):
                state[v][k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)


def _numpy_tree(tree):
    return {v: {k: np.array(a, np.float32) for k, a in d.items()}
            for v, d in tree.items()}


def _jax_tree(tree):
    return {v: {k: jnp.asarray(a) for k, a in d.items()} for v, d in tree.items()}


def _pair(jconf_, tconf_, params, state):
    """A JAX graph and a port graph (CPU) holding the same weights."""
    jg = JGraph(jconf_)
    jg.params_, jg.state_ = _jax_tree(params), _jax_tree(state)
    tg = TGraph(tconf_).init(device="cpu")
    load_jax_params(tg, params, state)
    return jg, tg


def _assert_probs(a, b, dtype):
    assert a.shape == b.shape and np.isfinite(b).all()
    d = float(np.abs(a - b).max())
    if dtype is None:
        assert d <= F32_PROB_TOL, d
        assert (a.argmax(1) == b.argmax(1)).all()
    else:
        assert d <= BF16_PROB_TOL, d
        top2 = np.sort(a, 1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * d
        assert (a.argmax(1) == b.argmax(1))[decided].all()


# --------------------------------------------------------------------- block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,project", [(1, False), (1, True), (2, True)],
                         ids=["identity", "project", "stride2"])
def test_bottleneck_eval_matches_jax(stride, project, dtype):
    width = 8
    cin = 12 if project else 4 * width
    jl = jlayers.FusedResNetBottleneck(width=width, stride=stride, project=project)
    tl = tlayers.FusedResNetBottleneck(width=width, stride=stride, project=project)
    jl.initialize(jconf.InputType.convolutional(9, 11, cin))
    tl.initialize(tconf.InputType.convolutional(9, 11, cin))
    it = jconf.InputType.convolutional(9, 11, cin)
    params = {"b": {k: np.array(v) for k, v in
                    jl.init_params(jax.random.PRNGKey(3), it).items()}}
    state = {"b": {k: np.array(v) for k, v in jl.init_layer_state(it).items()}}
    randomize_bn(params, state, 5)
    x = np.random.default_rng(1).standard_normal((2, 9, 11, cin)).astype(np.float32)

    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = {k: jnp.asarray(v, jdt if k.startswith("W") else jnp.float32)
          for k, v in params["b"].items()}
    tp = {k: torch.from_numpy(v).to(tdt if k.startswith("W") else torch.float32)
          for k, v in params["b"].items()}
    js = {k: jnp.asarray(v) for k, v in state["b"].items()}
    ts = {k: torch.from_numpy(v) for k, v in state["b"].items()}
    jy, _ = jl.apply(jp, jnp.asarray(x, jdt), state=js, train=False)
    ty, _ = tl.apply(tp, torch.from_numpy(x).to(tdt), state=ts, train=False)
    jy = np.asarray(jy, np.float32)
    ty = ty.float().numpy()
    assert ty.shape == jy.shape == (2, -(-9 // stride), -(-11 // stride), 4 * width)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    else:
        # three chained bf16 convs + the bf16 normalize/add: a few bf16 steps
        # of the output's scale
        err = np.abs(ty - jy)
        assert err.max() <= 4 * 2.0 ** -7 * np.abs(jy).max(), err.max()
        assert np.median(err) <= 2.0 ** -7 * np.median(np.abs(jy))


def test_bottleneck_train_mode_is_refused():
    tl = tlayers.FusedResNetBottleneck(width=4, project=True)
    tl.initialize(tconf.InputType.convolutional(4, 4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.apply({}, torch.zeros((1, 4, 4, 4)), state={"mean_a": 0}, train=True)


# -------------------------------------------------------------- narrow graph
def _narrow(conf_pkg, layers, compute_dtype):
    """Stem, pool, two bottlenecks, avgpool, output: the same builder calls
    in either package."""
    gb = (conf_pkg.NeuralNetConfiguration.builder().seed(7).weight_init("relu")
          .compute_dtype(compute_dtype).graph_builder().add_inputs("input")
          .set_input_types(conf_pkg.InputType.convolutional(15, 17, 3)))
    gb.add_layer("stem_conv", layers.ConvolutionLayer(
        n_out=16, kernel_size=7, stride=2, convolution_mode="same",
        activation="identity", has_bias=False), "input")
    gb.add_layer("stem_bn", layers.BatchNormalization(), "stem_conv")
    gb.add_layer("stem_relu", layers.ActivationLayer(activation="relu"), "stem_bn")
    gb.add_layer("stem_pool", layers.SubsamplingLayer(
        kernel_size=3, stride=2, convolution_mode="same"), "stem_relu")
    gb.add_layer("b0", layers.FusedResNetBottleneck(width=8, stride=2, project=True),
                 "stem_pool")
    gb.add_layer("b1", layers.FusedResNetBottleneck(width=8), "b0")
    gb.add_layer("avgpool", layers.GlobalPoolingLayer(pooling_type="avg"), "b1")
    gb.add_layer("output", layers.OutputLayer(n_out=10, activation="softmax",
                                              loss="mcxent"), "avgpool")
    gb.set_outputs("output")
    return gb.build()


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_narrow_graph_matches_jax(compute_dtype):
    jc = _narrow(jconf, jlayers, compute_dtype)
    tc = _narrow(tconf, tlayers, compute_dtype)
    assert tc.to_dict() == jc.to_dict()
    ref = JGraph(jc).init()
    params, state = _numpy_tree(ref.params_), _numpy_tree(ref.state_)
    randomize_bn(params, state, 9)
    jg, tg = _pair(jc, tc, params, state)
    x = np.random.default_rng(2).standard_normal((5, 15, 17, 3)).astype(np.float32)
    _assert_probs(jg.output_single(x), tg.output_single(x), compute_dtype)


# ------------------------------------------------------------------ ResNet-50
@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def resnet50_weights(request):
    """The JAX ResNet-50 (10 classes, 32x32) built once per variant: its
    params/state as numpy, with randomized BN."""
    fused = request.param
    jm = JResNet50(num_classes=10, height=32, width=32, fused_pallas=fused).init()
    params, state = _numpy_tree(jm.params_), _numpy_tree(jm.state_)
    randomize_bn(params, state, 11)
    return fused, params, state


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_resnet50_matches_jax(resnet50_weights, compute_dtype):
    fused, params, state = resnet50_weights
    kw = dict(num_classes=10, height=32, width=32, fused_pallas=fused,
              compute_dtype=compute_dtype)
    jc, tc = JResNet50(**kw).conf(), TResNet50(**kw).conf()
    jg, tg = _pair(jc, tc, params, state)
    x = np.random.default_rng(4).standard_normal((6, 32, 32, 3)).astype(np.float32)
    _assert_probs(jg.output_single(x), tg.output_single(x), compute_dtype)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_resnet50_conf_dict_is_the_references(fused):
    """Same configuration dict both ways: the port writes the reference's
    dict, and reads the reference's JSON back into an equal configuration."""
    kw = dict(num_classes=1000, fused_pallas=fused, compute_dtype="bfloat16")
    jc, tc = JResNet50(**kw).conf(), TResNet50(**kw).conf()
    assert tc.to_dict() == jc.to_dict()
    assert TConf.from_json(jc.to_json()) == tc


def test_resnet50_full_size_shapes_and_launch_plan():
    """Full-size config: 16 fused bottlenecks (36 pointwise + 16 3x3 convs)
    and the reference's 25.6M parameters."""
    tc = TResNet50(num_classes=1000, fused_pallas=True).conf()
    blocks = [v.layer for v in tc.vertices.values()
              if type(getattr(v, "layer", None)).__name__ == "FusedResNetBottleneck"]
    assert len(blocks) == 16
    assert 2 * len(blocks) + sum(b.project for b in blocks) == 36
    lt = tc.layer_input_types()
    assert lt["output"].size == 2048 and lt["s0b0"].height == 56
    assert TGraph(tc).init(device="cpu").num_params() == 25_557_032


def test_space_to_depth_stem_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TResNet50(stem_space_to_depth=True).conf()


def test_load_jax_params_rejects_mismatches(resnet50_weights):
    fused, params, state = resnet50_weights
    tg = TResNet50(num_classes=10, height=32, width=32,
                   fused_pallas=fused).init(device="cpu")
    bad = {v: dict(d) for v, d in params.items()}
    bad["output"]["W"] = bad["output"]["W"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tg, bad, state)
    with pytest.raises(KeyError):
        load_jax_params(tg, {k: v for k, v in params.items() if k != "output"}, state)


# ------------------------------------------------------------ stem geometry
@pytest.mark.parametrize("size", [224, 15, 16])
def test_same_padding_is_xla_asymmetric(size):
    """The stride-2 SAME conv and max-pool pad (lo, hi) like XLA (224: the
    stem pads (2, 3) and the pool (0, 1) with -inf)."""
    from deeplearning4j_tpu_torch.nn.conf.layers.conv import same_pads

    if size == 224:
        assert same_pads(224, 7, 2) == (2, 3) and same_pads(112, 3, 2) == (0, 1)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size + 1, 3)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 4)) * 0.1).astype(np.float32)
    kw = dict(n_out=4, kernel_size=7, stride=2, convolution_mode="same",
              activation="identity", has_bias=False)
    jl, tl = jlayers.ConvolutionLayer(**kw), tlayers.ConvolutionLayer(**kw)
    jy, _ = jl.apply({"W": jnp.asarray(w)}, jnp.asarray(x))
    ty, _ = tl.apply({"W": torch.from_numpy(w)}, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    pk = dict(kernel_size=3, stride=2, convolution_mode="same")
    jp, _ = jlayers.SubsamplingLayer(**pk).apply({}, jnp.asarray(x - 5.0))
    tp, _ = tlayers.SubsamplingLayer(**pk).apply({}, torch.from_numpy(x - 5.0))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
