"""Card-only tests of the PyTorch port: the CUDA kernels and the engine on
the card. The file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test is marked ``cuda`` and skips without a card (the kernels have no
CPU mode). Tolerances as in ``chip_smoke.py``: kernel ``y`` within one bf16
rounding step plus the worst-case f32 summation-order difference over
depth K; statistics rtol 1e-4, atol 1e-3 at these small shapes.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc
from deeplearning4j_tpu_torch.serving import InferenceEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(x_shape, w_shape, seed):
    g = torch.Generator().manual_seed(seed)
    cin = x_shape[-1]
    x = torch.randn(x_shape, generator=g).to(torch.bfloat16)
    s = torch.randn(cin, generator=g) * 0.2 + 1.0
    t = torch.randn(cin, generator=g) * 0.1
    w = (torch.randn(w_shape, generator=g)
         * math.sqrt(2.0 / math.prod(w_shape[:-1]))).to(torch.bfloat16)
    return [a.cuda() for a in (x, s, t, w)]


def _y_tolerance(op, x, s, t, w, relu_in, y_ref):
    u = fc._fold(x, s, t, relu_in).to(torch.bfloat16).float().abs()
    wa = w.float().abs()
    if op == "pw":
        k, mag = x.shape[1], u @ wa
    else:
        k = 9 * x.shape[3]
        mag = F.conv2d(u.permute(0, 3, 1, 2), wa.permute(3, 2, 0, 1),
                       padding=1).permute(0, 2, 3, 1)
    return 2.0 ** -7 * y_ref.abs() + 2 * k * 2.0 ** -24 * mag


CASES = [
    ("pw", (200, 96), (96, 160)),
    ("pw", (49, 1024), (1024, 512)),      # batch 1 at 7x7
    ("pw", (201, 36), (36, 70)),          # channels off the tile and the 16-byte row
    ("c3", (3, 10, 12, 40), (3, 3, 40, 72)),
    ("c3", (1, 7, 7, 512), (3, 3, 512, 512)),
    ("c3", (2, 9, 5, 36), (3, 3, 36, 70)),
]


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("op,x_shape,w_shape", CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}" for c in CASES])
def test_kernel_matches_plain(card, op, x_shape, w_shape, relu_in):
    x, s, t, w = _inputs(x_shape, w_shape, seed=len(x_shape) * 100 + x_shape[-1])
    kern, plain = ((fc.pw_conv, fc.pw_conv_plain) if op == "pw"
                   else (fc.conv3x3, fc.conv3x3_plain))
    name = "pw_conv" if op == "pw" else "conv3x3"
    before = fc.launch_counts[name]
    y, st = kern(x, s, t, w, relu_in)
    y_ref, st_ref = plain(x, s, t, w, relu_in)
    torch.cuda.synchronize()
    assert fc.launch_counts[name] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == y_ref.shape
    err = (y.float() - y_ref.float()).abs()
    tol = _y_tolerance(op, x, s, t, w, relu_in, y_ref.float())
    assert bool((err <= tol).all()), float((err / tol).max())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-3)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, s, t, w = _inputs((64, 32), (32, 16), seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        fc.pw_conv(x[::2], s, t, w, True)
    with pytest.raises(TypeError):
        fc.pw_conv(x.float(), s, t, w, True)
    with pytest.raises(ValueError):
        fc.pw_conv(x, s[:8], t[:8], w, True)
    with pytest.raises(ValueError):
        fc.pw_conv(x, s.cpu(), t, w, True)
    x4 = x.reshape(1, 8, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        fc.conv3x3(x4[:, ::2, ::2, :], s, t, torch.zeros(
            (3, 3, 32, 8), dtype=torch.bfloat16, device=x.device), True)


def _narrow_conf():
    gb = (NeuralNetConfiguration.builder().seed(5).weight_init("relu")
          .compute_dtype("bfloat16").graph_builder().add_inputs("input")
          .set_input_types(InputType.convolutional(20, 20, 3)))
    gb.add_layer("stem_conv", L.ConvolutionLayer(
        n_out=32, kernel_size=7, stride=2, convolution_mode="same",
        activation="identity", has_bias=False), "input")
    gb.add_layer("stem_bn", L.BatchNormalization(), "stem_conv")
    gb.add_layer("stem_relu", L.ActivationLayer(activation="relu"), "stem_bn")
    gb.add_layer("stem_pool", L.SubsamplingLayer(
        kernel_size=3, stride=2, convolution_mode="same"), "stem_relu")
    gb.add_layer("b0", L.FusedResNetBottleneck(width=16, project=True), "stem_pool")
    gb.add_layer("b1", L.FusedResNetBottleneck(width=16, stride=2, project=True), "b0")
    gb.add_layer("b2", L.FusedResNetBottleneck(width=16), "b1")
    gb.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), "b2")
    gb.add_layer("output", L.OutputLayer(n_out=10, activation="softmax",
                                         loss="mcxent"), "avgpool")
    gb.set_outputs("output")
    return gb.build()


def test_engine_on_the_card_goes_through_the_kernels(card):
    """A bf16 graph served on the card launches each block's convs as
    kernels and agrees with the same weights on the plain path."""
    conf = _narrow_conf()
    model = ComputationGraph(conf).init()
    g = torch.Generator().manual_seed(9)
    for v in model.layer_names:
        for k, p in model.params_[v].items():
            if k.startswith("gamma"):
                lo, hi = (0.1, 0.3) if k == "gamma_c" else (0.5, 1.5)
                p.copy_(torch.rand(p.shape, generator=g) * (hi - lo) + lo)
        for k, p in model.state_[v].items():
            if k.startswith("var"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    plain_conf = copy.deepcopy(conf)
    for v in plain_conf.vertices.values():
        if isinstance(getattr(v, "layer", None), L.FusedResNetBottleneck):
            v.layer.use_pallas = False
    plain = ComputationGraph(plain_conf)
    plain.params_, plain.state_, plain.device = model.params_, model.state_, model.device

    engine = InferenceEngine(model, buckets=[4])
    x = np.random.default_rng(3).standard_normal((3, 20, 20, 3)).astype(np.float32)
    fc.reset_launch_counts()
    y = engine.infer(x)
    # 3 blocks x (a, c) + 2 projections pointwise; 3 blocks x one 3x3
    assert dict(fc.launch_counts) == {"pw_conv": 8, "conv3x3": 3}
    fc.reset_launch_counts()
    ref = plain.output_single(x)
    assert sum(fc.launch_counts.values()) == 0
    assert y.shape == (3, 10) and np.isfinite(y).all()
    assert np.abs(y - ref).max() <= 0.03
