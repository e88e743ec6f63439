"""Card-only tests of the PyTorch port: the CUDA kernels and the engine on
the card. The file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test is marked ``cuda`` and skips without a card (the kernels have no
CPU mode). Tolerances as in ``chip_smoke.py``: kernel ``y``, ``dx`` and
``dW`` within one bf16 rounding step plus the worst-case f32
summation-order difference over the product's depth K; statistics,
``dscale`` and ``dshift`` rtol 1e-4, atol 1e-3 plus 1e-5 of the sum of
their terms' magnitudes. The int8 matmul: ``|k - p| <= 2*K*2^-24*(|x|.|q|)*s``
(f32 summation order), plus for bf16 ``x`` one bf16 step of ``|p|`` for the
output and one for the scale.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc
from deeplearning4j_tpu_torch.nn.ops import int8_matmul as im
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.updaters import Nesterovs

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


def _bwd_inputs(op, x_shape, w_shape, seed):
    """Forward inputs, the forward's y as z, and seeded cotangents."""
    x, s, t, w = _inputs(x_shape, w_shape, seed)
    fwd = fc.pw_conv_plain if op == "pw" else fc.conv3x3_plain
    z, _ = fwd(x, s, t, w, True)
    g = torch.Generator().manual_seed(seed + 1)
    dz = (torch.randn(tuple(z.shape), generator=g) * 0.1).to(torch.bfloat16).cuda()
    dst = torch.stack([torch.randn(w_shape[-1], generator=g) * 0.01,
                       torch.randn(w_shape[-1], generator=g) * 0.002]).cuda()
    return x, s, t, w, z, dz, dst


def _bwd_tolerances(op, x, s, t, w, z, dz, dst, relu_in, dx_p, dw_p):
    """|dx| and |dW| bounds: 2^-7|p| + 2K*2^-24*sum|terms| (K = the depth
    of the product: Cout or 9*Cout for dx, the pixel count for dW)."""
    g = (dz.float() + dst[0] + 2.0 * z.float() * dst[1]).to(torch.bfloat16).float().abs()
    xn = fc._fold(x, s, t, relu_in).to(torch.bfloat16).float().abs()
    wa = w.float().abs()
    if op == "pw":
        k_dx, mag_dx = w.shape[1], (g @ wa.T) * s.abs()
        k_dw, mag_dw = x.shape[0], xn.T @ g
    else:
        k_dx = 9 * w.shape[3]
        mag_dx = F.conv2d(g.permute(0, 3, 1, 2), wa.flip(0, 1).permute(2, 3, 0, 1),
                          padding=1).permute(0, 2, 3, 1) * s.abs()
        k_dw = x.shape[0] * x.shape[1] * x.shape[2]
        ones, zeros = torch.ones_like(s), torch.zeros_like(t)
        mag_dw = fc.conv3x3_bwd_dw_plain(xn.to(torch.bfloat16), ones, zeros, w,
                                         torch.zeros_like(z), g, torch.zeros_like(dst),
                                         False).float().abs()
    return (2.0 ** -7 * dx_p.float().abs() + 2 * k_dx * 2.0 ** -24 * mag_dx,
            2.0 ** -7 * dw_p.float().abs() + 2 * k_dw * 2.0 ** -24 * mag_dw)


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("op,x_shape,w_shape", CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}" for c in CASES])
def test_backward_kernels_match_plain(card, op, x_shape, w_shape, relu_in):
    args = _bwd_inputs(op, x_shape, w_shape, seed=len(x_shape) * 100 + x_shape[-1])
    pre = "pw_conv" if op == "pw" else "conv3x3"
    kdx = fc.pw_conv_bwd_dx if op == "pw" else fc.conv3x3_bwd_dx
    kdw = fc.pw_conv_bwd_dw if op == "pw" else fc.conv3x3_bwd_dw
    pdx = fc.pw_conv_bwd_dx_plain if op == "pw" else fc.conv3x3_bwd_dx_plain
    pdw = fc.pw_conv_bwd_dw_plain if op == "pw" else fc.conv3x3_bwd_dw_plain
    before = dict(fc.launch_counts)
    dx, ds, dt = kdx(*args, relu_in)
    dw = kdw(*args, relu_in)
    dx_p, ds_p, dt_p = pdx(*args, relu_in)
    dw_p = pdw(*args, relu_in)
    torch.cuda.synchronize()
    for name in (f"{pre}_dx", f"{pre}_dw"):
        assert fc.launch_counts[name] == before.get(name, 0) + 1
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert dx.shape == args[0].shape and dw.shape == args[3].shape
    tol_dx, tol_dw = _bwd_tolerances(op, *args, relu_in, dx_p, dw_p)
    for got, want, tol in ((dx, dx_p, tol_dx), (dw, dw_p, tol_dw)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol).all()), float((err / tol).max())
    x = args[0].float()
    rows = x.reshape(-1, x.shape[-1]).abs().sum(0)
    for got, want in ((ds, ds_p), (dt, dt_p)):
        # the terms are du*x (or du), |du| <= |dxn|: bounded via |x| sums
        assert bool(((got - want).abs() <= 1e-3 + 1e-4 * want.abs()
                     + 1e-5 * rows * float(dx_p.float().abs().max() + 1)).all())


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(card):
    x, s, t, w, z, dz, dst = _bwd_inputs("pw", (64, 32), (32, 16), seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        fc.pw_conv_bwd_dx(x, s, t, w, z, dz.t().contiguous().t(), dst, True)
    with pytest.raises(TypeError):
        fc.pw_conv_bwd_dw(x, s, t, w, z, dz, dst.double(), True)
    with pytest.raises(ValueError, match="shape"):
        fc.pw_conv_bwd_dw(x, s, t, w, z[:, :8].contiguous(), dz, dst, True)
    with pytest.raises(ValueError):
        fc.conv3x3_bwd_dx(x, s, t, w, z, dz, dst, True)


def _narrow_conf():
    gb = (NeuralNetConfiguration.builder().seed(5).weight_init("relu")
          .updater(Nesterovs(1e-3, 0.9)).l2(1e-4)
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


def _model_and_plain():
    """The narrow bf16 graph on the card with randomized BN, and the same
    weights (shared tensors) on the plain path (use_pallas=False)."""
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
    return model, plain


def test_engine_on_the_card_goes_through_the_kernels(card):
    """A bf16 graph served on the card launches each block's convs as
    kernels and agrees with the same weights on the plain path."""
    model, plain = _model_and_plain()
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


def test_train_step_on_the_card_goes_through_the_kernels(card):
    """One train step of the narrow bf16 graph launches every fused conv's
    forward and backward kernels once (8 pointwise, 3 3x3), and its
    gradients agree with the plain path's within 5e-2 relative norm per
    tensor (the reference's probe bound)."""
    model, plain = _model_and_plain()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 20, 20, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    ds = DataSet(x, y)
    fc.reset_launch_counts()
    grads, score = model.compute_gradient_and_score(ds)
    torch.cuda.synchronize()
    assert dict(fc.launch_counts) == {"pw_conv": 8, "conv3x3": 3, "pw_conv_dx": 8,
                                      "pw_conv_dw": 8, "conv3x3_dx": 3, "conv3x3_dw": 3}
    fc.reset_launch_counts()
    ref, ref_score = plain.compute_gradient_and_score(ds)
    assert sum(fc.launch_counts.values()) == 0
    assert abs(score - ref_score) <= 5e-2 * (abs(ref_score) + 1.0)
    for v in ref:
        for k in ref[v]:
            a, b = grads[v][k].float(), ref[v][k].float()
            assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
            rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
            assert rel <= 5e-2, (v, k, rel)
    fc.reset_launch_counts()
    model.fit(ds)
    assert fc.launch_counts["conv3x3_dw"] == 3 and model.iteration == 1
    assert all(bool(torch.isfinite(p).all()) for d in model.params_.values()
               for p in d.values())


# (B, K, N): VGG16's three heads at buckets 1, 8, 32, LeNet's two heads, and
# ragged shapes (N not a multiple of 4; more rows than one block holds)
INT8_CASES = [(b, k, n) for b in (1, 8, 32)
              for k, n in ((25088, 4096), (4096, 4096), (4096, 1000))]
INT8_CASES += [(8, 2450, 500), (8, 500, 10), (3, 777, 130), (40, 300, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k,n", INT8_CASES, ids=[f"{b}x{k}x{n}" for b, k, n in INT8_CASES])
def test_int8_kernel_matches_plain(card, b, k, n, dtype):
    g = torch.Generator().manual_seed(b * 7 + k + n)
    x = torch.randn(b, k, generator=g).to(dtype).cuda()
    q, s = im.quantize_int8(torch.randn(k, n, generator=g) * math.sqrt(2.0 / k))
    q, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    before = fc.launch_counts["int8_matmul"]
    y = im.int8_matmul(x, q, s)
    assert fc.launch_counts["int8_matmul"] == before + 1
    ref = im.int8_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (b, n)
    tol = 2 * k * 2.0 ** -24 * (x.float().abs() @ q.float().abs()) * s
    if dtype == torch.bfloat16:
        tol = tol + 2 * 2.0 ** -7 * ref.float().abs()
    assert bool(((y.float() - ref.float()).abs() <= tol).all())
    # the same bits in every run, and a row's bits in every bucket
    assert torch.equal(im.int8_matmul(x, q, s), y)
    assert torch.equal(im.int8_matmul(x[:1].contiguous(), q, s), y[:1])


def test_int8_kernel_refusals(card):
    q = torch.zeros(8, 4, dtype=torch.int8, device="cuda")
    s = torch.ones(4, device="cuda")
    with pytest.raises(TypeError):
        im.int8_matmul(torch.zeros(2, 8, dtype=torch.float16, device="cuda"), q, s)
    with pytest.raises(ValueError):
        im.int8_matmul(torch.zeros(8, 2, device="cuda").t(), q, s)  # not contiguous
    with pytest.raises(ValueError):
        im.int8_matmul(torch.zeros(2, 7, device="cuda"), q, s)


def test_mln_int8_forward_launches_one_kernel_per_head(card):
    """A LeNet served with int8 heads launches exactly 2 int8 kernels per
    forward (Dense 500, Output 10); the f32 engine launches none."""
    from deeplearning4j_tpu_torch.models import LeNet

    model = LeNet(num_classes=10).init()
    x = np.random.default_rng(5).standard_normal((5, 28, 28, 1)).astype(np.float32)
    e8 = InferenceEngine(model, buckets=[8], int8_serving=True)
    e32 = InferenceEngine(model, buckets=[8])
    fc.reset_launch_counts()
    y8 = e8.infer(x)
    assert dict(fc.launch_counts) == {"int8_matmul": 2}
    fc.reset_launch_counts()
    y32 = e32.infer(x)
    assert sum(fc.launch_counts.values()) == 0
    assert y8.shape == (5, 10) and np.abs(y8.sum(1) - 1).max() < 1e-5
    assert np.abs(y8 - y32).max() < 0.05
    assert e8.describe()["int8_report"]["layers_quantized"] == 2


def test_mln_int8_forward_under_bf16_compute(card):
    """Under compute_dtype="bfloat16" the hidden head gets bf16 x and a bf16
    W_scale, the output head bf16 x and an f32 W_scale: both reach the
    kernel's bf16 instantiation, once each per forward."""
    from deeplearning4j_tpu_torch.models import LeNet

    model = LeNet(num_classes=10, compute_dtype="bfloat16").init()
    x = np.random.default_rng(6).standard_normal((5, 28, 28, 1)).astype(np.float32)
    e8 = InferenceEngine(model, buckets=[8], int8_serving=True)
    heads = [p for p in e8._snap.params if "W_q8" in p]
    assert [p["W_scale"].dtype for p in heads] == [torch.bfloat16, torch.float32]
    fc.reset_launch_counts()
    y8 = e8.infer(x)
    assert dict(fc.launch_counts) == {"int8_matmul": 2}
    y = InferenceEngine(model, buckets=[8]).infer(x)
    assert y8.dtype == np.float32 and np.abs(y8.sum(1) - 1).max() < 1e-5
    assert np.abs(y8 - y).max() < 0.05
