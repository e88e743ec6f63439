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
output and one for the scale. The LSTM cell against the plain version run in
f32 on its operands widened exactly and rounded once to the kernel's output
dtype: f32 outputs within the reference probe's 1e-5, bf16 outputs within one
bf16 step of ``|ref|`` plus 2e-5 (``_lstm_tol``); a row's bits do not depend
on its batch. The flash-attention forward against the plain version run in
f32 on its operands widened exactly: f32 ``o`` and ``lse`` within 1e-5; bf16
``o`` within ``2^-8 (P @ |v|) + 2^-8 |o_ref| + 1e-5`` per element (the
rounding of ``p`` and of ``o``, ``_flash_tol``), ``lse`` within 1e-5. The
flash backward kernels against ``chip_smoke.flash_bwd_oracle`` (phase 2f's
limits: the plain backward in f32 on the widened operands; f32 within 1e-5 of
the terms' magnitudes, bf16 one rounding of ``p``/``ds`` and one of the
output, each capped at the JAX probe's 1.6e-3 / 0.16).
"""

import copy
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc
from deeplearning4j_tpu_torch.nn.ops import int8_matmul as im
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.updaters import Nesterovs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 2f's oracle of the flash backward)

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


# ------------------------------------------------------------ fused LSTM cell
def _lstm_args(b, n_in, n, peephole, dtypes, seed):
    """Seeded cell operands at the full-width scales: x and h in (-1, 1), c
    N(0, 1), xavier-like weights, live biases and peepholes. ``dtypes``:
    (x, weights, carries)."""
    g = torch.Generator().manual_seed(seed)
    tx, tw, ts = dtypes
    x = (torch.rand(b, n_in, generator=g) * 2 - 1).to(tx)
    h = (torch.rand(b, n, generator=g) * 2 - 1).to(ts)
    c = torch.randn(b, n, generator=g).to(ts)
    std = math.sqrt(2.0 / (n_in + n))
    ws = [torch.randn(n_in, 4 * n, generator=g) * std, torch.randn(n, 4 * n, generator=g) * std,
          torch.randn(4 * n, generator=g) * 0.3]
    if peephole:
        ws += [torch.randn(n, generator=g) * 0.3 for _ in range(3)]
    return [t.cuda() for t in (x, h, c)] + [w.to(tw).cuda() for w in ws]


def _lstm_tol(ref32, out_dtype):
    """f32 outputs: 1e-5 (summation order, expf/tanhf against torch's). bf16
    outputs: kernel and oracle each round once from f32 values at most 1e-5
    apart, so they differ by one bf16 step (2^-7 |ref|) plus twice that."""
    if out_dtype == torch.bfloat16:
        return 2.0 ** -7 * ref32.abs() + 2e-5
    return torch.full_like(ref32, 1e-5)


F32, BF16 = torch.float32, torch.bfloat16
LSTM_DTYPES = {"f32": (F32, F32, F32), "bf16": (BF16, BF16, BF16), "mixed": (BF16, BF16, F32)}
LSTM_CASES = [(b, n_in, 256) for n_in in (77, 256) for b in (1, 8, 32, 64)] + [(3, 33, 100)]


@pytest.mark.parametrize("dt", sorted(LSTM_DTYPES))
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("b,n_in,n", LSTM_CASES, ids=[f"{b}x{i}x{n}" for b, i, n in LSTM_CASES])
def test_lstm_kernel_matches_plain(card, b, n_in, n, peephole, dt):
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(b, n_in, n, peephole, LSTM_DTYPES[dt], seed=b * 31 + n_in)
    before = fc.launch_counts["fused_lstm_cell"]
    with torch.inference_mode():
        hk, ck = fl.fused_lstm_cell(*args)
        hp, cp = fl.reference_lstm_cell(*args)
        # the oracle: the plain version in f32 on the widened operands
        h32, c32 = fl.reference_lstm_cell(*[a.float() for a in args])
    torch.cuda.synchronize()
    assert fc.launch_counts["fused_lstm_cell"] == before + 1
    assert hk.dtype == ck.dtype == hp.dtype == cp.dtype
    for k_, r32 in ((hk, h32), (ck, c32)):
        err = (k_.float() - r32.to(k_.dtype).float()).abs()
        assert bool((err <= _lstm_tol(r32, k_.dtype)).all()), float(err.max())
    # a row's bits do not depend on the batch it runs in
    with torch.inference_mode():
        h1, c1 = fl.fused_lstm_cell(*[a[-1:].contiguous() if i < 3 else a
                                      for i, a in enumerate(args)])
    assert torch.equal(h1, hk[-1:]) and torch.equal(c1, ck[-1:])


def test_lstm_kernel_refusals(card):
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(4, 8, 16, True, LSTM_DTYPES["f32"], seed=1)
    grad = [a.clone().requires_grad_(i == 3) for i, a in enumerate(args)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl.fused_lstm_cell(*grad)
    with torch.no_grad():
        fl.fused_lstm_cell(*grad)  # no gradient is recorded: the kernel runs
    with pytest.raises(TypeError):
        fl.fused_lstm_cell(args[0].half(), *args[1:])
    with pytest.raises(TypeError):  # h and c of two dtypes
        fl.fused_lstm_cell(args[0], args[1], args[2].bfloat16(), *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_lstm_cell(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):
        fl.fused_lstm_cell(args[0][:, :7].contiguous(), *args[1:])


def _textgen(units=32, vocab=20):
    """A narrow TextGenerationLSTM on the card with live peepholes and
    biases, and a one-hot batch."""
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM

    model = TextGenerationLSTM(num_classes=vocab, units=units).init()
    g = torch.Generator().manual_seed(3)
    for p in model.params_[:2]:
        for k in ("b", "pI", "pF", "pO"):
            p[k] = p[k] + (torch.randn(p[k].shape, generator=g) * 0.3).cuda()
    return model


def test_textgen_forward_and_generation_on_the_card(card):
    """A seq-bucketed forward launches 2 cells per padded step; a decode
    step launches 2; a slot among others decodes as it does alone."""
    from deeplearning4j_tpu_torch.serving import BucketPolicy
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine

    model = _textgen()
    eng = InferenceEngine(model, buckets=BucketPolicy(batch_buckets=[4], seq_buckets=[8, 16]))
    x = np.eye(20, dtype=np.float32)[np.random.default_rng(2).integers(0, 20, (3, 11))]
    fc.reset_launch_counts()
    y = eng.infer(x)
    assert dict(fc.launch_counts) == {"fused_lstm_cell": 2 * 16}
    assert y.shape == (3, 11, 20) and np.abs(y.sum(-1) - 1).max() < 1e-5
    gen = GenerationEngine(model, n_slots=4, max_length=64, prefill_buckets=[8, 16])
    solo = GenerationEngine(model, n_slots=1, max_length=64, prefill_buckets=[8, 16])
    try:
        prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [0], [7, 7]]
        fc.reset_launch_counts()
        reqs = [gen.submit(p, max_new=10, temperature=0.9, top_k=8, seed=i)
                for i, p in enumerate(prompts)]
        outs = [r.result(120) for r in reqs]
        steps = gen.metrics.snapshot()["decode_steps"]
        prefill = sum(2 * (8 if len(p) <= 8 else 16) for p in prompts)
        assert fc.launch_counts["fused_lstm_cell"] == 2 * steps + prefill
        for i, (p, o) in enumerate(zip(prompts, outs)):
            alone = solo.submit(p, max_new=10, temperature=0.9, top_k=8, seed=i).result(120)
            assert np.array_equal(o, alone)
    finally:
        gen.shutdown()
        solo.shutdown()


# ------------------------------------------------------------ flash attention
def _qkv(b, h, T, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, T, hd, generator=g).to(dtype).cuda() for _ in range(3)]


def _flash_tol(q, k, v, causal, scale, seg):
    """Per-element limit of |o_kernel - o_ref| (o_ref: the plain version in
    f32 on the widened operands): f32 1e-5; bf16 one rounding of p (2^-9 of
    P @ |v|) and one of o (2^-9 |o|), each allowed twice, plus 1e-5."""
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_plain(q32, k32, v32, causal, scale, seg)
    if q.dtype == torch.float32:
        return o_ref, lse_ref, torch.full_like(o_ref, 1e-5)
    p_ref = torch.softmax(fa.masked_scores(q32, k32, causal, scale, seg), -1)
    tol = 2.0 ** -8 * (p_ref @ v32.abs()) + 2.0 ** -8 * o_ref.abs() + 1e-5
    return o_ref, lse_ref, tol


FLASH_CASES = [  # (b, h, T, hd, causal, dtype, segmented)
    (1, 12, 128, 64, True, torch.bfloat16, False),
    (1, 12, 256, 64, True, torch.bfloat16, False),
    (1, 12, 1024, 64, True, torch.bfloat16, False),
    (2, 12, 1024, 64, True, torch.bfloat16, False),
    (2, 4, 256, 64, False, torch.bfloat16, False),
    (2, 4, 384, 64, True, torch.bfloat16, True),
    (1, 3, 256, 32, True, torch.bfloat16, False),
    (1, 3, 256, 40, False, torch.bfloat16, True),
    (1, 2, 128, 128, True, torch.bfloat16, False),
    (1, 3, 256, 64, True, torch.float32, False),
    (2, 2, 128, 40, False, torch.float32, True),
]


@pytest.mark.parametrize("b,h,T,hd,causal,dtype,segmented", FLASH_CASES)
def test_flash_kernel_matches_plain(card, b, h, T, hd, causal, dtype, segmented):
    q, k, v = _qkv(b, h, T, hd, dtype, seed=T + hd)
    seg = None
    if segmented:  # three packed sequences, cuts off the 64-row tiles
        seg = torch.zeros(b, T, dtype=torch.int32)
        seg[:, T // 3:] = 1
        seg[:, T // 3 + 77:] = 2
        seg = seg.cuda()
    scale = hd ** -0.5
    fa.reset_launch_counts()
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, seg)
    torch.cuda.synchronize()
    assert dict(fa.launch_counts) == {"flash_attention_fwd": 1}
    o_ref, lse_ref, tol = _flash_tol(q, k, v, causal, scale, seg)
    assert o.dtype == dtype and o.shape == (b, h, T, hd) and lse.shape == (b * h, T)
    err = (o.float() - o_ref).abs()
    assert bool((err <= tol).all()), f"max err/tol {float((err / tol).max())}"
    assert float((lse - lse_ref).abs().max()) <= 1e-5
    if causal:  # the limit would catch a lost mask
        o_nc = fa.flash_attention_plain(q.float(), k.float(), v.float(), False, scale, seg)[0]
        assert float(((o_nc - o_ref).abs() / tol).max()) > 10


def test_flash_kernel_takes_strided_heads_and_runs_bit_identical(card):
    """q, k, v as the model makes them (a transpose of (b, T, h, hd)); rows
    do not depend on the batch or the run."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 256, 3, 12, 64, generator=g).bfloat16().cuda()
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
        o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                          True, 0.125)
        o1, _ = fa.flash_attention_fwd(q[1:], k[1:], v[1:], True, 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o[1:], o1)
    # o is a (b, h, T, hd) view of (b, T, h, hd): merging heads is free
    assert o.transpose(1, 2).is_contiguous()


def test_flash_kernel_refusals(card):
    q, k, v = _qkv(1, 2, 128, 64, torch.bfloat16, seed=1)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half(), True, 0.125)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k.float(), v, True, 0.125)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q[:, :, :100], k[:, :, :100], v[:, :, :100], True, 0.125)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k[:, :, :64], v, True, 0.125)
    with pytest.raises(ValueError, match="unit-stride"):
        fa.flash_attention_fwd(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3),
                               True, 0.125)
    big = torch.zeros(1, 1, 128, 129, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(big, big, big, True, 0.1)
    with pytest.raises(ValueError, match="segment"):
        fa.flash_attention_fwd(q, k, v, True, 0.125,
                               torch.zeros(1, 128, dtype=torch.int64, device="cuda"))
    # a call that records a gradient runs the kernel and carries one
    qg = q.detach().requires_grad_()
    fa.reset_launch_counts()
    o, _ = fa.flash_attention_fwd(qg, k, v, True, 0.125)
    assert o.grad_fn is not None and dict(fa.launch_counts) == {"flash_attention_fwd": 1}


def test_transformer_forward_prefill_and_decode_on_the_card(card):
    """A narrow bf16 TransformerLM: a forward at T 256 launches one flash
    kernel per layer, a prefill at a bucket >= 128 too, below 128 none, a
    decode step none; the kernel route agrees with plain attention; the
    engine's greedy tokens equal generate_cached's where decided."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine

    model = tlm.TransformerLM(vocab_size=128, d_model=64, n_heads=2, n_layers=3,
                              max_length=512, compute_dtype="bfloat16").init()
    with torch.no_grad():
        model.params_["head"].mul_(4.0)
    cfg, params = model.cfg, model.compute_params()
    ids = torch.randint(0, 128, (2, 256), generator=torch.Generator().manual_seed(1)).cuda()

    def plain(q, k, v, *, causal, mask=None):
        return fa.flash_attention_plain(q, k, v, causal, q.shape[-1] ** -0.5)[0]

    with torch.inference_mode():
        fa.reset_launch_counts()
        y = tlm.forward(cfg, params, ids)
        assert dict(fa.launch_counts) == {"flash_attention_fwd": 3}
        yp = tlm.forward(cfg, params, ids, attn_fn=plain)
        d = float((y - yp).abs().max())
        gap = torch.topk(yp, 2, -1).values
        decided = gap[..., 0] - gap[..., 1] > 2 * d
        assert bool((y.argmax(-1) == yp.argmax(-1))[decided].all()) and d < 0.5
        for length, want in ((100, 3), (129, 3), (40, 0)):
            tb = next(t for t in model.prefill_buckets() if t >= length)
            padded = torch.zeros(1, tb, dtype=torch.long, device="cuda")
            padded[0, :length] = ids[0, :length]
            fa.reset_launch_counts()
            lg, cache = tlm.prefill_cache(cfg, params, tlm.init_decode_cache(cfg, 1, device="cuda"),
                                          padded, length=length)
            assert fa.launch_counts[fa.OP] == want
            assert float((lg[0] - y[0, length - 1]).abs().max()) <= 2 * d + 0.05
        fa.reset_launch_counts()
        tlm.decode_step(cfg, params, cache, ids[0, 40:41])
        assert fa.launch_counts[fa.OP] == 0
    gen = GenerationEngine(model, n_slots=4)
    try:
        prompts = [ids[0, :n].cpu().numpy() for n in (5, 130, 300)]
        outs = [r.result(120) for r in [gen.submit(p, max_new=8) for p in prompts]]
    finally:
        gen.shutdown()
    for p, o in zip(prompts, outs):
        assert o.shape == (len(p) + 8,) and o.min() >= 0 and o.max() < 128


# --------------------------------------------------- flash attention backward
FLASH_BWD_CASES = [  # (b, h, T, hd, causal, dtype, segmented)
    (2, 4, 256, 64, True, torch.bfloat16, False),
    (1, 12, 512, 64, True, torch.bfloat16, False),
    (2, 4, 256, 64, False, torch.bfloat16, False),
    (2, 4, 384, 64, True, torch.bfloat16, True),
    (1, 3, 256, 32, True, torch.bfloat16, False),
    (1, 3, 256, 40, False, torch.bfloat16, True),
    (1, 2, 128, 128, True, torch.bfloat16, False),
    (1, 3, 256, 64, True, torch.float32, False),
    (2, 2, 128, 40, False, torch.float32, True),
    (1, 2, 128, 128, True, torch.float32, True),
]


def _bwd_case(b, h, T, hd, causal, dtype, segmented, seed):
    q, k, v = _qkv(b, h, T, hd, dtype, seed)
    do = _qkv(b, h, T, hd, dtype, seed + 1)[0]
    seg = None
    if segmented:  # three packed sequences, cuts off the 64-row tiles
        seg = torch.zeros(b, T, dtype=torch.int32)
        seg[:, T // 3:] = 1
        seg[:, T // 3 + 77:] = 2
        seg = seg.cuda()
    scale = hd ** -0.5
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, seg)
    return q, k, v, o, lse, do, scale, seg


@pytest.mark.parametrize("b,h,T,hd,causal,dtype,segmented", FLASH_BWD_CASES)
def test_flash_backward_kernels_match_plain(card, b, h, T, hd, causal, dtype, segmented):
    q, k, v, o, lse, do, scale, seg = _bwd_case(b, h, T, hd, causal, dtype, segmented, T + hd)
    fa.reset_launch_counts()
    with torch.inference_mode():
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale, seg)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale, seg)
    torch.cuda.synchronize()
    assert dict(fa.launch_counts) == {"flash_attention_dq": 2, "flash_attention_dkv": 2}
    ref, tols = chip_smoke.flash_bwd_oracle(fa, q, k, v, o, lse, do, causal, scale, seg)
    if causal:  # the limits would catch a lost mask
        lost = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse,
                                            do.float(), False, scale, seg)
    for name, g, g2, r, tol, i in zip(("dq", "dk", "dv"), got, again, ref, tols, range(3)):
        assert g.dtype == dtype and g.shape == (b, h, T, hd), name
        assert g.transpose(1, 2).is_contiguous(), name       # a view of (b, T, h, hd)
        assert torch.equal(g, g2), f"{name}: two runs differ"
        err = (g.float() - r).abs()
        assert bool((err <= tol).all()), f"{name}: max err/tol {float((err / tol).max())}"
        if causal:
            assert float(((lost[i] - r).abs() / tol).max()) > 10, name


def test_flash_backward_takes_strided_and_expanded_gradients(card):
    """dO as autograd hands it over: a (b, h, T, hd) view of (b, T, h, hd), or
    expanded (stride 0); the kernels give what they give on dO contiguous."""
    q, k, v, o, lse, _, scale, _ = _bwd_case(2, 3, 256, 64, True, torch.bfloat16, False, 7)
    g = torch.Generator().manual_seed(9)
    do_view = torch.randn(2, 256, 3, 64, generator=g).bfloat16().cuda().transpose(1, 2)
    do_exp = torch.full((1, 1, 1, 1), 0.5, dtype=torch.bfloat16, device="cuda").expand(
        2, 3, 256, 64)
    with torch.inference_mode():
        for do in (do_view, do_exp):
            a = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
            b_ = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), True, scale)
            assert all(torch.equal(x, y) for x, y in zip(a, b_))


def test_flash_backward_refusals(card):
    q, k, v, o, lse, do, scale, _ = _bwd_case(1, 2, 128, 64, True, torch.bfloat16, False, 3)
    bwd = fa.flash_attention_bwd
    with pytest.raises(TypeError, match="ROADMAP"):
        bwd(q.half(), k.half(), v.half(), o.half(), lse, do.half(), True, scale)
    with pytest.raises(TypeError):
        bwd(q, k, v, o, lse, do.float(), True, scale)
    with pytest.raises(ValueError, match="ROADMAP"):
        bwd(*(t[:, :, :96] for t in (q, k, v, o)), lse[:, :96].contiguous(), do[:, :, :96],
            True, scale)
    big = torch.zeros(1, 1, 128, 160, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="ROADMAP"):
        bwd(big, big, big, big, torch.zeros(1, 128, device="cuda"), big, True, 0.1)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, o, lse[:1], do, True, scale)
    with pytest.raises(ValueError, match="segment"):
        bwd(q, k, v, o, lse, do, True, scale, torch.zeros(1, 128, dtype=torch.int64,
                                                           device="cuda"))


def test_flash_attention_gradients_through_the_function(card):
    """``flash_attention`` records a gradient on the card: its backward runs
    the two kernels once each and gives what ``flash_attention_bwd`` gives."""
    q, k, v, o, lse, do, scale, seg = _bwd_case(1, 2, 256, 64, True, torch.bfloat16, True, 11)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    fa.reset_launch_counts()
    out = fa.flash_attention(qr, kr, vr, causal=True, sm_scale=scale, segment_ids=seg)
    grads = torch.autograd.grad(out, (qr, kr, vr), do)
    assert dict(fa.launch_counts) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                                      "flash_attention_dkv": 1}
    with torch.inference_mode():
        want = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale, seg)
    assert torch.equal(out.detach(), o)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_transformer_fit_batch_on_the_card(card):
    """A narrow bf16 TransformerLM: each fit_batch at T 256 launches exactly
    one flash forward, one dq and one dkv kernel per layer; the loss falls;
    logits afterwards follow the trained params."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm

    model = tlm.TransformerLM(vocab_size=128, d_model=64, n_heads=2, n_layers=3,
                              max_length=256, compute_dtype="bfloat16").init()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 128, (2, 256))
    tgt = np.roll(ids, -1, axis=1)
    tgt[:, -1] = -1
    before = model.logits(ids[:1])
    losses = []
    for _ in range(5):
        fa.reset_launch_counts()
        losses.append(model.fit_batch(ids, tgt))
        assert dict(fa.launch_counts) == {"flash_attention_fwd": 3, "flash_attention_dq": 3,
                                          "flash_attention_dkv": 3}
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    after = model.logits(ids[:1])
    with torch.inference_mode():
        fresh = tlm.forward(model.cfg, tlm.compute_params(model.cfg, model.params_),
                            torch.from_numpy(ids[:1]).cuda()).cpu().numpy()
    assert np.array_equal(after, fresh) and not np.array_equal(after, before)


# ---------------------------------------------------------------- fused Adam
ADAM_SIZES = [1, 3, 4095, 4097, 1_000_003]


def _adam_inputs(card, n, seed):
    g = torch.Generator().manual_seed(seed)
    p, grad, m = (torch.randn(n, generator=g).to(card) for _ in range(3))
    v = torch.randn(n, generator=g).abs().to(card) * 0.01
    return p, grad, m * 0.1, v


@pytest.mark.parametrize("t", [1, 2, 1000])
@pytest.mark.parametrize("n", ADAM_SIZES)
def test_fused_adam_kernel_is_the_plain_version_bit_for_bit(card, n, t):
    """p', m' and v' torch.equal to the plain version and to the eager
    ``Adam.apply`` on the card; one launch; a rerun gives the same bits;
    the inputs are not changed."""
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
    from deeplearning4j_tpu_torch.nn.ops import launch as ops_launch
    from deeplearning4j_tpu_torch.updaters import Adam

    upd = Adam(1e-3)
    p, grad, m, v = _adam_inputs(card, n, seed=n + t)
    copies = [a.clone() for a in (p, grad, m, v)]
    alpha = upd.alpha(t, t - 1, 0)
    ops_launch.reset_launch_counts()
    got = fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
    assert dict(ops_launch.launch_counts) == {"fused_adam": 1}
    plain = fu.fused_adam_plain(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
    delta, st = upd.apply(grad, {"m": m, "v": v}, t, t - 1, 0)
    again = fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
    for a, b, c, d in zip(got, plain, (p - delta, st["m"], st["v"]), again):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert all(torch.equal(a, b) for a, b in zip((p, grad, m, v), copies))


def test_fused_adam_kernel_unaligned_and_padded(card):
    """Views 4 bytes off a 16-byte boundary take the scalar path, same bits;
    zero padding lanes of a (4, chunk) group stay zero."""
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
    from deeplearning4j_tpu_torch.updaters import Adam

    upd = Adam(1e-2)
    alpha = upd.alpha(3, 2, 0)
    base = _adam_inputs(card, 40_001, seed=9)
    views = [a[1:] for a in base]
    assert views[0].data_ptr() % 16
    got = fu.fused_adam_apply(*views, alpha, b1=0.9, b2=0.999, eps=1e-8)
    want = fu.fused_adam_plain(*views, alpha, b1=0.9, b2=0.999, eps=1e-8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    padded = []
    for a in _adam_inputs(card, 66, seed=4):
        padded.append(torch.cat([a, a.new_zeros(2)]).view(4, 17))
    for a in fu.fused_adam_apply(*padded, alpha, b1=0.9, b2=0.999, eps=1e-8):
        assert torch.equal(a.reshape(-1)[66:], torch.zeros(2, device=card))


def test_fused_adam_kernel_refusals(card):
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu

    p, grad, m, v = _adam_inputs(card, 64, seed=1)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    with pytest.raises(TypeError, match="float32"):
        fu.fused_adam_apply(p.half(), grad, m, v, 1e-3, **kw)
    with pytest.raises(ValueError, match="shape"):
        fu.fused_adam_apply(p, grad[:32], m, v, 1e-3, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_adam_apply(p.view(8, 8).t(), grad.view(8, 8), m.view(8, 8), v.view(8, 8),
                            1e-3, **kw)
    with pytest.raises(ValueError, match="cpu"):
        fu.fused_adam_apply(p, grad.cpu(), m, v, 1e-3, **kw)


def test_wrapper_on_the_card_sharded_equals_replicated(card):
    """A narrow Adam MLN through ParallelWrapper on a one-rank NCCL group:
    the sharded run launches the fused Adam once per f32 Adam group and
    step, and gives the replicated run's params and slots bit for bit."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.ops import launch as ops_launch
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2)).list()
            .layer(L.DenseLayer(n_out=64, activation="tanh"))
            .layer(L.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.feed_forward(32)).build())
    rng = np.random.default_rng(0)
    ds = DataSet(rng.standard_normal((16, 32)).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)])
    nets = []
    for sharded in (False, True):
        net = MultiLayerNetwork(conf).init()
        ops_launch.reset_launch_counts()
        pw = ParallelWrapper.builder(net).workers(1).sharded_update(sharded).build()
        pw.fit(ExistingDataSetIterator([ds]), epochs=3)
        assert ops_launch.launch_counts.get("fused_adam", 0) == (3 if sharded else 0)
        nets.append(net)
    assert np.array_equal(nets[0].params_flat(), nets[1].params_flat())
    assert np.array_equal(nets[0].opt_state_flat(), nets[1].opt_state_flat())
