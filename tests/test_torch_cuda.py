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
output and one for the scale; for f32 ``x`` also max ``|k - y64|`` <= 4 max
``|p - y64|`` + 2^-24 max ``|y64|`` against the f64 product. The LSTM cell
against the plain version run in f32 on its operands widened exactly and
rounded once to the kernel's output dtype: f32 outputs within the reference probe's 1e-5, bf16 outputs within one
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
import subprocess
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

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (phase 2f's oracle of the flash backward, phase 2d's row check)

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


def _assert_fwd_matches_plain(op, x, s, t, w, relu_in):
    """The kernel's y and stats against the plain version (the tolerances
    of test_kernel_matches_plain); returns the kernel's (y, stats)."""
    kern, plain = ((fc.pw_conv, fc.pw_conv_plain) if op == "pw"
                   else (fc.conv3x3, fc.conv3x3_plain))
    y, st = kern(x, s, t, w, relu_in)
    y_ref, st_ref = plain(x, s, t, w, relu_in)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs()
    tol = _y_tolerance(op, x, s, t, w, relu_in, y_ref.float())
    assert bool((err <= tol).all()), float((err / tol).max())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-3)
    return y, st


@pytest.mark.parametrize("shape", [(2, 56, 56, 64), (3, 7, 7, 512), (1, 13, 10, 64)],
                         ids=["56x56", "7x7-batch3", "130-rows"])
def test_fwd_kernel_halo_is_zero_after_the_fold(card, shape):
    """x = 0, relu(shift) = 0.5 and w = 1: each output is 0.5 * Cin times
    the number of its taps inside its image, exactly (the closed form of
    test_torch_fused_conv.py::test_halo_is_zero_after_the_fold). TMA's zero
    fill folds to relu(shift), not 0; at 7x7 a block of 128 rows holds the
    end of one image and the start of the next, and at 13x10 the last block's
    shifted boxes lie wholly past M: only the position decides the halo.
    Reruns give the same bits."""
    n, h, wd, cin = shape
    x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    s = torch.rand(cin, device="cuda") + 0.5
    t = torch.full((cin,), 0.5, device="cuda")
    w = torch.ones((3, 3, cin, cin), dtype=torch.bfloat16, device="cuda")
    y, st = _assert_fwd_matches_plain("c3", x, s, t, w, True)
    inside = lambda size: torch.tensor([2.0] + [3.0] * (size - 2) + [2.0])  # noqa: E731
    want = (inside(h)[:, None] * inside(wd)[None, :] * 0.5 * cin).cuda()
    assert torch.equal(y.float(), want[None, :, :, None].expand(n, h, wd, cin))
    y2, st2 = fc.conv3x3(x, s, t, w, True)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("op,x_shape,cout", [("pw", (49, 1024), 512), ("c3", (1, 7, 7, 512), 512),
                                             ("pw", (200, 96), 160)],
                         ids=["pw-49", "c3-49", "pw-200"])
def test_fwd_kernel_masks_rows_past_m(card, op, x_shape, cout):
    """x = 0 and relu(shift) > 0 fold to a nonzero row everywhere: the rows
    of the last 128-row block past M (TMA zero-filled) would fold to it too.
    The kernel's y and stats are within the limit, and statistics that took
    those rows in (at the positions of the next image's pixels, for the 3x3)
    land more than 10x over it."""
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw" else (3, 3, cin, cout)
    x, s, t, w = _inputs(x_shape, w_shape, seed=cin + cout)
    x, t = torch.zeros_like(x), t.abs() + 0.1
    _, st = _assert_fwd_matches_plain(op, x, s, t, w, True)
    m = x.numel() // cin
    rows = -(-m // 128) * 128
    if op == "pw":
        _, st_lost = fc.pw_conv_plain(x.new_zeros((rows, cin)), s, t, w, True)
    else:
        images = x.new_zeros((-(-rows // m), *x_shape[1:]))
        y_lost = fc.conv3x3_plain(images, s, t, w, True)[0].float().reshape(-1, cout)[:rows]
        st_lost = torch.stack([y_lost.sum(0), (y_lost * y_lost).sum(0)])
    tol = 1e-3 + 1e-4 * st.abs()
    assert float(((st_lost - st).abs() / tol).max()) > 10


@pytest.mark.parametrize("op,x_shape,cout", [("c3", (2, 9, 5, 40), 70), ("pw", (300, 40), 70),
                                             ("c3", (2, 9, 5, 36), 70)],
                         ids=["c3-40", "pw-40", "c3-36"])
def test_fwd_kernel_channels_past_cin_give_zero(card, op, x_shape, cout):
    """A 64-channel stage past Cin: the shared scale and shift entries past
    Cin are stale. A launch of the same instantiation (the same M and Cout)
    with NaN in those entries leaves them NaN in shared memory; the next
    launch must still give 0 in A for those channels (a NaN times W's
    zero-filled rows would be NaN)."""
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw" else (3, 3, cin, cout)
    x, s, t, w = _inputs(x_shape, w_shape, seed=7 * cin + cout)
    kern = fc.pw_conv if op == "pw" else fc.conv3x3
    poison_shape = (*x_shape[:-1], 64)
    px = torch.ones(poison_shape, dtype=torch.bfloat16, device="cuda")
    ps = torch.full((64,), float("nan"), device="cuda")
    pw = torch.ones((*w_shape[:-2], 64, cout), dtype=torch.bfloat16, device="cuda")
    for _ in range(3):
        kern(px, ps, ps, pw, True)
        y, st = _assert_fwd_matches_plain(op, x, s, t, w, True)
        assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(st).all())


@pytest.mark.parametrize("op,x_shape,cout", [("pw", (300, 64), 128), ("c3", (2, 14, 14, 256), 256)],
                         ids=["pw", "c3"])
def test_fwd_kernel_reads_misaligned_views_through_the_padded_copy(card, op, x_shape, cout):
    """x, scale, shift and w at bases off 16 bytes go through the padded
    layout copy: the same kernel, the same bits as on aligned tensors."""
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw" else (3, 3, cin, cout)
    args = _inputs(x_shape, w_shape, seed=cin * 3 + cout)

    def off(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        v = buf[1:].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    kern = fc.pw_conv if op == "pw" else fc.conv3x3
    name = "pw_conv" if op == "pw" else "conv3x3"
    fc.reset_launch_counts()
    a = kern(*args, True)
    b_ = kern(*(off(v) for v in args), True)
    torch.cuda.synchronize()
    assert dict(fc.launch_counts) == {name: 2}
    assert all(torch.equal(p, q) for p, q in zip(a, b_))


@pytest.mark.parametrize("op,x_shape,cout", [("pw", (37, 1), 1), ("c3", (2, 3, 5, 1), 1),
                                             ("pw", (130, 3), 1000), ("c3", (1, 4, 70, 20), 9)],
                         ids=["pw-1-1", "c3-1-1", "pw-3-1000", "c3-wide-70"])
def test_fwd_kernel_takes_any_channel_count(card, op, x_shape, cout):
    """One input or output channel, a Cout over four 256-column tiles, and a
    3x3 image 70 pixels wide (its taps' boxes start 71 rows before the
    tile): the shapes the WMMA kernel took, against the plain version."""
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw" else (3, 3, cin, cout)
    x, s, t, w = _inputs(x_shape, w_shape, seed=11 * cin + cout)
    name = "pw_conv" if op == "pw" else "conv3x3"
    fc.reset_launch_counts()
    for relu_in in (False, True):
        y, _ = _assert_fwd_matches_plain(op, x, s, t, w, relu_in)
        assert y.shape == (*x_shape[:-1], cout) and y.is_contiguous()
    assert dict(fc.launch_counts) == {name: 2}


_FWD_OPT_IN_RUN = """
import torch
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

# (op, x shape, Cout): the column tile N is 64, 128 or 256 by Cout (at least
# one block per SM at these row counts)
SHAPES = {64: ("pw", (20000, 64), 64), 128: ("c3", (8, 56, 56, 64), 128),
          256: ("pw", (20000, 128), 256), "c3-64": ("c3", (4, 56, 56, 64), 64)}

def run(order):
    out = {}
    for key in order:
        op, xs, cout = SHAPES[key]
        cin = xs[-1]
        g = torch.Generator().manual_seed(cin + cout)
        x = torch.randn(xs, generator=g).bfloat16().cuda()
        s = (torch.randn(cin, generator=g) * 0.2 + 1).cuda()
        t = (torch.randn(cin, generator=g) * 0.1).cuda()
        ws = (cin, cout) if op == "pw" else (3, 3, cin, cout)
        w = (torch.randn(ws, generator=g) * 0.05).bfloat16().cuda()
        kern = fc.pw_conv if op == "pw" else fc.conv3x3
        out[key] = [a.cpu() for a in kern(x, s, t, w, True)]
    return out
"""


@pytest.mark.parametrize("order", [("c3-64", 128, 256, 64), (256, 128, 64, "c3-64")],
                         ids=["3x3-and-64-first", "pointwise-and-256-first"])
def test_fwd_kernel_opts_in_per_instantiation_in_any_order(card, tmp_path, order):
    """The forward kernel's N-64, N-128 and N-256 instantiations share a
    function type; each asks for its own shared memory above 48 KB, whichever
    runs first in a fresh process (3x3 or pointwise, the widest or the
    narrowest first). The fresh process's results equal this one's bit for
    bit."""
    path = tmp_path / "out.pt"
    script = _FWD_OPT_IN_RUN + f"torch.save(run({order!r}), {str(path)!r})\n"
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=600)
    got = torch.load(path)
    ns = {}
    exec(_FWD_OPT_IN_RUN, ns)
    want = ns["run"](order)
    for key in order:
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key])), key


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


# (Cin, Cout, H=W) of ResNet-50's fifteen pointwise convs at batch 32, and
# ragged cases: M off the 128-row block, Cout off TMA's 16-byte row, batch 1
PW_DX_CASES = ([(32 * hw * hw, ci, co) for ci, co, hw, _ in chip_smoke.PW_CASES]
               + [(49, 2048, 512), (507, 36, 70), (200, 96, 160), (1000, 256, 64),
                  (130, 64, 8)])


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("m,cin,cout", PW_DX_CASES,
                         ids=[f"{m}x{ci}-{co}" for m, ci, co in PW_DX_CASES])
def test_pw_dx_kernel_matches_plain(card, m, cin, cout, relu_in):
    """The Hopper pointwise dx kernel (dx, dscale, dshift) against its plain
    version at ResNet-50's shapes and ragged ones, a nonzero dstats; a rerun
    gives the same bits."""
    args = _bwd_inputs("pw", (m, cin), (cin, cout), seed=m + cin + cout)
    fc.reset_launch_counts()
    dx, ds, dt = fc.pw_conv_bwd_dx(*args, relu_in)
    dx2, ds2, dt2 = fc.pw_conv_bwd_dx(*args, relu_in)
    dx_p, ds_p, dt_p = fc.pw_conv_bwd_dx_plain(*args, relu_in)
    torch.cuda.synchronize()
    assert dict(fc.launch_counts) == {"pw_conv_dx": 2}
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2) and torch.equal(dt, dt2)
    tol_dx, _ = _bwd_tolerances("pw", *args, relu_in, dx_p, torch.zeros_like(args[3]))
    err = (dx.float() - dx_p.float()).abs()
    assert bool((err <= tol_dx).all()), float((err / tol_dx).max())
    rows = args[0].float().abs().sum(0)
    for got, want in ((ds, ds_p), (dt, dt_p)):
        tol = 1e-3 + 1e-4 * want.abs() + 1e-5 * rows * float(dx_p.float().abs().max() + 1)
        assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("relu_in", [False, True])
def test_pw_dx_kernel_masks_rows_past_m(card, relu_in):
    """M = 200 leaves 56 rows of the last 128-row block past M, which TMA
    fills with dz = z = 0. Without the kernel's row mask they would carry
    dz_eff = dst[0] into dshift (and dscale): that difference is over the
    limit, and the kernel is within it."""
    x, s, t, w, z, dz, dst = _bwd_inputs("pw", (200, 96), (96, 160), seed=41)
    dst = dst * 50.0
    t = t.abs() + 0.1     # u = shift > 0 on a zero row: the ReLU keeps its du
    args = (x, s, t, w, z, dz, dst)
    _, ds, dt = fc.pw_conv_bwd_dx(*args, relu_in)
    _, ds_p, dt_p = fc.pw_conv_bwd_dx_plain(*args, relu_in)
    pad = lambda a: torch.cat([a, a.new_zeros((56, a.shape[1]))])  # noqa: E731
    _, _, dt_lost = fc.pw_conv_bwd_dx_plain(pad(x), s, t, w, pad(z), pad(dz), dst, relu_in)
    dx_p = fc.pw_conv_bwd_dx_plain(*args, relu_in)[0]
    tol = (1e-3 + 1e-4 * dt_p.abs()
           + 1e-5 * x.float().abs().sum(0) * float(dx_p.float().abs().max() + 1))
    assert bool(((dt - dt_p).abs() <= tol).all())
    assert bool(((ds - ds_p).abs() <= 1e-3 + 1e-4 * ds_p.abs()
                 + 1e-5 * x.float().abs().sum(0) * float(dx_p.float().abs().max() + 1)).all())
    assert float(((dt_lost - dt_p).abs() / tol).max()) > 10


def test_pw_dx_kernel_reads_misaligned_views_through_the_padded_copy(card):
    """dz, z and w that TMA cannot read as they are (a base off 16 bytes)
    go through the padded layout copy: the same kernel, the same bits as on
    aligned copies."""
    x, s, t, w, z, dz, dst = _bwd_inputs("pw", (300, 64), (64, 128), seed=43)
    dz_off = torch.empty(300 * 128 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(300, 128)
    dz_off.copy_(dz)
    assert dz_off.data_ptr() % 16 and dz_off.is_contiguous()
    fc.reset_launch_counts()
    a = fc.pw_conv_bwd_dx(x, s, t, w, z, dz_off, dst, True)
    b_ = fc.pw_conv_bwd_dx(x, s, t, w, z, dz, dst, True)
    assert dict(fc.launch_counts) == {"pw_conv_dx": 2}
    assert all(torch.equal(p, q) for p, q in zip(a, b_))


def _dw_tolerance(args, relu_in, dw_p):
    """|dW| bound: 2^-7|p| + 2M*2^-24*(|xn|^T |dz_eff|) (M pixels of depth)."""
    return _bwd_tolerances("pw", *args, relu_in, torch.zeros_like(args[0]), dw_p)[1]


def _assert_dw_matches_plain(args, relu_in):
    """The kernel's dW against the plain version, twice: the same bits on
    the rerun, within the limit, finite; returns the kernel's dW."""
    dw = fc.pw_conv_bwd_dw(*args, relu_in)
    again = fc.pw_conv_bwd_dw(*args, relu_in)
    dw_p = fc.pw_conv_bwd_dw_plain(*args, relu_in)
    torch.cuda.synchronize()
    assert dw.dtype == torch.bfloat16 and dw.shape == args[3].shape
    assert torch.equal(dw, again)
    assert bool(torch.isfinite(dw.float()).all())
    err = (dw.float() - dw_p.float()).abs()
    tol = _dw_tolerance(args, relu_in, dw_p)
    assert bool((err <= tol).all()), float((err / tol).max())
    return dw


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("m,cin,cout", PW_DX_CASES,
                         ids=[f"{m}x{ci}-{co}" for m, ci, co in PW_DX_CASES])
def test_pw_dw_kernel_matches_plain(card, m, cin, cout, relu_in):
    """The Hopper pointwise dW kernel against its plain version at
    ResNet-50's fifteen pointwise shapes at batch 32 (many pixel chunks
    each) and ragged ones (batch 1 at 7x7, M off the 32-pixel stage, Cin
    and Cout off the 64-channel panel and the 16-byte row), a nonzero
    dstats; a rerun gives the same bits; one launch a call."""
    args = _bwd_inputs("pw", (m, cin), (cin, cout), seed=m + cin + cout + 5)
    fc.reset_launch_counts()
    _assert_dw_matches_plain(args, relu_in)
    assert dict(fc.launch_counts) == {"pw_conv_dw": 2}


@pytest.mark.parametrize("relu_in", [False, True])
def test_pw_dw_kernel_masks_rows_past_m(card, relu_in):
    """M = 5000 at 256 -> 512 is neither a whole number of 32-pixel stages
    nor of chunks (the last chunk holds 40 pixels): the rows of its last
    stage past M are TMA's zero fill, dz = z = 0, whose dz_eff would be
    dst[0] = 4 and whose fold is relu(shift) > 0. On the valid rows dz
    cancels dst[0] up to noise, so those 24 rows would stand out: the
    kernel is within the limit, and a dW that took them in lands more than
    10x over it."""
    m, cin, cout = 5000, 256, 512
    _, chunk, splits = fc.pw_dw_tiles(m, cin, cout, torch.cuda.get_device_properties(0)
                                      .multi_processor_count)
    assert m % 32 and m % chunk and splits > 1
    x, s, t, w, z, dz, dst = _bwd_inputs("pw", (m, cin), (cin, cout), seed=47)
    dst = torch.stack([dst[0] + 4.0, dst[1]])
    dz = (dz.float() - 4.0).bfloat16()
    t = t.abs() + 0.1
    args = (x, s, t, w, z, dz, dst)
    dw = _assert_dw_matches_plain(args, relu_in)
    pad = -(-m // 32) * 32 - m
    rows = lambda a: torch.cat([a, a.new_zeros((pad, a.shape[1]))])  # noqa: E731
    dw_lost = fc.pw_conv_bwd_dw_plain(rows(x), s, t, w, rows(z), rows(dz), dst, relu_in)
    tol = _dw_tolerance(args, relu_in, fc.pw_conv_bwd_dw_plain(*args, relu_in))
    assert float(((dw_lost.float() - dw.float()).abs() / tol).max()) > 10


def _past_the_end(v, n_extra=256):
    """A copy of the f32 vector (or (2, c) stack) ``v`` whose memory past
    each row's end holds NaN: a view into a NaN-filled buffer."""
    rows = v.reshape(-1, v.shape[-1])
    buf = torch.full((rows.shape[0], rows.shape[1] + n_extra), float("nan"), device=v.device)
    buf[:, :rows.shape[1]] = rows
    out = buf[:, :rows.shape[1]]
    return out.contiguous() if rows.shape[0] > 1 else out.reshape(v.shape)


@pytest.mark.parametrize("m,cin,cout", [(300, 36, 70), (300, 96, 160), (1000, 192, 1000),
                                        (37, 1, 1), (130, 3, 1000), (640, 64, 8)],
                         ids=["36-70", "96-160", "192-1000", "1-1", "3-1000", "64-8"])
def test_pw_dw_kernel_channels_past_cin_and_cout(card, m, cin, cout):
    """Channels past Cin and Cout: a Cin tile of 1, 3, 36 or 64 channels
    (the second warpgroup's x panel not loaded: stale shared memory), of 96
    (the second warpgroup's rows past Cin), a last tile of 64 of 192, and
    Cout past the last 64-column panel and tile (70, 1000, 1, 8). scale and
    shift are views whose memory past Cin is NaN, and a launch before left
    NaN in the ring: the rows past Cin are computed but never stored, so the
    kernel's dW is finite and within the limit, and no row spills into the
    next chunk's partials."""
    args = list(_bwd_inputs("pw", (m, cin), (cin, cout), seed=3 * cin + cout))
    args[1], args[2] = _past_the_end(args[1]), _past_the_end(args[2])
    nan = torch.full((m, cout), float("nan"), device="cuda").bfloat16()
    fc.pw_conv_bwd_dw(args[0], args[1], args[2], args[3], nan, nan, args[6], True)
    for relu_in in (False, True):
        _assert_dw_matches_plain(tuple(args), relu_in)


def test_pw_dw_kernel_reads_misaligned_views_through_the_padded_copy(card):
    """x, z and dz at bases off 16 bytes go through the padded layout copy:
    the same kernel, the same bits as on aligned tensors."""
    x, s, t, w, z, dz, dst = _bwd_inputs("pw", (3000, 256), (256, 128), seed=53)

    def off(a):
        v = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    fc.reset_launch_counts()
    a = fc.pw_conv_bwd_dw(x, s, t, w, z, dz, dst, True)
    b_ = fc.pw_conv_bwd_dw(off(x), s, t, w, off(z), off(dz), dst, True)
    assert dict(fc.launch_counts) == {"pw_conv_dw": 2}
    assert torch.equal(a, b_)


_DW_OPT_IN_RUN = """
import torch
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

# (M, Cin, Cout): the column tile N is 64, 128 or 256 by Cout
SHAPES = {64: (20000, 256, 64), 128: (20000, 64, 128), 256: (20000, 128, 256)}

def run(order):
    out = {}
    for key in order:
        m, cin, cout = SHAPES[key]
        g = torch.Generator().manual_seed(cin + cout)
        x = torch.randn((m, cin), generator=g).bfloat16().cuda()
        s = (torch.randn(cin, generator=g) * 0.2 + 1).cuda()
        t = (torch.randn(cin, generator=g) * 0.1).cuda()
        w = torch.zeros((cin, cout), dtype=torch.bfloat16, device="cuda")
        z = torch.randn((m, cout), generator=g).bfloat16().cuda()
        dz = (torch.randn((m, cout), generator=g) * 0.1).bfloat16().cuda()
        dst = (torch.randn((2, cout), generator=g) * 0.01).cuda()
        out[key] = fc.pw_conv_bwd_dw(x, s, t, w, z, dz, dst, True).cpu()
    return out
"""


@pytest.mark.parametrize("order", [(64, 128, 256), (256, 128, 64)],
                         ids=["64-first", "256-first"])
def test_pw_dw_kernel_opts_in_per_instantiation_in_any_order(card, tmp_path, order):
    """The pointwise dW kernel's N-64, N-128 and N-256 instantiations share
    a function type; each asks for its own shared memory above 48 KB,
    whichever runs first in a fresh process. The fresh process's results
    equal this one's bit for bit."""
    path = tmp_path / "out.pt"
    script = _DW_OPT_IN_RUN + f"torch.save(run({order!r}), {str(path)!r})\n"
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=600)
    got = torch.load(path)
    ns = {}
    exec(_DW_OPT_IN_RUN, ns)
    want = ns["run"](order)
    for key in order:
        assert torch.equal(got[key], want[key]), key


def _assert_c3_dw_matches_plain(args, relu_in):
    """The 3x3 dW kernel against its plain version, twice: the same bits on
    the rerun, within ``_bwd_tolerances``' limit, finite; returns the
    kernel's dW and the limit."""
    dw = fc.conv3x3_bwd_dw(*args, relu_in)
    again = fc.conv3x3_bwd_dw(*args, relu_in)
    dw_p = fc.conv3x3_bwd_dw_plain(*args, relu_in)
    torch.cuda.synchronize()
    assert dw.dtype == torch.bfloat16 and dw.shape == args[3].shape
    assert torch.equal(dw, again)
    assert bool(torch.isfinite(dw.float()).all())
    _, tol = _bwd_tolerances("c3", *args, relu_in, torch.zeros_like(args[0]), dw_p)
    err = (dw.float() - dw_p.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    return dw, tol


# (x shape, Cout): ResNet-50's four 3x3 convs at batch 32, batch 1 at 7x7,
# 36 -> 70 at 9x9 (Cin and Cout off the panel and the 16-byte row), and a
# non-square 13x10 (W does not divide the 32-pixel stage; stages span images)
C3_DW_CASES = ([((chip_smoke.BATCH, hw, hw, c), c) for c, hw, _ in chip_smoke.C3_CASES]
               + [((1, 7, 7, 512), 512), ((2, 9, 9, 36), 70), ((3, 13, 10, 64), 64)])


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("x_shape,cout", C3_DW_CASES,
                         ids=[f"{'x'.join(map(str, x))}-{c}" for x, c in C3_DW_CASES])
def test_c3_dw_kernel_matches_plain(card, x_shape, cout, relu_in):
    """The Hopper 3x3 dW kernel against its plain version at ResNet-50's
    four 3x3 shapes at batch 32 (many pixel chunks; at Cin 64 a block's
    warpgroups are two taps), batch 1 at 7x7 (one chunk: the kernel stores
    dW itself), 36 -> 70 and a 13x10 image, a nonzero dstats; a rerun gives
    the same bits; one launch a call."""
    cin = x_shape[3]
    args = _bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=sum(x_shape) + cout)
    fc.reset_launch_counts()
    _assert_c3_dw_matches_plain(args, relu_in)
    assert dict(fc.launch_counts) == {"conv3x3_dw": 2}


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("x_shape,cout", [((2, 14, 14, 64), 64), ((3, 7, 7, 256), 128),
                                          ((2, 13, 10, 128), 256)],
                         ids=["14x14-64", "7x7-256", "13x10-128"])
def test_c3_dw_kernel_halo_closed_form(card, x_shape, cout, relu_in):
    """x = 0 and shift = 1: the fold is 1 inside the image and the SAME halo
    0 after it, so tap (dy, dx)'s dW[ci, co] is, for every ci, the sum of
    dz_eff[., co] over the pixels whose neighbour (h + dy - 1, w + dx - 1)
    lies in the image. The kernel gives that within the limit; the halo
    matters (the sum over all pixels is far over it) at every tap but the
    centre. Cin 64 pairs two taps in a block, 7x7 stages span images, 13x10
    rows wrap inside a stage."""
    n, h, wd, cin = x_shape
    x, s, t, w, z, dz, dst = _bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=h * wd + cin)
    x, t = torch.zeros_like(x), torch.ones_like(t)
    args = (x, s, t, w, z, dz, dst)
    dw, tol = _assert_c3_dw_matches_plain(args, relu_in)
    g = fc._dz_eff(x, z, dz, dst).double()                     # (n, h, wd, cout)
    hh = torch.arange(h, device="cuda").view(1, h, 1, 1)
    ww = torch.arange(wd, device="cuda").view(1, 1, wd, 1)
    for dy in range(3):
        for dx in range(3):
            inside = ((hh + dy - 1 >= 0) & (hh + dy - 1 < h) & (ww + dx - 1 >= 0)
                      & (ww + dx - 1 < wd))
            want = (g * inside).sum((0, 1, 2))
            err = (dw[dy, dx].double() - want).abs()
            assert bool((err <= tol[dy, dx]).all()), (dy, dx, float((err / tol[dy, dx]).max()))
            if (dy, dx) != (1, 1):
                lost = (g.sum((0, 1, 2)) - want).abs()
                assert float((lost / tol[dy, dx]).max()) > 10, (dy, dx)


@pytest.mark.parametrize("relu_in", [False, True])
def test_c3_dw_kernel_masks_rows_past_m(card, relu_in):
    """3 images of 7x7 are M = 147 pixels, 13 short of five 32-pixel
    stages: those rows are TMA's zero fill, dz = z = 0, whose dz_eff would
    be dst[0] = 4, and at the centre tap their x is zero fill too, which
    folds to act(shift) > 0. On the valid rows dz cancels dst[0] up to
    noise. The kernel is within the limit; a dW that took the 13 rows in
    would be off at the centre tap by 13 act(shift) dst[0], more than 10x
    the limit."""
    x_shape, cout = (3, 7, 7, 256), 256
    x, s, t, w, z, dz, dst = _bwd_inputs("c3", x_shape, (3, 3, 256, cout), seed=49)
    dst = torch.stack([dst[0] + 4.0, dst[1]])
    dz = (dz.float() - 4.0).bfloat16()
    t = t.abs() + 0.1
    args = (x, s, t, w, z, dz, dst)
    _, tol = _assert_c3_dw_matches_plain(args, relu_in)
    pad = -(-147 // 32) * 32 - 147
    lost = pad * t.view(-1, 1) * dst[0].view(1, -1)      # act(shift) = shift > 0
    assert float((lost / tol[1, 1]).max()) > 10


@pytest.mark.parametrize("x_shape,cout", [((2, 9, 5, 36), 70), ((2, 9, 5, 96), 160),
                                          ((2, 9, 5, 192), 1000), ((2, 3, 5, 1), 1),
                                          ((3, 7, 7, 64), 8)],
                         ids=["36-70", "96-160", "192-1000", "1-1", "64-8"])
def test_c3_dw_kernel_channels_past_cin_and_cout(card, x_shape, cout):
    """Channels past Cin and Cout: a panel of 1, 36 or 64 channels, of 96
    (the second panel of a tap past Cin), 192 (three panels a tap: 27 in
    all, so the last block's second warpgroup has no panel, and the others
    pair panels of two taps), Cout past the last 64-column panel and tile
    (70, 160, 1000, 1, 8). scale and shift are views whose memory past Cin
    is NaN, and a launch before left NaN in the ring: rows past Cin are
    computed but never stored, so the kernel's dW is finite and within the
    limit."""
    cin = x_shape[3]
    args = list(_bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=3 * cin + cout))
    args[1], args[2] = _past_the_end(args[1]), _past_the_end(args[2])
    nan = torch.full((*x_shape[:3], cout), float("nan"), device="cuda").bfloat16()
    fc.conv3x3_bwd_dw(args[0], args[1], args[2], args[3], nan, nan, args[6], True)
    for relu_in in (False, True):
        _assert_c3_dw_matches_plain(tuple(args), relu_in)


def test_c3_dw_kernel_reads_misaligned_views_through_the_padded_copy(card):
    """x, z and dz at bases off 16 bytes go through the padded layout copy:
    the same kernel, the same bits as on aligned tensors."""
    x, s, t, w, z, dz, dst = _bwd_inputs("c3", (4, 14, 14, 128), (3, 3, 128, 128), seed=59)

    def off(a):
        v = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    fc.reset_launch_counts()
    a = fc.conv3x3_bwd_dw(x, s, t, w, z, dz, dst, True)
    b_ = fc.conv3x3_bwd_dw(off(x), s, t, w, off(z), off(dz), dst, True)
    assert dict(fc.launch_counts) == {"conv3x3_dw": 2}
    assert torch.equal(a, b_)


_C3_DW_OPT_IN_RUN = """
import torch
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

# (x shape, Cout): the column tile N is 64, 128 or 256 by Cout
SHAPES = {64: ((8, 28, 28, 128), 64), 128: ((8, 28, 28, 64), 128),
          256: ((8, 14, 14, 128), 256)}

def run(order):
    out = {}
    for key in order:
        x_shape, cout = SHAPES[key]
        cin = x_shape[3]
        g = torch.Generator().manual_seed(cin + cout)
        x = torch.randn(x_shape, generator=g).bfloat16().cuda()
        s = (torch.randn(cin, generator=g) * 0.2 + 1).cuda()
        t = (torch.randn(cin, generator=g) * 0.1).cuda()
        w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16, device="cuda")
        z = torch.randn((*x_shape[:3], cout), generator=g).bfloat16().cuda()
        dz = (torch.randn((*x_shape[:3], cout), generator=g) * 0.1).bfloat16().cuda()
        dst = (torch.randn((2, cout), generator=g) * 0.01).cuda()
        out[key] = fc.conv3x3_bwd_dw(x, s, t, w, z, dz, dst, True).cpu()
    return out
"""


@pytest.mark.parametrize("order", [(64, 128, 256), (256, 128, 64)],
                         ids=["64-first", "256-first"])
def test_c3_dw_kernel_opts_in_per_instantiation_in_any_order(card, tmp_path, order):
    """The 3x3 dW kernel's N-64, N-128 and N-256 instantiations share a
    function type; each asks for its own shared memory above 48 KB,
    whichever runs first in a fresh process. The fresh process's results
    equal this one's bit for bit."""
    path = tmp_path / "out.pt"
    script = _C3_DW_OPT_IN_RUN + f"torch.save(run({order!r}), {str(path)!r})\n"
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=600)
    got = torch.load(path)
    ns = {}
    exec(_C3_DW_OPT_IN_RUN, ns)
    want = ns["run"](order)
    for key in order:
        assert torch.equal(got[key], want[key]), key


def _assert_c3_dx_matches_plain(args, relu_in):
    """The 3x3 dx kernel against its plain version, twice: the same bits on
    the rerun (dx, dscale and dshift), dx within ``_bwd_tolerances``' limit,
    dscale and dshift within the statistics limit, all finite; returns the
    kernel's (dx, dscale, dshift), the plain version's and dx's limit."""
    got = fc.conv3x3_bwd_dx(*args, relu_in)
    again = fc.conv3x3_bwd_dx(*args, relu_in)
    want = fc.conv3x3_bwd_dx_plain(*args, relu_in)
    torch.cuda.synchronize()
    dx = got[0]
    assert dx.dtype == torch.bfloat16 and dx.shape == args[0].shape
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    tol, _ = _bwd_tolerances("c3", *args, relu_in, want[0], torch.zeros_like(args[3]))
    err = (dx.float() - want[0].float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    rows = args[0].float().reshape(-1, args[0].shape[-1]).abs().sum(0)
    for g, p in zip(got[1:], want[1:]):
        lim = 1e-3 + 1e-4 * p.abs() + 1e-5 * rows * float(want[0].float().abs().max() + 1)
        assert bool(((g - p).abs() <= lim).all()), float(((g - p).abs() / lim).max())
    return got, want, tol


# (x shape, Cout): the 3x3 dW's cases, 1x1 images, W = 1 images, M below one
# 128-row tile with Cin and Cout off 8, and Cin and Cout off 64
C3_DX_CASES = C3_DW_CASES + [((2, 1, 1, 64), 64), ((4, 6, 1, 64), 72), ((1, 5, 7, 44), 20),
                             ((2, 9, 5, 200), 136)]


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("x_shape,cout", C3_DX_CASES,
                         ids=[f"{'x'.join(map(str, x))}-{c}" for x, c in C3_DX_CASES])
def test_c3_dx_kernel_matches_plain(card, x_shape, cout, relu_in):
    """The Hopper 3x3 dx kernel (dx, dscale, dshift) against its plain
    version at ResNet-50's four 3x3 shapes at batch 32, batch 1 at 7x7,
    36 -> 70 at 9x9, 13x10 images (tiles span images, rows wrap), 1x1 and
    W = 1 images (every tap but one, or three, in the halo), M below one
    tile and channels off 8 and 64, a nonzero dstats; a rerun gives the same
    bits; one launch a call."""
    cin = x_shape[3]
    args = _bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=sum(x_shape) + cout + 7)
    fc.reset_launch_counts()
    _assert_c3_dx_matches_plain(args, relu_in)
    assert dict(fc.launch_counts) == {"conv3x3_dx": 2}


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("x_shape,cout", [((2, 14, 14, 64), 64), ((3, 7, 7, 256), 128),
                                          ((2, 13, 10, 128), 256), ((2, 9, 1, 64), 64)],
                         ids=["14x14-64", "7x7-256", "13x10-128", "9x1-64"])
def test_c3_dx_kernel_halo_closed_form(card, x_shape, cout, relu_in):
    """dz = z = 0 and dst = (c, 0): dz_eff is c inside the image and the SAME
    halo 0, so dxn[q, ci] is the sum, over the taps whose source pixel q -
    ((dy-1)W + (dx-1)) lies in q's image, of sum_co c[co] W[tap, ci, co]. The
    kernel's dx is that (masked and scaled) within the limit; the halo
    matters: the sum over all nine taps is far over the limit at the border.
    7x7 tiles span images, 13x10 rows wrap inside a tile, W = 1 leaves only
    the middle column of taps."""
    n, h, wd, cin = x_shape
    x, s, t, w, _, _, dst = _bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=h * wd + cin + 3)
    zero = torch.zeros((n, h, wd, cout), dtype=torch.bfloat16, device="cuda")
    c = dst[0].bfloat16().float()
    args = (x, s, t, w, zero, zero, torch.stack([c, torch.zeros_like(c)]))
    (dx, _, _), _, tol = _assert_c3_dx_matches_plain(args, relu_in)
    hh = torch.arange(h, device="cuda").view(1, h, 1, 1)
    ww = torch.arange(wd, device="cuda").view(1, 1, wd, 1)
    want = torch.zeros((n, h, wd, cin), dtype=torch.float64, device="cuda")
    every = torch.zeros_like(want)
    for dy in range(3):
        for dx_ in range(3):
            v = w[dy, dx_].double() @ c.double()                 # (Cin,)
            inside = ((hh + 1 - dy >= 0) & (hh + 1 - dy < h) & (ww + 1 - dx_ >= 0)
                      & (ww + 1 - dx_ < wd))
            want += inside * v
            every += v
    keep = (x.float() * s + t > 0) if relu_in else torch.ones_like(want, dtype=torch.bool)
    want_dx = want * keep * s.double()
    err = (dx.double() - want_dx).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    lost = ((every - want) * keep * s.double()).abs()
    assert float((lost / tol).max()) > 10


@pytest.mark.parametrize("relu_in", [False, True])
def test_c3_dx_kernel_masks_rows_past_m(card, relu_in):
    """3 images of 7x7 are M = 147 pixels, 109 short of two 128-row tiles.
    Those rows read TMA's zero fill, whose dz_eff would be dst[0] (here 4
    up to noise), and their x is zero fill, so u = shift > 0 and the ReLU
    keeps their du. The kernel leaves them out of dscale and dshift by
    position: it is within the limit, and a dshift that took in their du (as
    the rows of zero images padded onto the batch, which lie in an image)
    would be more than 10x over it."""
    x_shape, cout = (3, 7, 7, 256), 256
    x, s, t, w, z, dz, dst = _bwd_inputs("c3", x_shape, (3, 3, 256, cout), seed=61)
    dst = torch.stack([dst[0] + 4.0, dst[1]])
    dz = (dz.float() - 4.0).bfloat16()
    t = t.abs() + 0.1
    args = (x, s, t, w, z, dz, dst)
    _, (dx_p, _, dt_p), _ = _assert_c3_dx_matches_plain(args, relu_in)
    pad = lambda a: torch.cat([a, a.new_zeros((3, *a.shape[1:]))])  # noqa: E731
    g = fc._dz_eff(pad(x), pad(z), pad(dz), dst)
    rows = chip_smoke._transposed_conv(g, w.float()).reshape(-1, 256)[147:256]
    lost = rows.sum(0)                                   # u = shift > 0 on those rows
    lim = (1e-3 + 1e-4 * dt_p.abs()
           + 1e-5 * x.float().abs().reshape(-1, 256).sum(0) * float(dx_p.float().abs().max() + 1))
    assert float((lost.abs() / lim).max()) > 10


@pytest.mark.parametrize("x_shape,cout", [((2, 9, 5, 36), 70), ((2, 9, 5, 96), 160),
                                          ((2, 9, 5, 192), 1000), ((2, 3, 5, 1), 1),
                                          ((3, 7, 7, 64), 8), ((2, 5, 5, 520), 64)],
                         ids=["36-70", "96-160", "192-1000", "1-1", "64-8", "520-64"])
def test_c3_dx_kernel_channels_past_cin_and_cout(card, x_shape, cout):
    """Channels past Cin and Cout: a column tile of 1, 36, 64 or 96 channels
    (the rest of the tile past Cin: W's rows zero-filled, dx not stored), a
    last tile of 192 or 520, Cout past the last 64-channel stage (70, 160,
    1000, 1, 8). scale and shift are views whose memory past Cin is NaN, and
    a launch before left NaN in the ring: the kernel's dx, dscale and dshift
    are finite and within the limit."""
    cin = x_shape[3]
    args = list(_bwd_inputs("c3", x_shape, (3, 3, cin, cout), seed=3 * cin + cout + 1))
    args[1], args[2] = _past_the_end(args[1]), _past_the_end(args[2])
    nan = torch.full((*x_shape[:3], cout), float("nan"), device="cuda").bfloat16()
    fc.conv3x3_bwd_dx(args[0], args[1], args[2], args[3], nan, nan, args[6], True)
    for relu_in in (False, True):
        _assert_c3_dx_matches_plain(tuple(args), relu_in)


def test_c3_dx_kernel_reads_misaligned_views_through_the_padded_copy(card):
    """x, w, z and dz at bases off 16 bytes go through the padded layout
    copy: the same kernel, the same bits as on aligned tensors."""
    x, s, t, w, z, dz, dst = _bwd_inputs("c3", (4, 14, 14, 128), (3, 3, 128, 128), seed=67)

    def off(a):
        v = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    fc.reset_launch_counts()
    a = fc.conv3x3_bwd_dx(x, s, t, w, z, dz, dst, True)
    b_ = fc.conv3x3_bwd_dx(off(x), s, t, off(w), off(z), off(dz), dst, True)
    assert dict(fc.launch_counts) == {"conv3x3_dx": 2}
    assert all(torch.equal(p, q) for p, q in zip(a, b_))


_C3_DX_OPT_IN_RUN = """
import torch
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

def run(order):
    # the column tile N forced to each of 64 and 128 in turn, at Cin 128
    out, plan = {}, fc.c3_dx_tiles
    for key in order:
        fc.c3_dx_tiles = lambda *a, n=key: n
        g = torch.Generator().manual_seed(key)
        x = torch.randn((4, 28, 28, 128), generator=g).bfloat16().cuda()
        s = (torch.randn(128, generator=g) * 0.2 + 1).cuda()
        t = (torch.randn(128, generator=g) * 0.1).cuda()
        w = (torch.randn((3, 3, 128, 96), generator=g) * 0.03).bfloat16().cuda()
        z = torch.randn((4, 28, 28, 96), generator=g).bfloat16().cuda()
        dz = (torch.randn((4, 28, 28, 96), generator=g) * 0.1).bfloat16().cuda()
        dst = (torch.randn((2, 96), generator=g) * 0.01).cuda()
        out[key] = [v.cpu() for v in fc.conv3x3_bwd_dx(x, s, t, w, z, dz, dst, True)]
    fc.c3_dx_tiles = plan
    return out
"""


@pytest.mark.parametrize("order", [(64, 128), (128, 64)], ids=["64-first", "128-first"])
def test_c3_dx_kernel_opts_in_per_instantiation_in_any_order(card, tmp_path, order):
    """The 3x3 dx kernel's N-64 and N-128 instantiations share a function
    type; each asks for its own shared memory above 48 KB (about 99 and 180
    KB), whichever runs first in a fresh process. The fresh
    process's results equal this one's bit for bit."""
    path = tmp_path / "out.pt"
    script = _C3_DX_OPT_IN_RUN + f"torch.save(run({order!r}), {str(path)!r})\n"
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=600)
    got = torch.load(path)
    ns = {}
    exec(_C3_DX_OPT_IN_RUN, ns)
    want = ns["run"](order)
    for key in order:
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key])), key


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


# (B, K, N): VGG16's three heads at buckets 1, 8, 32 and 33 (a second row
# block), LeNet's two heads, and ragged shapes (N % 16 != 0 with N % 4 == 0
# and K off the 64-deep stage; N not a multiple of 4; more rows than one
# block holds)
INT8_CASES = [(b, k, n) for b in (1, 8, 32)
              for k, n in ((25088, 4096), (4096, 4096), (4096, 1000))]
INT8_CASES += [(33, 25088, 4096), (5, 1000, 1000)]
INT8_CASES += [(8, 2450, 500), (8, 500, 10), (3, 777, 130), (40, 300, 70)]


def _int8_case(b, k, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, k, generator=g).to(dtype).cuda()
    q, s = im.quantize_int8(torch.randn(k, n, generator=g) * math.sqrt(2.0 / k))
    return x, torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


def _int8_f64_gate(x, q, s, y, ref):
    """f32 stays f32: the kernel's max |y - y64| against the f64 oracle is
    at most 4x the plain f32 version's plus 2^-24 max |y64| (one plane, or
    TF32, would be ~2^-9 |x||q| off)."""
    y64 = (x.double() @ q.double()) * s.double()
    err_k = float((y.double() - y64).abs().max())
    err_p = float((ref.double() - y64).abs().max())
    limit = 4 * err_p + 2.0 ** -24 * float(y64.abs().max())
    return err_k, err_p, limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k,n", INT8_CASES, ids=[f"{b}x{k}x{n}" for b, k, n in INT8_CASES])
def test_int8_kernel_matches_plain(card, b, k, n, dtype):
    x, q, s = _int8_case(b, k, n, dtype, b * 7 + k + n)
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
    if dtype == torch.float32:
        err_k, err_p, limit = _int8_f64_gate(x, q, s, y, ref)
        assert err_k <= limit, (err_k, err_p, limit)
    # the same bits in every run, and a row's bits in every bucket
    assert torch.equal(im.int8_matmul(x, q, s), y)
    assert torch.equal(im.int8_matmul(x[:1].contiguous(), q, s), y[:1])


@pytest.mark.parametrize("offset,route", [(4, im.ROUTE_WORDS), (1, im.ROUTE_BYTES)])
def test_int8_kernel_takes_q_off_tmas_alignment(card, offset, route):
    """A q whose base is 4 or 1 bytes off a 16-byte boundary goes by 4-byte
    cp.async or byte by byte (TMA needs 16-byte aligned rows) and gives the
    bits of an aligned q."""
    x, q, s = _int8_case(8, 4096, 1024, torch.float32, offset)
    buf = torch.empty(q.numel() + offset, dtype=torch.int8, device="cuda")
    qv = buf[offset:].view(q.shape)
    qv.copy_(q)
    assert im.q_route(q.shape[1], qv.data_ptr()) == route
    assert im.q_route(q.shape[1], q.data_ptr()) == im.ROUTE_TMA
    assert torch.equal(im.int8_matmul(x, qv, s), im.int8_matmul(x, q, s))


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


def _lstm_check(fl, args):
    """One kernel call against the plain version in f32 on the widened
    operands (``_lstm_tol``); returns the call's outputs."""
    with torch.inference_mode():
        hk, ck = fl.fused_lstm_cell(*args)
        h32, c32 = fl.reference_lstm_cell(*[a.float() for a in args])
    torch.cuda.synchronize()
    for k_, r32 in ((hk, h32), (ck, c32)):
        err = (k_.float() - r32.to(k_.dtype).float()).abs()
        assert bool((err <= _lstm_tol(r32, k_.dtype)).all()), float(err.max())
    return hk, ck


def _routes(fl, args):
    """The routes the wrapper gives the weights, x and h."""
    x, h, _, wx, wh = args[:5]
    n, w_row = h.shape[1], h.shape[1] * wx.element_size()
    return (max(fl.lstm_route(w_row, wx.data_ptr()), fl.lstm_route(w_row, wh.data_ptr())),
            fl.lstm_route(x.shape[1] * x.element_size(), x.data_ptr()),
            fl.lstm_route(n * h.element_size(), h.data_ptr()))


def test_lstm_kernel_depth_split_matches_the_planner(card):
    """The library's stage depth and warp count are the planner's."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    fl._LIB.get()
    assert (fl._LIB.tile["d"], fl._LIB.tile["w"]) == (fl.STAGE_DEPTH, fl.DEPTH_WARPS)


LSTM_TILE_CROSSING = [(b, n_in) for b in (33, 65) for n_in in (77, 256)]


@pytest.mark.parametrize("dt", sorted(LSTM_DTYPES))
@pytest.mark.parametrize("b,n_in", LSTM_TILE_CROSSING,
                         ids=[f"{b}x{i}" for b, i in LSTM_TILE_CROSSING])
def test_lstm_kernel_rows_across_row_tiles_equal_the_row_alone(card, b, n_in, dt):
    """B 33 and 65 span more than one row tile of the kernel's plan; each
    row equals the row alone (B 1) bit for bit, and the call its plain
    version within ``_lstm_tol``."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(b, n_in, 256, True, LSTM_DTYPES[dt], seed=b * 7 + n_in)
    plan = fl.lstm_tiles(b, n_in, 256, args[3].dtype == BF16,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    assert b > plan.rows
    hk, ck = _lstm_check(fl, args)
    with torch.inference_mode():
        assert chip_smoke.lstm_rows_alone(fl, args, hk, ck)


@pytest.mark.parametrize("dt", sorted(LSTM_DTYPES))
@pytest.mark.parametrize("b", [1, 32])
def test_lstm_kernel_long_depth_runs_the_ring_many_times(card, b, dt):
    """n_in 1200: 10 + 2 stages of 128 depths through the ring's 4 slots;
    within ``_lstm_tol`` of the plain version, a row alone bit for bit."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(b, 1200, 256, True, LSTM_DTYPES[dt], seed=b + 1200)
    hk, ck = _lstm_check(fl, args)
    with torch.inference_mode():
        h1, c1 = fl.fused_lstm_cell(*[a[-1:].contiguous() if i < 3 else a
                                      for i, a in enumerate(args)])
    assert torch.equal(h1, hk[-1:]) and torch.equal(c1, ck[-1:])


def _off16(t, nbytes=4):
    """A copy of ``t`` as a contiguous view whose base is ``nbytes`` past a
    16-byte boundary."""
    off = nbytes // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == nbytes
    return view


@pytest.mark.parametrize("dt", sorted(LSTM_DTYPES))
@pytest.mark.parametrize("b", [1, 32])
def test_lstm_kernel_takes_operands_off_16_bytes_by_cp_async(card, b, dt):
    """Weights, x and h whose bases are 4 bytes off 16 go by 4-byte
    cp.async instead of TMA and 16-byte copies; the bits are those of the
    aligned call (the route does not change the summation order)."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(b, 256, 256, True, LSTM_DTYPES[dt], seed=b + 3)
    off = [_off16(a) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    assert _routes(fl, args) == (fl.ROUTE_WIDE,) * 3
    assert _routes(fl, off) == (fl.ROUTE_WORDS,) * 3
    hk, ck = _lstm_check(fl, args)
    ho, co = _lstm_check(fl, off)
    assert torch.equal(ho, hk) and torch.equal(co, ck)


# (B, n_in, n, dtype, routes of the weights, x and h)
LSTM_ROUTE_CASES = [
    (3, 33, 100, "bf16", (1, 2, 1)),    # n 100 in bf16: 200-byte strips; odd n_in in bf16
    (5, 77, 100, "mixed", (1, 2, 0)),   # the same weights, f32 carries
    (4, 10, 33, "bf16", (2, 1, 2)),     # odd n in bf16: element by element
    (7, 77, 100, "f32", (0, 1, 0)),     # n_in 77 in f32: 308-byte rows
]


@pytest.mark.parametrize("b,n_in,n,dt,routes", LSTM_ROUTE_CASES,
                         ids=[f"{b}x{i}x{n}-{dt}" for b, i, n, dt, _ in LSTM_ROUTE_CASES])
def test_lstm_kernel_copies_what_tma_cannot_read(card, b, n_in, n, dt, routes):
    """Rows and strips that are not 16-byte aligned take 4-byte cp.async or
    element copies into the same stage layout: within ``_lstm_tol``, each
    row alone bit for bit."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(b, n_in, n, True, LSTM_DTYPES[dt], seed=b * n)
    assert _routes(fl, args) == routes
    hk, ck = _lstm_check(fl, args)
    with torch.inference_mode():
        assert chip_smoke.lstm_rows_alone(fl, args, hk, ck)


@pytest.mark.parametrize("dt", sorted(LSTM_DTYPES))
@pytest.mark.parametrize("n_in", [77, 256])
def test_lstm_kernel_reruns_are_bitwise_equal(card, n_in, dt):
    """Three calls on the same operands (B 32, GravesLSTM) give the same
    bits: no float atomics, a fixed summation order."""
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    args = _lstm_args(32, n_in, 256, True, LSTM_DTYPES[dt], seed=n_in)
    with torch.inference_mode():
        outs = [fl.fused_lstm_cell(*args) for _ in range(3)]
    assert all(torch.equal(h, outs[0][0]) and torch.equal(c, outs[0][1]) for h, c in outs[1:])


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
    (16, 12, 512, 64, True, torch.bfloat16, False),    # the train step's shape
    (1, 4, 512, 64, True, torch.bfloat16, True),       # cuts off the 128-row tiles
    (1, 3, 256, 20, True, torch.bfloat16, False),      # ragged: the padded layout copy
    (1, 3, 256, 20, False, torch.bfloat16, True),
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


def _fused_qkv(b, T, h, hd, seed):
    """q, k, v as the fused qkv projection's head split makes them: views
    of one (b, T, 3, h, hd) tensor, TMA-readable as they are."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, T, 3, h, hd, generator=g).bfloat16().cuda()
    return [x[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("hd", [64, 40])
def test_flash_kernel_takes_the_fused_qkv_split(card, hd):
    q, k, v = _fused_qkv(2, 256, 3, hd, 13)
    assert all(fa.tma_ready(t) and not t.is_contiguous() for t in (q, k, v))
    seg = torch.zeros(2, 256, dtype=torch.int32)
    seg[:, 150:] = 1
    seg = seg.cuda()
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True, hd ** -0.5, seg)
        o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), True,
                                          hd ** -0.5, seg)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, _, tol = _flash_tol(q, k, v, True, hd ** -0.5, seg)
    assert bool(((o.float() - o_ref).abs() <= tol).all())


def test_flash_kernel_copies_what_tma_cannot_read(card):
    """A misaligned view (a column slice) and an expanded tensor go
    through the padded layout copy: the same kernel, the same bits as on
    contiguous copies."""
    g = torch.Generator().manual_seed(17)
    wide = torch.randn(1, 4, 256, 66, generator=g).bfloat16().cuda()
    q = wide[..., 1:65]
    k = torch.randn(1, 1, 1, 64, generator=g).bfloat16().cuda().expand(1, 4, 256, 64)
    v = torch.randn(1, 4, 256, 64, generator=g).bfloat16().cuda()
    assert not fa.tma_ready(q) and not fa.tma_ready(k)
    fa.reset_launch_counts()
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
        o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v, True, 0.125)
    assert dict(fa.launch_counts) == {"flash_attention_fwd": 2}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


_OPT_IN_RUN = """
import torch
from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa

def run(hds):
    out = {}
    for hd in hds:
        g = torch.Generator().manual_seed(hd)
        q, k, v, do = (torch.randn(1, 2, 256, hd, generator=g).bfloat16().cuda()
                       for _ in range(4))
        with torch.inference_mode():
            o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
            dcap = fa.row_dot(o, do).contiguous()
            dk, dv = fa.flash_attention_dkv(q, k, v, lse, do, dcap, True, 0.125)
            dq = fa.flash_attention_dq(q, k, v, lse, do, dcap, True, 0.125)
        out[hd] = [t.cpu() for t in (o, lse, dk, dv, dq)]
    return out
"""


@pytest.mark.parametrize("order", [(128, 64), (64, 128)], ids=["128-then-64", "64-then-128"])
def test_flash_kernels_opt_in_per_head_dim_in_any_order(card, tmp_path, order):
    """The forward, dkv and dq kernels' hd-64 and hd-128 instantiations each
    ask for their own shared memory above 48 KB, whichever runs first in a
    fresh process (hd 128 asks for more: it must not leave hd 64 without its
    own opt-in). The fresh process's results equal this one's bit for bit."""
    path = tmp_path / "out.pt"
    script = _OPT_IN_RUN + f"torch.save(run({order!r}), {str(path)!r})\n"
    subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True, timeout=600)
    got = torch.load(path)
    ns = {}
    exec(_OPT_IN_RUN, ns)
    want = ns["run"](order)
    for hd in order:
        assert all(torch.equal(a, b) for a, b in zip(got[hd], want[hd])), hd


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
    (16, 12, 512, 64, True, torch.bfloat16, False),    # the train step's shape
    (2, 4, 128, 64, True, torch.bfloat16, False),      # T 128: the diagonal tile only
    (1, 4, 512, 64, True, torch.bfloat16, True),       # cuts off the 128-row tiles
    (1, 3, 256, 20, True, torch.bfloat16, True),       # ragged: the padded layout copy
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


def test_dkv_kernel_reruns_bit_identical_and_batch_independent(card):
    """dk, dv from the fused qkv split's views: two runs give the same bits,
    contiguous copies give the same bits, and a batch row's bits do not
    depend on the other rows."""
    q, k, v = _fused_qkv(3, 512, 4, 64, 23)
    do = _qkv(3, 4, 512, 64, torch.bfloat16, 24)[0]
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
        dcap = fa.row_dot(o, do).contiguous()
        dk, dv = fa.flash_attention_dkv(q, k, v, lse, do, dcap, True, 0.125)
        dk2, dv2 = fa.flash_attention_dkv(q, k, v, lse, do, dcap, True, 0.125)
        dkc, dvc = fa.flash_attention_dkv(q.contiguous(), k.contiguous(), v.contiguous(), lse,
                                          do, dcap, True, 0.125)
        dk1, dv1 = fa.flash_attention_dkv(q[1:], k[1:], v[1:], lse[4:].contiguous(), do[1:],
                                          dcap[4:].contiguous(), True, 0.125)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dk, dkc) and torch.equal(dv, dvc)
    assert torch.equal(dk[1:], dk1) and torch.equal(dv[1:], dv1)


@pytest.mark.parametrize("causal", [True, False])
def test_dkv_kernel_last_key_block_past_t(card, causal):
    """T 192: the backward takes T % 64, so the dkv kernel's last block of
    128 keys hangs 64 rows past T (TMA fills them with zeros; nothing is
    stored there). o and lse from the plain forward."""
    q, k, v = _qkv(2, 3, 192, 64, torch.bfloat16, 31)
    do = _qkv(2, 3, 192, 64, torch.bfloat16, 32)[0]
    with torch.inference_mode():
        o, lse = fa.flash_attention_plain(q, k, v, causal, 0.125)
        dcap = fa.row_dot(o, do).contiguous()
        dk, dv = fa.flash_attention_dkv(q, k, v, lse, do, dcap, causal, 0.125)
    torch.cuda.synchronize()
    ref, tols = chip_smoke.flash_bwd_oracle(fa, q, k, v, o, lse, do, causal, 0.125, None)
    for g, r, tol in ((dk, ref[1], tols[1]), (dv, ref[2], tols[2])):
        assert bool(((g.float() - r).abs() <= tol).all())


DQ_CASES = [  # (b, h, T, hd, causal, segmented): the train shapes, T 192 (the
    # last 128-row block half past T), hd 20 / 64 / 128, full and segmented
    (4, 12, 2048, 64, True, False),
    (16, 12, 512, 64, True, False),
    (2, 3, 192, 64, True, False),
    (2, 3, 192, 64, False, True),
    (1, 3, 192, 128, True, False),
    (1, 3, 320, 128, False, True),
    (1, 3, 192, 20, True, True),
    (2, 3, 256, 20, False, False),
]


@pytest.mark.parametrize("b,h,T,hd,causal,segmented", DQ_CASES)
def test_dq_kernel_matches_plain(card, b, h, T, hd, causal, segmented):
    """The Hopper dq kernel against the plain backward in f32 on the
    widened operands (phase 2f's limits, capped at the JAX probe's 0.16);
    o and lse from the plain forward (it takes T 192); a rerun gives the
    same bits; a lost causal mask is over the limit."""
    q, k, v = _qkv(b, h, T, hd, torch.bfloat16, 3 * T + hd)
    do = _qkv(b, h, T, hd, torch.bfloat16, 3 * T + hd + 1)[0]
    seg = None
    if segmented:
        seg = torch.zeros(b, T, dtype=torch.int32)
        seg[:, T // 3:] = 1
        seg[:, T // 3 + 77:] = 2
        seg = seg.cuda()
    scale = hd ** -0.5
    with torch.inference_mode():
        o, lse = fa.flash_attention_plain(q, k, v, causal, scale, seg)
        dcap = fa.row_dot(o, do).contiguous()
        fa.reset_launch_counts()
        dq = fa.flash_attention_dq(q, k, v, lse, do, dcap, causal, scale, seg)
        dq2 = fa.flash_attention_dq(q, k, v, lse, do, dcap, causal, scale, seg)
    torch.cuda.synchronize()
    assert dict(fa.launch_counts) == {"flash_attention_dq": 2}
    assert dq.dtype == torch.bfloat16 and dq.shape == (b, h, T, hd)
    assert torch.equal(dq, dq2)
    ref, tols = chip_smoke.flash_bwd_oracle(fa, q, k, v, o, lse, do, causal, scale, seg)
    err = (dq.float() - ref[0]).abs()
    assert bool(torch.isfinite(dq.float()).all())
    assert bool((err <= tols[0]).all()), float((err / tols[0]).max())
    if causal:
        lost = fa.flash_attention_dq_plain(*(t.float() for t in (q, k, v)), lse, do.float(),
                                           dcap, False, scale, seg)
        assert float(((lost - ref[0]).abs() / tols[0]).max()) > 10


def test_dq_kernel_reruns_bit_identical_and_batch_independent(card):
    """dq from the fused qkv split's views, from contiguous copies, with an
    expanded dO and a misaligned q (both through the padded layout copy):
    the same bits; a batch row's bits do not depend on the other rows."""
    q, k, v = _fused_qkv(3, 512, 4, 64, 29)
    do = _qkv(3, 4, 512, 64, torch.bfloat16, 30)[0]
    assert fa.tma_ready(q) and not q.is_contiguous()
    g = torch.Generator().manual_seed(31)
    wide = torch.randn(3, 4, 512, 66, generator=g).bfloat16().cuda()
    wide[..., 1:65] = q
    q_off = wide[..., 1:65]
    assert not fa.tma_ready(q_off)
    do_exp = torch.full((1, 1, 1, 1), 0.25, dtype=torch.bfloat16, device="cuda").expand(
        3, 4, 512, 64)
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
        dcap = fa.row_dot(o, do).contiguous()
        dq = fa.flash_attention_dq(q, k, v, lse, do, dcap, True, 0.125)
        dq2 = fa.flash_attention_dq(q, k, v, lse, do, dcap, True, 0.125)
        dqc = fa.flash_attention_dq(q.contiguous(), k.contiguous(), v.contiguous(), lse,
                                    do, dcap, True, 0.125)
        dqo = fa.flash_attention_dq(q_off, k, v, lse, do, dcap, True, 0.125)
        dq1 = fa.flash_attention_dq(q[1:], k[1:], v[1:], lse[4:].contiguous(), do[1:],
                                    dcap[4:].contiguous(), True, 0.125)
        dce = fa.row_dot(o, do_exp).contiguous()
        dqe = fa.flash_attention_dq(q, k, v, lse, do_exp, dce, True, 0.125)
        dqe2 = fa.flash_attention_dq(q, k, v, lse, do_exp.contiguous(), dce, True, 0.125)
    assert torch.equal(dq, dq2) and torch.equal(dq, dqc) and torch.equal(dq, dqo)
    assert torch.equal(dq[1:], dq1) and torch.equal(dqe, dqe2)


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


@pytest.mark.parametrize("t", [1, 2, 1000])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_fused_adam_alpha_by_pointer_is_the_value_entry(card, n, t):
    """The entry that reads alpha from the card (what a captured bundle
    replays) gives the value entry's p', m' and v' bit for bit, and reads
    the value there when the kernel runs: a graph captured at one alpha and
    replayed after the buffer changed gives the new alpha's bits."""
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
    from deeplearning4j_tpu_torch.nn.ops import launch as ops_launch
    from deeplearning4j_tpu_torch.updaters import Adam

    upd = Adam(1e-3)
    p, grad, m, v = _adam_inputs(card, n, seed=n + 7 * t)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    alpha = upd.alpha(t, t - 1, 0)
    buf = alpha.to(card)
    ops_launch.reset_launch_counts()
    by_value = fu.fused_adam_apply(p, grad, m, v, alpha, **kw)
    by_pointer = fu.fused_adam_apply(p, grad, m, v, buf, **kw)
    assert dict(ops_launch.launch_counts) == {"fused_adam": 2}
    assert all(torch.equal(a, b) for a, b in zip(by_value, by_pointer))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fu.fused_adam_apply(p, grad, m, v, buf, **kw)
    later = upd.alpha(t + 1, t, 0)
    buf.copy_(later)
    graph.replay()
    want = fu.fused_adam_apply(p, grad, m, v, later, **kw)
    assert all(torch.equal(a, b) for a, b in zip(replayed, want))


def test_narrow_graph_bundle_on_the_card_equals_its_single_steps(card):
    """The narrow fused-bottleneck graph at steps_per_call=2: two bundles
    (one captured CUDA graph, replayed twice) leave params, Nesterovs slots,
    BN state and scores equal to four single steps, under deterministic
    cuDNN; the graph holds two steps' kernel launches, a replay launches
    none eagerly, and tensors taken after the fit keep their values through
    a later fit."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.train import pipeline

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        single, _ = _model_and_plain()
        bundled, _ = _model_and_plain()
        bundled.conf.global_conf.steps_per_call = 2
        rng = np.random.default_rng(11)
        batches = [DataSet(rng.standard_normal((6, 20, 20, 3)).astype(np.float32),
                           np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)])
                   for _ in range(4)]
        scores = []
        for ds in batches:
            single.fit(ExistingDataSetIterator([ds]))
            scores.append(float(single.score_))
        fc.reset_launch_counts()
        bundled.fit(ExistingDataSetIterator(batches[:2]))
        first = bundled.bundle_scores_
        bundled.fit(ExistingDataSetIterator(batches[2:]))
        step = {"pw_conv": 8, "conv3x3": 3, "pw_conv_dx": 8, "pw_conv_dw": 8,
                "conv3x3_dx": 3, "conv3x3_dw": 3}
        assert bundled._bundled.captured_launches == {k: 2 * v for k, v in step.items()}
        assert dict(fc.launch_counts) == {
            k: (2 + pipeline.WARMUP_STEPS) * v for k, v in step.items()}
        assert list(first.host()) + list(bundled.bundle_scores_.host()) == scores
        for tree in ("params_", "opt_state_", "state_"):
            a, b = getattr(single, tree), getattr(bundled, tree)
            for v in a:
                flat_a = pipeline.tree_leaves(a[v])
                flat_b = pipeline.tree_leaves(b[v])
                assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)), (tree, v)
        held = [t.clone() for t in pipeline.tree_leaves(bundled.params_)]
        refs = pipeline.tree_leaves(bundled.params_)
        bundled.fit(ExistingDataSetIterator(batches[:2]))
        assert all(torch.equal(r, h) for r, h in zip(refs, held))
        assert bundled.iteration == 6
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det


def test_guarded_narrow_graph_bundle_on_the_card_equals_its_eager_steps(card):
    """The narrow bf16 graph under a fault policy with loss scaling and NaN
    injected at step 1 (inside the first bundle): at steps_per_call=2 the
    two bundles leave params, Nesterovs slots, BN state and the fault state
    (the scale backed off once) equal to four eager guarded steps, under
    deterministic cuDNN; the skipped step leaves the eager run's params as
    they were."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.train import pipeline
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        pol = FaultPolicy(init_loss_scale=2.0 ** 10, scale_growth_interval=2)
        eager, _ = _model_and_plain()
        bundled, _ = _model_and_plain()
        for m in (eager, bundled):
            m.set_fault_policy(pol)
        bundled.conf.global_conf.steps_per_call = 2
        rng = np.random.default_rng(12)
        batches = [DataSet(rng.standard_normal((6, 20, 20, 3)).astype(np.float32),
                           np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)])
                   for _ in range(4)]
        with fault_injection([1]):
            eager.fit(ExistingDataSetIterator(batches[:1]))
            kept = [t.clone() for t in pipeline.tree_leaves(eager.params_)]
            eager.fit(ExistingDataSetIterator(batches[1:2]))
            assert all(torch.equal(a, b)
                       for a, b in zip(kept, pipeline.tree_leaves(eager.params_)))
            eager.fit(ExistingDataSetIterator(batches[2:]))
            bundled.fit(ExistingDataSetIterator(batches))
        for tree in ("params_", "opt_state_", "state_", "fault_state_"):
            a = pipeline.tree_leaves(getattr(eager, tree))
            b = pipeline.tree_leaves(getattr(bundled, tree))
            assert all(torch.equal(x, y) for x, y in zip(a, b)), tree
        assert eager.bad_step_count == bundled.bad_step_count == 1
        assert eager.loss_scale == bundled.loss_scale == 2.0 ** 10
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det


def test_shared_engine_on_one_card_twice_splits_each_dispatch(card):
    """``InferenceEngine(devices=["cuda:0", "cuda:0"])`` on the narrow bf16
    graph: a dispatch at bucket 4 runs as two row blocks of 2 (twice one
    block's launches) and answers within phase 3's rule of the one-device
    engine (probabilities within 0.03)."""
    model, _ = _model_and_plain()
    one = InferenceEngine(model, buckets=[4])
    two = InferenceEngine(model, buckets=[4], devices=["cuda:0", "cuda:0"])
    x = np.random.default_rng(5).standard_normal((3, 20, 20, 3)).astype(np.float32)
    fc.reset_launch_counts()
    single = InferenceEngine(model, buckets=[2]).infer(x[:2])
    per_block = dict(fc.launch_counts)
    fc.reset_launch_counts()
    split = two.infer(x)
    assert dict(fc.launch_counts) == {k: 2 * v for k, v in per_block.items()}
    assert np.abs(split - one.infer(x)).max() <= chip_smoke.SERVE_PROB_TOL
    assert np.abs(split[:2] - single).max() <= chip_smoke.SERVE_PROB_TOL
    assert two.describe()["devices"] == ["cuda:0", "cuda:0"]


@pytest.mark.parametrize("n,capacity", [(1000, 64), (777, 777), (4097, 300), (25_557_032, 16384)])
def test_threshold_encode_on_the_card_is_the_cpus_bit_for_bit(card, n, capacity):
    """``parallel/compression.py`` on CUDA tensors: the message (indices,
    values, count), the residual and the decodes equal the CPU's on the same
    input bit for bit (the CPU's are held to JAX's by
    ``tests/test_torch_compression.py``), with exact ties at the threshold
    and at the capacity's cut; two runs agree."""
    from deeplearning4j_tpu_torch.parallel import compression as pc

    g = torch.Generator().manual_seed(n)
    grad = torch.randn(n, generator=g) * 1e-3
    grad[: n // 4] = torch.tensor([1e-3, -1e-3, 2e-3, -2e-3, 0.0])[
        torch.randint(0, 5, (n // 4,), generator=g)]
    cpu_msg, cpu_res = pc.threshold_encode(grad, 1e-3, capacity)
    runs = [pc.threshold_encode(grad.to(card), 1e-3, capacity) for _ in range(2)]
    for msg, res in runs:
        for a, b in zip(msg, cpu_msg):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(res.cpu(), cpu_res)
        assert torch.equal(pc.threshold_decode(msg, n).cpu(), pc.threshold_decode(cpu_msg, n))
    packed, res = pc.bitmap_encode(grad.to(card), 1e-3)
    cpu_packed, cpu_res = pc.bitmap_encode(grad, 1e-3)
    assert torch.equal(packed.cpu(), cpu_packed) and torch.equal(res.cpu(), cpu_res)
    assert torch.equal(pc.bitmap_decode(packed, 1e-3, n).cpu(),
                       pc.bitmap_decode(cpu_packed, 1e-3, n))


GLOO_ON_CUDA = r"""
import os, sys, tempfile
import numpy as np, torch, torch.distributed as dist
from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster, TrainingMesh
from deeplearning4j_tpu_torch.parallel.mesh import MeshInitError
from deeplearning4j_tpu_torch.parallel.zero import make_sharded_train_step
from deeplearning4j_tpu_torch.updaters import Adam

store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
dist.init_process_group("gloo", store=store, rank=0, world_size=1)
mesh = TrainingMesh(1, device="cuda")
assert mesh.host_staged

def net(steps=1, bn=False):
    b = NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
    if steps > 1:
        b = b.steps_per_call(steps)
    b = b.list().layer(L.DenseLayer(n_out=16, activation="tanh"))
    if bn:
        b = b.layer(L.BatchNormalization())
    return MultiLayerNetwork(b.layer(L.OutputLayer(n_out=3, activation="softmax"))
                             .set_input_type(InputType.feed_forward(8)).build()).init()

rng = np.random.default_rng(0)
ds = DataSet(rng.standard_normal((16, 8)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
refused = []
for what, fn in [
        ("make_sharded_train_step", lambda: make_sharded_train_step(net(), mesh)),
        ("sharded wrapper", lambda: ParallelWrapper(net(), mesh=mesh, sharded_update=True)
         .fit(ExistingDataSetIterator([ds]))),
        ("bundled wrapper", lambda: ParallelWrapper(net(2), mesh=mesh)
         .fit(ExistingDataSetIterator([ds, ds]))),
        ("master", lambda: SharedTrainingMaster(mesh=mesh).fit(net(), ExistingDataSetIterator([ds])))]:
    try:
        fn()
    except MeshInitError as e:
        assert "gloo" in str(e), e
        refused.append(what)
m = net(bn=True)
ParallelWrapper(m, mesh=mesh).fit(ExistingDataSetIterator([ds]), epochs=2)
assert m.iteration == 2 and np.isfinite(m.params_flat()).all()
print("refused", len(refused), refused)
"""


def test_gloo_on_cuda_takes_only_the_replicated_update(card):
    """A one-rank gloo group on CUDA tensors (what two ranks sharing a card
    use): the replicated wrapper trains a BN network; the sharded step, the
    sharded and bundled wrappers and the master refuse with MeshInitError
    naming gloo. A subprocess: this one may hold another default group."""
    res = subprocess.run([sys.executable, "-c", GLOO_ON_CUDA], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "refused 4" in res.stdout, res.stdout
