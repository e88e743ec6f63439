"""The port's fused conv+BN+ReLU forward ops against the JAX package.

On the CPU the port's ``pw_conv``/``conv3x3`` run their plain PyTorch
versions; they are held to the JAX references (``pw_conv_reference``,
``conv3x3_reference``) and, in bf16, to the Pallas kernels in interpret
mode, on the deliberately tile-unaligned shapes of ``test_fused_conv.py``.
The CUDA kernels themselves are compared with the plain versions on the
card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.

Tolerances:
- bf16 ``y``: one bf16 rounding step (2^-7 relative) plus the worst-case f32
  summation-order difference over depth K (2*K*2^-24*sum|u*w|). torch sums in
  another order than XLA, so an f32 sum can land on the other side of a
  bf16 rounding boundary; near y = 0 the order difference alone can exceed
  one bf16 step of y.
- f32 ``y``: atol 1e-5 (f32 summation order only).
- stats: rtol 1e-4, atol 1e-3, as ``test_fused_conv.py`` holds its kernels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.ops import fused_conv as jfc
from deeplearning4j_tpu_torch.nn.ops import fused_conv as tfc


def _arrays(seed, x_shape, w_shape):
    rng = np.random.default_rng(seed)
    cin = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    s = (rng.standard_normal(cin) * 0.2 + 1.0).astype(np.float32)
    t = (rng.standard_normal(cin) * 0.1).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.05).astype(np.float32)
    return x, s, t, w


CASES = {
    # the unaligned shapes of test_fused_conv.py:21-35
    "pw": ((200, 96), (96, 160)),
    "c3": ((3, 10, 12, 40), (3, 3, 40, 72)),
}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _both(op, dtype, relu_in, seed=7):
    x, s, t, w = _arrays(seed, *CASES[op])
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(x, jdt), jnp.asarray(s), jnp.asarray(t), jnp.asarray(w, jdt))
    targs = (torch.from_numpy(x).to(tdt), torch.from_numpy(s), torch.from_numpy(t),
             torch.from_numpy(w).to(tdt))
    return jargs, targs


def _port(op):
    return tfc.pw_conv if op == "pw" else tfc.conv3x3


def _reference(op):
    return jfc.pw_conv_reference if op == "pw" else jfc.conv3x3_reference


def _y_tolerance(op, targs, relu_in, y_ref):
    """One bf16 step of |y| plus 2*K*2^-24*sum|u*w| (see module docstring)."""
    x, s, t, w = targs
    u = tfc._fold(x, s, t, relu_in).to(x.dtype).float().abs()
    wa = w.float().abs()
    if op == "pw":
        k, mag = x.shape[1], u @ wa
    else:
        k = 9 * x.shape[3]
        mag = torch.nn.functional.conv2d(
            u.permute(0, 3, 1, 2), wa.permute(3, 2, 0, 1), padding=1
        ).permute(0, 2, 3, 1)
    return 2.0 ** -7 * np.abs(y_ref) + 2 * k * 2.0 ** -24 * mag.numpy()


def _assert_y(op, dtype, targs, relu_in, y_port, y_ref):
    y_port = y_port.float().numpy()
    y_ref = np.asarray(y_ref, np.float32)
    assert y_port.shape == y_ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(y_port, y_ref, rtol=0, atol=1e-5)
    else:
        tol = _y_tolerance(op, targs, relu_in, y_ref)
        err = np.abs(y_port - y_ref)
        assert (err <= tol).all(), f"max err/tol {(err / tol).max():.3g}"


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("op", ["pw", "c3"])
def test_port_matches_jax_reference(op, dtype, relu_in):
    jargs, targs = _both(op, dtype, relu_in)
    y_ref, st_ref = _reference(op)(*jargs, relu_in)
    y, st = _port(op)(*targs, relu_in)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    _assert_y(op, dtype, targs, relu_in, y, y_ref)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("op", ["pw", "c3"])
def test_port_matches_pallas_interpret(op, relu_in):
    """The Pallas kernels (interpret mode) cast to bf16 inside, so this
    comparison is bf16 only."""
    jargs, targs = _both(op, "bfloat16", relu_in, seed=11)
    kern = jfc.pw_conv if op == "pw" else jfc.conv3x3
    y_ref, st_ref = kern(*jargs, relu_in, True)
    y, st = _port(op)(*targs, relu_in)
    _assert_y(op, "bfloat16", targs, relu_in, y, y_ref)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4, atol=1e-3)


def test_fp32_plain_does_not_round_to_bf16():
    """The f32 leg stays f32 end to end: it matches an f64 computation far
    below one bf16 step."""
    x, s, t, w = _arrays(3, (64, 48), (48, 40))
    y, st = tfc.pw_conv_plain(*(torch.from_numpy(a) for a in (x, s, t, w)), True)
    u = np.maximum(x.astype(np.float64) * s + t, 0.0)
    ref = u @ w.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st[1].numpy(), (ref * ref).sum(0), rtol=1e-5)


def test_halo_is_zero_after_the_fold():
    """With x = 0 and relu(shift) > 0 everywhere, a border output sees fewer
    taps than an interior one: folding the zero padding would make them
    equal."""
    x = torch.zeros((1, 4, 4, 2))
    s = torch.ones(2)
    t = torch.full((2,), 0.5)
    w = torch.ones((3, 3, 2, 1))
    y, _ = tfc.conv3x3(x, s, t, w, True)
    assert float(y[0, 1, 1, 0]) == pytest.approx(9 * 2 * 0.5)
    assert float(y[0, 0, 0, 0]) == pytest.approx(4 * 2 * 0.5)


def test_cpu_tensors_take_the_plain_version():
    tfc.reset_launch_counts()
    _, targs = _both("pw", "bfloat16", True)
    y1, st1 = tfc.pw_conv(*targs, True)
    y2, st2 = tfc.pw_conv_plain(*targs, True)
    assert torch.equal(y1, y2) and torch.equal(st1, st2)
    assert sum(tfc.launch_counts.values()) == 0


def test_non_cuda_device_is_refused_not_computed():
    """A tensor that is neither on the CPU nor on a card is refused by the
    kernel wrapper's guards (no fallback)."""
    x = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    s = torch.empty(16, device="meta")
    w = torch.empty((16, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfc.pw_conv(x, s, s, w, False)


# ------------------------------------------------------------------ backward
def _cotangents(seed, y_shape, cout):
    """dy (bf16) and a nonzero dstats (f32), seeded."""
    rng = np.random.default_rng(seed)
    dy = (rng.standard_normal(y_shape) * 0.1).astype(np.float32)
    dst = np.stack([rng.standard_normal(cout) * 0.01,
                    rng.standard_normal(cout) * 0.002]).astype(np.float32)
    return dy, dst


def _port_vjp(op, targs, relu_in, dy, dst):
    """Gradients of the port's autograd op (plain backward on the CPU)."""
    x, s, t, w = (a.clone().requires_grad_() for a in targs)
    y, st = _port(op)(x, s, t, w, relu_in)
    torch.autograd.backward((y, st), (torch.from_numpy(dy).to(y.dtype),
                                      torch.from_numpy(dst)))
    return y, [a.grad for a in (x, s, t, w)]


def _grad_tolerance(name, op, targs, relu_in, dy, dst, ref):
    """One bf16 step of the reference plus the worst-case f32
    summation-order difference over the depth of the product (Cout or
    9*Cout for dx, the pixel count for dW), from |dz_eff| and |w| or |xn|."""
    x, s, t, w = (a.float() for a in targs)
    z = _port(op)(*targs, relu_in)[0].float()
    g = (torch.from_numpy(dy).to(torch.bfloat16).float() + torch.from_numpy(dst[0])
         + 2.0 * z * torch.from_numpy(dst[1])).abs()
    wa = w.abs()
    if name == "dx":
        if op == "pw":
            k, mag = w.shape[1], g @ wa.T
        else:
            k = 9 * w.shape[3]
            mag = torch.nn.functional.conv2d(
                g.permute(0, 3, 1, 2), wa.flip(0, 1).permute(2, 3, 0, 1),
                padding=1).permute(0, 2, 3, 1)
        mag = mag * s.abs()
    else:
        xn = tfc._fold(targs[0], targs[1], targs[2], relu_in).abs()
        if op == "pw":
            k, mag = x.shape[0], xn.T @ g
        else:
            k = x.shape[0] * x.shape[1] * x.shape[2]
            mag = tfc.conv3x3_bwd_dw_plain(
                xn.to(torch.bfloat16), torch.ones_like(s), torch.zeros_like(t),
                w, torch.zeros_like(z), g, torch.zeros_like(torch.from_numpy(dst)),
                False).float().abs()
    return 2.0 ** -7 * np.abs(ref) + 2 * k * 2.0 ** -24 * mag.numpy()


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("op", ["pw", "c3"])
def test_vjp_matches_pallas_interpret(op, relu_in):
    """The port's backward (the plain versions, through the autograd op)
    against ``jax.vjp`` of the Pallas kernels in interpret mode, under the
    same cotangents (dy, dstats), on the unaligned shapes.

    Tolerances: dx and dW within one bf16 step plus the f32 summation-order
    allowance over the product's depth (both sides round to bf16 after an
    f32 sum taken in another order); dscale/dshift rtol 1e-4, atol 1e-3.
    The interpreter's 3x3 dW is not the exactly rounded sum: measured up to
    2^-5 off at values near 5 and 0.0036 off at 0.0004, where the port's
    dW equals an f64 evaluation rounded once (test_conv3x3_dw_is_exactly_
    rounded). So the 3x3 dW also gets half a bf16 step of its largest
    value, 2^-8 * max|dW| (0.041 here)."""
    jargs, targs = _both(op, "bfloat16", relu_in, seed=13)
    kern = jfc.pw_conv if op == "pw" else jfc.conv3x3
    (y_ref, st_ref), vjp = jax.vjp(lambda *a: kern(*a, relu_in, True), *jargs)
    dy, dst = _cotangents(5, y_ref.shape, y_ref.shape[-1])
    ref = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.asarray(dst)))
    y, grads = _port_vjp(op, targs, relu_in, dy, dst)
    for name, g, r in zip(("dx", "dscale", "dshift", "dW"), grads, ref):
        r = np.asarray(r, np.float32)
        g = g.float().numpy()
        assert g.shape == r.shape, name
        if name in ("dscale", "dshift"):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-3, err_msg=name)
        else:
            tol = _grad_tolerance(name, op, targs, relu_in, dy, dst, r)
            if op == "c3" and name == "dW":
                tol = tol + 2.0 ** -8 * np.abs(r).max()
            err = np.abs(g - r)
            assert (err <= tol).all(), f"{name}: max err/tol {(err / tol).max():.3g}"
    assert grads[0].dtype == torch.bfloat16 and grads[3].dtype == torch.bfloat16


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("op", ["pw", "c3"])
def test_plain_backward_is_the_forward_gradient(op, relu_in):
    """In f32 (no bf16 rounding anywhere) the hand-written backward equals
    autograd of the plain forward: the flipped taps of the transposed 3x3
    conv, the shifted dW products and the statistics' cotangent are right.
    Random inputs put no fold input exactly on the ReLU's tie."""
    _, targs = _both(op, "float32", relu_in, seed=17)
    x, s, t, w = (a.clone().requires_grad_() for a in targs)
    plain = tfc.pw_conv_plain if op == "pw" else tfc.conv3x3_plain
    y, st = plain(x, s, t, w, relu_in)
    dy, dst = _cotangents(9, tuple(y.shape), y.shape[-1])
    dy, dst = torch.from_numpy(dy), torch.from_numpy(dst)
    want = torch.autograd.grad((y, st), (x, s, t, w), (dy, dst))
    bwd = tfc.pw_conv_bwd_plain if op == "pw" else tfc.conv3x3_bwd_plain
    got = bwd(*targs, y.detach(), dy, dst, relu_in)
    for name, g, r in zip(("dx", "dscale", "dshift", "dW"), got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("relu_in", [False, True])
def test_conv3x3_dw_is_exactly_rounded(relu_in):
    """The port's 3x3 dW (bf16) against the same sum taken in f64 from the
    same bf16 operands: within half a bf16 step plus the f32
    summation-order allowance over the pixel depth."""
    _, targs = _both("c3", "bfloat16", relu_in, seed=13)
    x, s, t, w = targs
    z, _ = tfc.conv3x3_plain(x, s, t, w, relu_in)
    dy, dst = _cotangents(5, tuple(z.shape), z.shape[-1])
    dz, dst = torch.from_numpy(dy).to(torch.bfloat16), torch.from_numpy(dst)
    got = tfc.conv3x3_bwd_dw_plain(x, s, t, w, z, dz, dst, relu_in).double()
    xn = tfc._fold(x, s, t, relu_in).to(torch.bfloat16).double()
    g = (dz.float() + dst[0] + 2.0 * z.float() * dst[1]).to(torch.bfloat16).double()
    xp = torch.nn.functional.pad(xn, (0, 0, 1, 1, 1, 1))
    n, h, wd, cin = x.shape
    taps = [xp[:, a:a + h, b:b + wd, :].reshape(-1, cin) for a in range(3) for b in range(3)]
    g2 = g.reshape(-1, g.shape[-1])
    exact = torch.stack([p.T @ g2 for p in taps]).reshape(got.shape)
    mag = torch.stack([p.abs().T @ g2.abs() for p in taps]).reshape(got.shape)
    tol = 2.0 ** -8 * exact.abs() + 2 * g2.shape[0] * 2.0 ** -24 * mag
    assert bool(((got - exact).abs() <= tol).all())


def test_stats_cotangent_reaches_dw():
    """The downstream BN's gradient enters through the stats output:
    zeroing dstats changes dW (test_fused_conv.py's check, on the port)."""
    _, targs = _both("pw", "bfloat16", False, seed=19)
    dy, dst = _cotangents(3, (200, 160), 160)
    _, with_st = _port_vjp("pw", targs, False, dy, dst)
    _, without = _port_vjp("pw", targs, False, dy, np.zeros_like(dst))
    assert (with_st[3].float() - without[3].float()).abs().max() > 1e-4


def test_relu_tie_gradient_is_the_references():
    """At a fold input of exactly 0 the gradient is 0.5 of the upstream one,
    as jnp.maximum's: half of the rows sit on the tie (x = 0, shift = 0)."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    x[::2] = 0.0
    s = np.full(8, 1.5, np.float32)
    t = np.zeros(8, np.float32)
    t[4:] = 0.25
    w = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((16, 6)).astype(np.float32)

    def jf(x_):
        y, st = jfc.pw_conv_reference(x_, jnp.asarray(s), jnp.asarray(t),
                                      jnp.asarray(w), True)
        return jnp.sum(y * dy) + jnp.sum(st[1]) * 1e-3

    ref = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y, st = tfc.pw_conv_plain(xt, torch.from_numpy(s), torch.from_numpy(t),
                              torch.from_numpy(w), True)
    (y * torch.from_numpy(dy)).sum().add(st[1].sum() * 1e-3).backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the tie rows carry half of the gradient of the rows just above zero
    assert np.abs(ref[::2, :4]).max() > 0


def test_dw_split_covers_the_pixels():
    """The 3x3 dW kernel's plan (c3_dw_tiles) at ResNet-50's four 3x3
    shapes at batch 32, batch 1 at 7x7 and one pixel: two 64-row panels of
    dW's (tap, Cin) rows a block (Cin 64: five row tiles, the last with one
    panel), N = Cout rounded up, and the pixels in whole 32-pixel stages, at
    most one wave of blocks (two an SM at N 64) unless the tiles alone
    exceed it."""
    for m, cin, cout in ((100352, 64, 64), (25088, 128, 128), (6272, 256, 256),
                         (1568, 512, 512), (49, 512, 512), (1, 8, 8)):
        n, chunk, splits = tfc.c3_dw_tiles(m, cin, cout, 132)
        assert chunk % 32 == 0 and splits * chunk >= m > (splits - 1) * chunk
        tiles = -(-9 * -(-cin // 64) // 2) * -(-cout // n)
        assert tiles * splits <= max(tiles, (2 if n == 64 else 1) * 132)
    assert tfc.c3_dw_tiles(100352, 64, 64, 132) == (64, 1952, 52)
    assert tfc.c3_dw_tiles(1568, 512, 512, 132) == (256, 1568, 1)
    assert tfc.c3_dw_tiles(1, 8, 8, 132) == (64, 32, 1)


# ------------------------------------------------------- host logic (stubbed)
class _Recorded:
    def __init__(self):
        self.args = {}

    def launch(self, fn, op, args):
        self.args[op] = args
        tfc.launch_counts[op] += 1


def _stub(monkeypatch, lib, names, tile):
    """The wrappers of ``lib`` on "meta" (or CPU) tensors, with the library,
    the CUDA-only checks and the launch stubbed: what the kernel would get."""
    import contextlib

    rec = _Recorded()
    monkeypatch.setattr(lib, "get", lambda: type("H", (), dict.fromkeys(names))())
    monkeypatch.setattr(lib, "tile", tile)
    monkeypatch.setattr(tfc, "_launch", rec.launch)
    monkeypatch.setattr(tfc, "_ptrs", lambda *ts: ts)   # the launch sees the tensors
    monkeypatch.setattr(tfc, "_check_kernel_args", lambda op, x, specs: None)
    monkeypatch.setattr(tfc.torch.cuda, "device", lambda d: contextlib.nullcontext())
    return rec


def _stub_bwd(monkeypatch, rows=128):
    monkeypatch.setattr(tfc, "_sm_count", lambda index: 132)
    return _stub(monkeypatch, tfc._BWD, ("dl4j_pw_conv_bwd_dx", "dl4j_conv3x3_bwd_dx",
                                         "dl4j_pw_conv_bwd_dw", "dl4j_conv3x3_bwd_dw"),
                 {"m": rows, "p": 128, "c": 128, "s": 32})


def _stub_fwd(monkeypatch, rows=128):
    monkeypatch.setattr(tfc, "_sm_count", lambda index: 132)
    return _stub(monkeypatch, tfc._FWD, ("dl4j_pw_conv_fwd", "dl4j_conv3x3_fwd"),
                 {"m": rows, "n": 256, "k": 64})


def _meta(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("m,cin,cout", [(100352, 64, 64), (6272, 1024, 256), (507, 36, 70),
                                        (49, 2048, 512), (200, 96, 160)])
def test_pw_dx_wrapper_sizes_partials_by_its_own_tile_and_pads_for_tma(monkeypatch, m, cin,
                                                                       cout):
    """The pointwise dx kernel's partials have one row per 128-pixel block
    (its own tile, "p"); a Cout that is not a multiple of 8 (TMA's 16-byte
    row stride) reaches the kernel as zero-padded w, z, dz and dst of Cout8
    columns, a Cin that is not as a zero-padded x of Cin8 (its row stride
    handed over); dx keeps x's shape."""
    rec = _stub_bwd(monkeypatch)
    x, w = _meta((m, cin)), _meta((cin, cout))
    s = _meta((cin,), torch.float32)
    z = dz = _meta((m, cout))
    dst = _meta((2, cout), torch.float32)
    dx, ds, dt = tfc.pw_conv_bwd_dx(x, s, s, w, z, dz, dst, True)
    args = rec.args["pw_conv_dx"]
    cout8, cin8 = -(-cout // 8) * 8, -(-cin // 8) * 8
    assert args[10:] == (m, cin, cout8, cin8, 1)
    assert args[0].shape == args[7].shape == (m, cin8) and (args[0] is x) is (cin8 == cin)
    wk, zk, dzk, dstk, partial = args[3], args[4], args[5], args[6], args[8]
    assert wk.shape == (cin, cout8) and zk.shape == dzk.shape == (m, cout8)
    assert dstk.shape == (2, cout8)
    assert (wk is w) is (cout8 == cout) and (dzk is dz) is (cout8 == cout)
    assert partial.shape == (-(-m // 128), 2, cin)
    assert dx.shape == (m, cin) and ds.shape == dt.shape == (cin,)


def test_pw_dx_padding_adds_nothing():
    """The padded operands of a ragged Cout hold the operands unchanged and
    zeros past Cout, so they give the plain version's dx, dscale and dshift
    (up to the f32 summation order of the longer product)."""
    rng = np.random.default_rng(3)
    m, cin, cout = 37, 36, 70
    x = torch.from_numpy(rng.standard_normal((m, cin)).astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.standard_normal(cin) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.standard_normal(cin) * 0.1).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)).bfloat16()
    z = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32)).bfloat16()
    dz = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32)).bfloat16()
    dst = torch.from_numpy((rng.standard_normal((2, cout)) * 0.01).astype(np.float32))
    xp, wp, zp, dzp, dstp, cout8 = tfc._dx_operands(x, w, z, dz, dst)
    assert xp.shape == (m, 40) and not xp[:, 36:].any() and torch.equal(xp[:, :36], x)
    assert cout8 == 72 and wp.shape == (cin, 72) and zp.shape == dzp.shape == (m, 72)
    assert dstp.shape == (2, 72) and not dstp[:, 70:].any() and not wp[:, 70:].any()
    assert not zp[:, 70:].any() and not dzp[:, 70:].any()
    for a, b in ((w, wp), (z, zp), (dz, dzp), (dst, dstp)):
        assert torch.equal(a, b[:, :70])
    for a, b in zip(tfc.pw_conv_bwd_dx_plain(x, s, t, w, z, dz, dst, True),
                    tfc.pw_conv_bwd_dx_plain(x, s, t, wp, zp, dzp, dstp, True)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=1e-6)


def test_conv3x3_dx_sizes_partials_by_the_m_tile(monkeypatch):
    """The 3x3 dx kernel's partials have one row per row block of the tile
    the library reports (its "m" key: sized by the key, not by a constant),
    64-row partials for 64-row tiles as for the kernel's 128; aligned NHWC
    operands reach it as views of themselves."""
    for rows in (64, 128):
        rec = _stub_bwd(monkeypatch, rows)
        x = _meta((2, 7, 7, 64))
        w = _meta((3, 3, 64, 64))
        s = _meta((64,), torch.float32)
        z = dz = _meta((2, 7, 7, 64))
        dst = _meta((2, 64), torch.float32)
        tfc.conv3x3_bwd_dx(x, s, s, w, z, dz, dst, False)
        args = rec.args["conv3x3_dx"]
        assert args[10:] == (2, 7, 7, 64, 64, 64, 64, 0, tfc.c3_dx_tiles(64))
        assert args[3]._base is w and args[5]._base is dz
        assert args[8].shape == (-(-98 // rows), 2, 64)


# (M, Cin, Cout) of ResNet-50's fifteen pointwise convs at batch 32, batch 1
# at 7x7, one pixel, and channel counts off the tiles
_PW = [(64, 64, 56), (64, 256, 56), (256, 64, 56), (256, 128, 28), (128, 512, 28),
       (256, 512, 28), (512, 128, 28), (512, 256, 14), (256, 1024, 14), (512, 1024, 14),
       (1024, 256, 14), (1024, 512, 7), (512, 2048, 7), (1024, 2048, 7), (2048, 512, 7)]
PW_DW_SHAPES = ([(32 * hw * hw, ci, co) for ci, co, hw in _PW]
                + [(49, 1024, 512), (49, 2048, 512), (1, 64, 64), (1, 2048, 512),
                   (507, 36, 70), (5000, 192, 1000), (200, 96, 160), (37, 1, 1)])


@pytest.mark.parametrize("m,cin,cout", PW_DW_SHAPES,
                         ids=[f"{m}x{ci}-{co}" for m, ci, co in PW_DW_SHAPES])
def test_pw_dw_tiles_cover_every_pixel_once_in_whole_stages(m, cin, cout):
    """The pointwise dW kernel's pixel chunks: each a whole number of
    32-pixel stages, every pixel in exactly one chunk (the last chunk ends
    past M by less than a chunk), at most one wave of blocks (two an SM at
    N 64) unless the output tiles alone exceed it, and a grid within CUDA's
    limits (a 1-D grid of at most 2^31 - 1 blocks); N is Cout rounded up to
    64, 128 or 256. ResNet-50's shapes fill at least half a wave."""
    sms = 132
    n, chunk, splits = tfc.pw_dw_tiles(m, cin, cout, sms)
    assert n == (64 if cout <= 64 else 128 if cout <= 128 else 256)
    assert chunk > 0 and chunk % 32 == 0
    assert (splits - 1) * chunk < m <= splits * chunk
    starts = [k * chunk for k in range(splits)]
    covered = sum(min(m, s + chunk) - s for s in starts)
    assert covered == m and all(s < m for s in starts)
    tiles = -(-cin // 128) * -(-cout // n)
    wave = (2 if n == 64 else 1) * sms
    blocks = tiles * splits
    assert blocks <= max(tiles, wave) and blocks <= 2 ** 31 - 1
    if m >= 32 * 32 * 7 * 7 and tiles < wave:
        assert blocks * 2 > wave


def test_pw_dw_tiles_fill_the_wave_with_fewer_longer_chunks():
    """At stage 1 (64 -> 256, 100,352 pixels) one 64 x 256 tile is split
    into 131 chunks of 24 stages, about one block an SM. More tiles than a
    wave take one chunk each."""
    assert tfc.pw_dw_tiles(100352, 64, 256, 132) == (256, 768, 131)
    assert tfc.pw_dw_tiles(100352, 64, 64, 132) == (64, 384, 262)
    assert tfc.pw_dw_tiles(1568, 1024, 2048, 132) == (256, 800, 2)
    assert tfc.pw_dw_tiles(1, 2048, 512, 132) == (256, 32, 1)
    assert tfc.pw_dw_tiles(2000, 4096, 4096, 132) == (256, 2016, 1)


@pytest.mark.parametrize("m,cin,cout", [(100352, 64, 256), (1568, 1024, 2048), (507, 36, 70),
                                        (200, 96, 160), (49, 2048, 512)])
def test_pw_dw_wrapper_hands_the_kernel_tma_operands(monkeypatch, m, cin, cout):
    """The pointwise dW kernel gets x as (M, Cin8) and z, dz as (M, Cout8)
    (a Cin or Cout that is not a multiple of 8, TMA's 16-byte row stride, as
    a zero-padded copy; aligned operands as they are), their row strides,
    the column tile and chunk of :func:`pw_dw_tiles`, and (splits, Cin,
    Cout) f32 partials; dst, scale and shift as they are; dW has w's shape."""
    rec = _stub_bwd(monkeypatch)
    x, w = _meta((m, cin)), _meta((cin, cout))
    s = _meta((cin,), torch.float32)
    z, dz = _meta((m, cout)), _meta((m, cout))
    dst = _meta((2, cout), torch.float32)
    dw = tfc.pw_conv_bwd_dw(x, s, s, w, z, dz, dst, True)
    args = rec.args["pw_conv_dw"]
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    n, chunk, splits = tfc.pw_dw_tiles(m, cin, cout, 132)
    assert args[8:] == (m, cin, cout, cin8, cout8, 1, n, chunk)
    xk, sk, tk, zk, dzk, dstk, partial, dwk = args[:8]
    assert xk.shape == (m, cin8) and (xk is x) is (cin8 == cin)
    assert zk.shape == dzk.shape == (m, cout8)
    assert (zk is z) is (cout8 == cout) and (dzk is dz) is (cout8 == cout)
    assert sk is s and tk is s and dstk is dst
    assert partial.shape == (splits, cin, cout) and partial.dtype == torch.float32
    assert dwk is dw and dw.shape == (cin, cout) and dw.dtype == torch.bfloat16


def test_conv3x3_dw_keeps_its_split(monkeypatch):
    """The 3x3 dW kernel gets c3_dw_tiles' column tile and chunk, NHWC x
    and dz as their (M, C) pixel rows, their row strides, and (splits, 9,
    Cin, Cout) f32 partials (stage 1 at batch 32: 52 chunks)."""
    rec = _stub_bwd(monkeypatch)
    x, w = _meta((32, 56, 56, 64)), _meta((3, 3, 64, 64))
    s = _meta((64,), torch.float32)
    z = dz = _meta((32, 56, 56, 64))
    dst = _meta((2, 64), torch.float32)
    tfc.conv3x3_bwd_dw(x, s, s, w, z, dz, dst, False)
    args = rec.args["conv3x3_dw"]
    n, chunk, splits = tfc.c3_dw_tiles(100352, 64, 64, 132)
    assert splits == 52
    assert args[8:] == (32, 56, 56, 64, 64, 64, 64, 0, n, chunk)
    assert args[0].shape == args[4].shape == (100352, 64)
    assert args[0]._base is x and args[4]._base is dz   # views, no copy
    assert args[6].shape == (splits, 9, 64, 64)


C3_DW_SHAPES = [((32, 56, 56, 64), 64), ((32, 28, 28, 128), 128), ((32, 14, 14, 256), 256),
                ((32, 7, 7, 512), 512), ((1, 7, 7, 512), 512), ((2, 9, 9, 36), 70),
                ((3, 13, 10, 64), 64), ((2, 9, 5, 192), 1000), ((1, 1, 1, 1), 1)]
_C3_IDS = [f"{'x'.join(map(str, x))}-{co}" for x, co in C3_DW_SHAPES]


@pytest.mark.parametrize("x_shape,cout", C3_DW_SHAPES, ids=_C3_IDS)
def test_c3_dw_tiles_cover_every_pixel_once_in_whole_stages(x_shape, cout):
    """Every pixel in exactly one chunk of whole 32-pixel stages (the last
    chunk ends past M by less than a chunk), at most one wave of blocks
    unless the (tap, Cin) row tiles alone exceed it, a 1-D grid within
    CUDA's limit of 2^31 - 1 blocks, N = Cout rounded up to 64, 128 or 256;
    ResNet-50's batch-32 shapes fill at least half a wave."""
    sms = 132
    m, cin = math.prod(x_shape[:3]), x_shape[3]
    n, chunk, splits = tfc.c3_dw_tiles(m, cin, cout, sms)
    assert n == (64 if cout <= 64 else 128 if cout <= 128 else 256)
    assert chunk > 0 and chunk % 32 == 0
    starts = [k * chunk for k in range(splits)]
    assert sum(min(m, s0 + chunk) - s0 for s0 in starts) == m and all(s0 < m for s0 in starts)
    panels = 9 * -(-cin // 64)
    tiles = -(-panels // 2) * -(-cout // n)
    wave = (2 if n == 64 else 1) * sms
    assert tiles * splits <= max(tiles, wave) and tiles * splits <= 2 ** 31 - 1
    if x_shape[0] == 32:
        assert tiles * splits * 2 > wave


@pytest.mark.parametrize("x_shape,cout", C3_DW_SHAPES, ids=_C3_IDS)
def test_c3_dw_wrapper_hands_the_kernel_tma_operands(monkeypatch, x_shape, cout):
    """The 3x3 dW kernel gets x as (M, Cin8) and z, dz as (M, Cout8) pixel
    rows (a Cin or Cout that is not a multiple of 8 as a zero-padded copy;
    aligned operands as views of themselves), the NHWC geometry, their row
    strides, relu_in, the column tile and chunk of c3_dw_tiles, and (splits,
    9, Cin, Cout) f32 partials, none with one split (the kernel then stores
    dW itself); dst, scale and shift as they are; dW has w's shape."""
    rec = _stub_bwd(monkeypatch)
    cin = x_shape[3]
    m = math.prod(x_shape[:3])
    x, w = _meta(x_shape), _meta((3, 3, cin, cout))
    s = _meta((cin,), torch.float32)
    z, dz = _meta((*x_shape[:3], cout)), _meta((*x_shape[:3], cout))
    dst = _meta((2, cout), torch.float32)
    dw = tfc.conv3x3_bwd_dw(x, s, s, w, z, dz, dst, True)
    args = rec.args["conv3x3_dw"]
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    n, chunk, splits = tfc.c3_dw_tiles(m, cin, cout, 132)
    assert args[8:] == (*x_shape[:3], cin, cout, cin8, cout8, 1, n, chunk)
    xk, sk, tk, zk, dzk, dstk, partial, dwk = args[:8]
    assert xk.shape == (m, cin8) and zk.shape == dzk.shape == (m, cout8)
    assert (xk._base is x) is (cin8 == cin) and (dzk._base is dz) is (cout8 == cout)
    assert sk is s and tk is s and dstk is dst
    assert partial.shape == (splits if splits > 1 else 0, 9, cin, cout)
    assert partial.dtype == torch.float32
    assert dwk is dw and dw.shape == (3, 3, cin, cout) and dw.dtype == torch.bfloat16


def _bad_c3_dw_args(case):
    """3x3 backward (dW or dx) arguments on "meta" tensors, one of them
    wrong."""
    n, h, wd, cin, cout = 2, 9, 5, 40, 24
    a = {"x": _meta((n, h, wd, cin)), "scale": _meta((cin,), torch.float32),
         "shift": _meta((cin,), torch.float32), "w": _meta((3, 3, cin, cout)),
         "z": _meta((n, h, wd, cout)), "dz": _meta((n, h, wd, cout)),
         "dst": _meta((2, cout), torch.float32)}
    if case == "f32 x":
        a["x"] = _meta((n, h, wd, cin), torch.float32)
    elif case == "f64 scale":
        a["scale"] = _meta((cin,), torch.float64)
    elif case == "z of another image":
        a["z"] = _meta((n, wd, h, cout))
    elif case == "pointwise w":
        a["w"] = _meta((cin, cout))
    elif case == "strided x":
        a["x"] = _meta((n, h, 2 * wd, cin))[:, :, ::2]
    elif case == "x rank 2":
        a["x"] = _meta((n * h * wd, cin))
    elif case == "dst on the CPU":
        a["dst"] = torch.zeros((2, cout))
    return a


@pytest.mark.parametrize("case,err,msg", [
    ("f32 x", TypeError, "x must be torch.bfloat16"),
    ("f64 scale", TypeError, "scale must be torch.float32"),
    ("z of another image", ValueError, "z must have shape"),
    ("pointwise w", ValueError, "w must be"),
    ("strided x", ValueError, "x must be contiguous"),
    ("x rank 2", ValueError, "x must have rank 4"),
    ("dst on the CPU", ValueError, "dst is on cpu"),
    ("all well", ValueError, "the kernel takes CUDA tensors")])
def test_c3_dw_wrapper_refuses_bad_arguments_off_the_cpu(monkeypatch, case, err, msg):
    """Off the CPU ("meta" tensors reach the kernel's wrapper without a
    card) the 3x3 dW wrapper refuses what its kernel does not take, before
    the kernel library is built or a launch is counted; arguments it takes
    are refused for the device alone. No fallback to the plain version."""

    def unbuilt():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfc._BWD, "get", unbuilt)
    a = _bad_c3_dw_args(case)
    before = dict(tfc.launch_counts)
    with pytest.raises(err, match=msg):
        tfc.conv3x3_bwd_dw(a["x"], a["scale"], a["shift"], a["w"], a["z"], a["dz"], a["dst"],
                           True)
    assert dict(tfc.launch_counts) == before


def test_c3_dw_padding_adds_nothing():
    """The padded pixel rows of a ragged Cin and Cout hold the operands
    unchanged and zeros past them; on what the kernel reads of them (Cin
    columns of x, Cout columns of z and dz) the plain version gives the same
    dW, and with the padding read as channels, dW's rows and columns past
    Cin and Cout are 0 and the rest is unchanged."""
    rng = np.random.default_rng(4)
    n, h, wd, cin, cout = 2, 5, 4, 36, 70
    x = torch.from_numpy(rng.standard_normal((n, h, wd, cin)).astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.standard_normal(cin) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.standard_normal(cin) * 0.1).astype(np.float32))
    w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
    z = torch.from_numpy(rng.standard_normal((n, h, wd, cout)).astype(np.float32)).bfloat16()
    dz = torch.from_numpy(rng.standard_normal((n, h, wd, cout)).astype(np.float32)).bfloat16()
    dst = torch.from_numpy((rng.standard_normal((2, cout)) * 0.01).astype(np.float32))
    xp, zp, dzp = tfc._dw_operands(x, z, dz)
    m = n * h * wd
    assert xp.shape == (m, 40) and zp.shape == dzp.shape == (m, 72)
    assert not xp[:, cin:].any() and not zp[:, cout:].any() and not dzp[:, cout:].any()
    assert torch.equal(xp[:, :cin], x.reshape(m, cin)) and torch.equal(dzp[:, :cout],
                                                                        dz.reshape(m, cout))
    want = tfc.conv3x3_bwd_dw_plain(x, s, t, w, z, dz, dst, True)
    got = tfc.conv3x3_bwd_dw_plain(xp[:, :cin].reshape(x.shape), s, t, w,
                                   zp[:, :cout].reshape(z.shape),
                                   dzp[:, :cout].reshape(dz.shape), dst, True)
    assert torch.equal(got, want)
    wide = tfc.conv3x3_bwd_dw_plain(
        xp.reshape(n, h, wd, 40), F.pad(s, (0, 4)), F.pad(t, (0, 4)),
        torch.zeros((3, 3, 40, 72), dtype=torch.bfloat16), zp.reshape(n, h, wd, 72),
        dzp.reshape(n, h, wd, 72), F.pad(dst, (0, 2)), True)
    assert not wide[:, :, cin:].any() and not wide[:, :, :, cout:].any()
    torch.testing.assert_close(wide[:, :, :cin, :cout].float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)


# (x shape, Cout) of the 3x3 dx: the dW's shapes, W = 1 images, M < 128 and
# Cin past one 256-channel tile
C3_DX_SHAPES = C3_DW_SHAPES + [((4, 6, 1, 64), 72), ((1, 3, 40, 200), 8),
                               ((2, 5, 5, 520), 64)]
_C3_DX_IDS = [f"{'x'.join(map(str, x))}-{co}" for x, co in C3_DX_SHAPES]


@pytest.mark.parametrize("x_shape,cout", C3_DX_SHAPES, ids=_C3_DX_IDS)
def test_c3_dx_tiles_give_a_valid_n(x_shape, cout):
    """The 3x3 dx kernel's column tile is 64 for a Cin of at most 64, else
    128 (the grid covers a wider Cin in such tiles); the 1-D grid stays
    within CUDA's 2^31 - 1 blocks."""
    m, cin = math.prod(x_shape[:3]), x_shape[3]
    n = tfc.c3_dx_tiles(cin)
    assert n == (64 if cin <= 64 else 128)
    assert -(-m // 128) * -(-cin // n) <= 2 ** 31 - 1


def test_c3_dx_tiles_take_the_fastest_measured_n():
    """At ResNet-50's four 3x3 shapes at batch 32 on 132 SMs the planner
    takes the column tile that was fastest there on an H100 (PERF.md): 64 at
    56x56 (Cin 64), 128 at 28x28, 14x14 and 7x7."""
    assert [tfc.c3_dx_tiles(c) for c in (64, 128, 256, 512)] == [64, 128, 128, 128]


@pytest.mark.parametrize("x_shape,cout", C3_DX_SHAPES, ids=_C3_DX_IDS)
def test_c3_dx_wrapper_hands_the_kernel_tma_operands(monkeypatch, x_shape, cout):
    """The 3x3 dx kernel gets x as (M, Cin8) pixel rows, w as (9 Cin, Cout8)
    rows (the kernel reads them through a (Cout, Cin, 9) map), z and dz as
    (M, Cout8) pixel rows and dst as (2, Cout8) with zeros past Cout: a Cin
    or Cout that is not a multiple of 8 (TMA's 16-byte row stride) as a
    zero-padded copy, aligned operands as views of themselves; the NHWC
    geometry, Cin, Cout, the row strides, relu_in and c3_dx_tiles' column
    tile; dx takes x's padded rows and partials one row per 128-row block.
    dx comes back in x's shape, dscale and dshift as (Cin,)."""
    rec = _stub_bwd(monkeypatch)
    cin = x_shape[3]
    m = math.prod(x_shape[:3])
    x, w = _meta(x_shape), _meta((3, 3, cin, cout))
    s = _meta((cin,), torch.float32)
    z, dz = _meta((*x_shape[:3], cout)), _meta((*x_shape[:3], cout))
    dst = _meta((2, cout), torch.float32)
    dx, ds, dt = tfc.conv3x3_bwd_dx(x, s, s, w, z, dz, dst, True)
    args = rec.args["conv3x3_dx"]
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    assert args[10:] == (*x_shape[:3], cin, cout, cin8, cout8, 1, tfc.c3_dx_tiles(cin))
    xk, sk, tk, wk, zk, dzk, dstk, dxk, partial, gst = args[:10]
    assert xk.shape == dxk.shape == (m, cin8) and wk.shape == (9 * cin, cout8)
    assert zk.shape == dzk.shape == (m, cout8) and dstk.shape == (2, cout8)
    assert (xk._base is x) is (cin8 == cin) and (wk._base is w) is (cout8 == cout)
    assert (zk._base is z) is (cout8 == cout) and (dzk._base is dz) is (cout8 == cout)
    assert (dstk is dst) is (cout8 == cout) and sk is s and tk is s
    assert partial.shape == (-(-m // 128), 2, cin) and partial.dtype == torch.float32
    assert gst.shape == (2, cin)
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert ds.shape == dt.shape == (cin,)


@pytest.mark.parametrize("case,err,msg", [
    ("f32 x", TypeError, "x must be torch.bfloat16"),
    ("f64 scale", TypeError, "scale must be torch.float32"),
    ("z of another image", ValueError, "z must have shape"),
    ("pointwise w", ValueError, "w must be"),
    ("strided x", ValueError, "x must be contiguous"),
    ("x rank 2", ValueError, "x must have rank 4"),
    ("dst on the CPU", ValueError, "dst is on cpu"),
    ("all well", ValueError, "the kernel takes CUDA tensors")])
def test_c3_dx_wrapper_refuses_bad_arguments_off_the_cpu(monkeypatch, case, err, msg):
    """Off the CPU ("meta" tensors reach the kernel's wrapper without a
    card) the 3x3 dx wrapper refuses what its kernel does not take, before
    the kernel library is built or a launch is counted; arguments it takes
    are refused for the device alone. No fallback to the plain version."""

    def unbuilt():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfc._BWD, "get", unbuilt)
    a = _bad_c3_dw_args(case)
    before = dict(tfc.launch_counts)
    with pytest.raises(err, match=msg):
        tfc.conv3x3_bwd_dx(a["x"], a["scale"], a["shift"], a["w"], a["z"], a["dz"], a["dst"],
                           True)
    assert dict(tfc.launch_counts) == before


@pytest.mark.parametrize("relu_in", [False, True])
def test_c3_dx_padding_adds_nothing(relu_in):
    """The padded operands of a ragged Cin and Cout hold the operands
    unchanged and zeros past them: x's padded columns are never read (the
    kernel's maps stop at Cin), and with w, z, dz and dst read at Cout8 the
    plain version gives the same dx, dscale and dshift (up to the f32
    summation order of the longer product)."""
    rng = np.random.default_rng(5)
    n, h, wd, cin, cout = 2, 5, 4, 36, 70
    x = torch.from_numpy(rng.standard_normal((n, h, wd, cin)).astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.standard_normal(cin) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.standard_normal(cin) * 0.1).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
                         ).bfloat16()
    z = torch.from_numpy(rng.standard_normal((n, h, wd, cout)).astype(np.float32)).bfloat16()
    dz = torch.from_numpy(rng.standard_normal((n, h, wd, cout)).astype(np.float32)).bfloat16()
    dst = torch.from_numpy((rng.standard_normal((2, cout)) * 0.01).astype(np.float32))
    xp, wp, zp, dzp, dstp, cout8 = tfc._dx_operands(x, w, z, dz, dst)
    m = n * h * wd
    assert cout8 == 72 and xp.shape == (m, 40) and wp.shape == (9 * cin, 72)
    assert zp.shape == dzp.shape == (m, 72) and dstp.shape == (2, 72)
    assert not xp[:, cin:].any() and torch.equal(xp[:, :cin], x.reshape(m, cin))
    for a, b in ((w.reshape(9 * cin, cout), wp), (z.reshape(m, cout), zp),
                 (dz.reshape(m, cout), dzp), (dst, dstp)):
        assert torch.equal(a, b[:, :cout]) and not b[:, cout:].any()
    padded = tfc.conv3x3_bwd_dx_plain(x, s, t, wp.reshape(3, 3, cin, 72),
                                      zp.reshape(n, h, wd, 72), dzp.reshape(n, h, wd, 72),
                                      dstp, relu_in)
    for a, b in zip(tfc.conv3x3_bwd_dx_plain(x, s, t, w, z, dz, dst, relu_in), padded):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=1e-5)


def test_pw_dw_padding_adds_nothing():
    """The padded operands of a ragged Cin and Cout hold the operands
    unchanged and zeros past them; on what the kernel reads of them (Cin
    columns of x, Cout columns of z and dz) the plain version gives the same
    dW."""
    rng = np.random.default_rng(3)
    m, cin, cout = 37, 36, 70
    x = torch.from_numpy(rng.standard_normal((m, cin)).astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.standard_normal(cin) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.standard_normal(cin) * 0.1).astype(np.float32))
    w = torch.zeros((cin, cout), dtype=torch.bfloat16)
    z = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32)).bfloat16()
    dz = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32)).bfloat16()
    dst = torch.from_numpy((rng.standard_normal((2, cout)) * 0.01).astype(np.float32))
    xp, zp, dzp = tfc._dw_operands(x, z, dz)
    assert xp.shape == (m, 40) and zp.shape == dzp.shape == (m, 72)
    assert not xp[:, cin:].any() and not zp[:, cout:].any() and not dzp[:, cout:].any()
    assert torch.equal(xp[:, :cin], x) and torch.equal(zp[:, :cout], z)
    assert torch.equal(dzp[:, :cout], dz)
    want = tfc.pw_conv_bwd_dw_plain(x, s, t, w, z, dz, dst, True)
    got = tfc.pw_conv_bwd_dw_plain(xp[:, :cin], s, t, w, zp[:, :cout], dzp[:, :cout], dst, True)
    assert torch.equal(got, want)
    aligned = _meta((64, 64))
    assert all(a is aligned for a in tfc._dw_operands(aligned, aligned, aligned))


def _bad_dw_args(case):
    """Pointwise dW arguments on "meta" tensors, one of them wrong."""
    m, cin, cout = 96, 40, 24
    a = {"x": _meta((m, cin)), "scale": _meta((cin,), torch.float32),
         "shift": _meta((cin,), torch.float32), "w": _meta((cin, cout)),
         "z": _meta((m, cout)), "dz": _meta((m, cout)),
         "dst": _meta((2, cout), torch.float32)}
    if case == "f32 dz":
        a["dz"] = _meta((m, cout), torch.float32)
    elif case == "f64 dst":
        a["dst"] = _meta((2, cout), torch.float64)
    elif case == "short z":
        a["z"] = _meta((m, cout - 8))
    elif case == "w of another Cin":
        a["w"] = _meta((cin + 8, cout))
    elif case == "strided dz":
        a["dz"] = _meta((cout, m)).t()
    elif case == "x rank 3":
        a["x"] = _meta((2, m // 2, cin))
    elif case == "scale on the CPU":
        a["scale"] = torch.zeros(cin)
    return a


@pytest.mark.parametrize("case,err,msg", [
    ("f32 dz", TypeError, "dz must be torch.bfloat16"),
    ("f64 dst", TypeError, "dst must be torch.float32"),
    ("short z", ValueError, "z must have shape"),
    ("w of another Cin", ValueError, "w must be"),
    ("strided dz", ValueError, "dz must be contiguous"),
    ("x rank 3", ValueError, "x must have rank 2"),
    ("scale on the CPU", ValueError, "scale is on cpu"),
    ("all well", ValueError, "the kernel takes CUDA tensors")])
def test_pw_dw_wrapper_refuses_bad_arguments_off_the_cpu(monkeypatch, case, err, msg):
    """Off the CPU (here "meta", which reaches the kernel's wrapper without
    a card) the pointwise dW wrapper refuses what its kernel does not take,
    before the kernel library is built or a launch is counted, each with its
    own message; arguments it takes are refused for the device alone. There
    is no fallback to the plain version."""

    def unbuilt():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfc._BWD, "get", unbuilt)
    a = _bad_dw_args(case)
    before = dict(tfc.launch_counts)
    with pytest.raises(err, match=msg):
        tfc.pw_conv_bwd_dw(a["x"], a["scale"], a["shift"], a["w"], a["z"], a["dz"], a["dst"],
                           True)
    assert dict(tfc.launch_counts) == before


FWD_STUB_CASES = [("pw_conv", (100352, 64), 64), ("pw_conv", (6272, 1024), 256),
                  ("pw_conv", (507, 36), 70), ("pw_conv", (49, 2048), 512),
                  ("pw_conv", (200, 96), 160), ("conv3x3", (2, 9, 5, 36), 70),
                  ("conv3x3", (32, 7, 7, 512), 512), ("conv3x3", (1, 7, 7, 40), 64)]


@pytest.mark.parametrize("op,x_shape,cout", FWD_STUB_CASES,
                         ids=[f"{o}-{'x'.join(map(str, x))}-{c}" for o, x, c in FWD_STUB_CASES])
def test_fwd_wrapper_sizes_partials_by_its_own_tile_and_pads_for_tma(monkeypatch, op, x_shape,
                                                                     cout):
    """The forward kernel's partials have one row per 128-pixel block (its
    own tile, "m"); a Cin that is not a multiple of 8 (TMA's 16-byte row
    stride) reaches the kernel as a zero-padded (M, Cin8) x and Cin8-entry
    scale and shift, a Cout that is not as a zero-padded (taps*Cin, Cout8) w
    and an (M, Cout8) y whose padding is dropped; aligned operands go as
    they are (views, no copy). The column tile and the depth split are
    fwd_tiles', and a split comes with its (splits, M, Cout8) f32
    workspace."""
    rec = _stub_fwd(monkeypatch)
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw_conv" else (3, 3, cin, cout)
    x, w = _meta(x_shape), _meta(w_shape)
    s, t = _meta((cin,), torch.float32), _meta((cin,), torch.float32)
    fwd = tfc.pw_conv_fwd if op == "pw_conv" else tfc.conv3x3_fwd
    y, st = fwd(x, s, t, w, True)
    args = rec.args[op]
    m, taps = x.numel() // cin, (1 if op == "pw_conv" else 9)
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    dims = (m,) if op == "pw_conv" else x_shape[:3]
    n, splits = tfc.fwd_tiles(m, cin, cout, taps, 132)
    assert args[8:] == (*dims, cin, cout, 1, n, splits)
    xk, sk, tk, wk, yk, partial, stats, ws = args[:8]
    assert (ws.shape == (splits, m, cout8)) if splits > 1 else ws is stats
    assert xk.numel() == m * cin8 and xk.shape[-1] == cin8 and (xk is x) is (cin8 == cin)
    assert sk.shape == tk.shape == (cin8,)
    assert (sk is s) is (cin8 == cin) and (tk is t) is (cin8 == cin)
    assert wk.numel() == taps * cin * cout8 and wk.shape[-1] == cout8
    assert (wk is w) is (cout8 == cout)
    assert yk.shape == (*x_shape[:-1], cout8) and stats.shape == (2, cout)
    assert partial.shape == (-(-m // 128), 2, cout)
    assert y.shape == (*x_shape[:-1], cout) and st is stats


def test_fwd_wrapper_sizes_partials_by_the_tile_query(monkeypatch):
    """The partials follow the kernel's own row tile, not a constant."""
    rec = _stub_fwd(monkeypatch, rows=96)
    x, w, s = _meta((1000, 64)), _meta((64, 64)), _meta((64,), torch.float32)
    tfc.pw_conv_fwd(x, s, s, w, False)
    assert rec.args["pw_conv"][5].shape == (-(-1000 // 96), 2, 64)


@pytest.mark.parametrize("op", ["pw_conv", "conv3x3"])
def test_fwd_wrapper_copies_misaligned_bases(monkeypatch, op):
    """x, scale, shift and w at bases off 16 bytes (CPU tensors handed to
    the kernel path directly, the launch stubbed) reach the kernel as
    aligned copies that hold the same values."""
    rec = _stub_fwd(monkeypatch)
    x_shape, cin, cout = ((40, 64), 64, 32) if op == "pw_conv" else ((1, 5, 8, 64), 64, 32)
    w_shape = (cin, cout) if op == "pw_conv" else (3, 3, cin, cout)
    rng = np.random.default_rng(5)

    def off(shape, dtype):
        n = int(np.prod(shape))
        v = torch.empty(n + 1, dtype=dtype)[1:].view(shape)
        v.copy_(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
        assert v.data_ptr() % 16
        return v

    x, w = off(x_shape, torch.bfloat16), off(w_shape, torch.bfloat16)
    s, t = off((cin,), torch.float32), off((cin,), torch.float32)
    tfc._fused_fwd(op, x, s, t, w, True)
    xk, sk, tk, wk = rec.args[op][:4]
    assert all(a.data_ptr() % 16 == 0 for a in (xk, sk, tk, wk))
    assert torch.equal(xk.reshape(x.shape), x) and torch.equal(wk.reshape(w.shape), w)
    assert torch.equal(sk, s) and torch.equal(tk, t)


@pytest.mark.parametrize("op", ["pw_conv", "conv3x3"])
def test_fwd_padding_adds_nothing(op):
    """The padded operands of a ragged Cin and Cout hold the operands
    unchanged and zeros past them; on what the kernel reads of them (Cin
    columns of x, Cin rows of each tap of w, Cout8 columns) the plain
    version gives y with zero columns past Cout and the same statistics
    (up to the f32 summation order of the wider product)."""
    rng = np.random.default_rng(3)
    cin, cout = 36, 70
    x_shape = (37, cin) if op == "pw_conv" else (2, 5, 4, cin)
    w_shape = (cin, cout) if op == "pw_conv" else (3, 3, cin, cout)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).bfloat16()
    s = torch.from_numpy((rng.standard_normal(cin) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.standard_normal(cin) * 0.1).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(w_shape) * 0.1).astype(np.float32)).bfloat16()
    xk, sk, tk, wk, cout8 = tfc._fwd_operands(x, s, t, w)
    assert cout8 == 72 and xk.shape == (x.numel() // cin, 40)
    assert wk.shape == (w.numel() // cout, 72)
    assert not xk[:, cin:].any() and not sk[cin:].any() and not tk[cin:].any()
    assert not wk[:, cout:].any() and torch.equal(wk[:, :cout], w.reshape(-1, cout))
    assert torch.equal(xk[:, :cin], x.reshape(-1, cin)) and torch.equal(sk[:cin], s)
    plain = tfc.pw_conv_plain if op == "pw_conv" else tfc.conv3x3_plain
    y, st = plain(x, s, t, w, True)
    yp, stp = plain(xk[:, :cin].reshape(x_shape), sk[:cin], tk[:cin],
                    wk.reshape(*w_shape[:-1], cout8), True)
    assert not yp[..., cout:].any() and not stp[:, cout:].any()
    torch.testing.assert_close(yp[..., :cout].float(), y.float(), rtol=2.0 ** -7, atol=1e-6)
    torch.testing.assert_close(stp[:, :cout], st, rtol=1e-5, atol=1e-5)


def test_fwd_tiles_split_the_depth_only_where_the_tiles_leave_sms_idle():
    """At ResNet-50's batch-32 shapes the column tile is Cout rounded up to
    64, 128 or 256; the depth is split only where the tiles leave two thirds
    of the SMs idle over at least 32 steps (the 3x3 conv at 7x7 and the
    deepest pointwise conv there), into at most as many blocks as SMs, each
    with at least eight 64-channel steps; batch 1 splits too."""
    sms = 132
    pw = [(64, 64, 56), (64, 256, 56), (256, 64, 56), (256, 128, 28), (128, 512, 28),
          (256, 512, 28), (512, 128, 28), (512, 256, 14), (256, 1024, 14), (512, 1024, 14),
          (1024, 256, 14), (1024, 512, 7), (512, 2048, 7), (1024, 2048, 7), (2048, 512, 7)]
    shapes = ([(32 * hw * hw, ci, co, 1) for ci, co, hw in pw]
              + [(32 * hw * hw, c, c, 9) for c, hw in ((64, 56), (128, 28), (256, 14), (512, 7))])
    split = []
    for m, cin, cout, taps in shapes:
        n, splits = tfc.fwd_tiles(m, cin, cout, taps, sms)
        assert n == (64 if cout <= 64 else 128 if cout <= 128 else 256)
        tiles = -(-m // 128) * -(-cout // n)
        assert tiles * splits <= max(tiles, sms)
        assert splits == 1 or taps * -(-cin // 64) // splits >= 8
        if splits > 1:
            split.append((cin, cout, taps))
    assert split == [(2048, 512, 1), (512, 512, 9)]
    assert tfc.fwd_tiles(1568, 512, 512, 9, sms) == (256, 5)     # 3x3 at 7x7
    assert tfc.fwd_tiles(6272, 256, 256, 9, sms) == (256, 1)     # 3x3 at 14x14
    assert tfc.fwd_tiles(49, 512, 512, 9, sms) == (256, 9)       # batch 1 at 7x7
    assert tfc.fwd_tiles(90, 40, 70, 9, sms) == (128, 1)         # 9 steps: too shallow
