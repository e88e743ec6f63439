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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
