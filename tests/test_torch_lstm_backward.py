"""The fused LSTM cell's backward (``nn/ops/fused_lstm.py``) against the JAX
package on the CPU.

- ``lstm_cell_bwd`` equals JAX's ``_cell_bwd_math`` (the backward of JAX's
  ``custom_vjp`` cell) within 1e-6 in f32, relative to each gradient's
  largest element, with and without peepholes, at ragged widths; in bf16
  within four bf16 rounding steps (2^-5 of the largest element) of JAX's
  bf16 run: both round the chain of ~15 bf16 operations op by op, and each
  lands up to 2.3 steps from the f32 result (measured over four seeds), so
  they differ by up to 3.2 steps, where one step was asked for; the
  parameters' gradients come back in the parameters' dtypes.
- It equals autograd through ``reference_lstm_cell`` in f64 within 1e-12.
- ``FusedLstmCell`` (the ``autograd.Function`` the card runs, its forward a
  stand-in for the kernel here) gives autograd's gradients through the
  plain cell, and ``fused_lstm_cell`` takes it only where a gradient is
  recorded: under ``no_grad`` the kernel alone runs, and a CPU call is the
  plain cell under autograd.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.ops import fused_lstm as jfl
from deeplearning4j_tpu_torch.nn.ops import fused_lstm as tfl

F32_TOL = 1e-6        # f32 gradients, relative to each gradient's largest element
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative
BF16_STEPS = 4        # bf16 gradients against JAX's, in steps of the largest element
F64_TOL = 1e-12
NAMES = ("dx", "dh", "dc", "dWx", "dWh", "db", "dpI", "dpF", "dpO")

# (B, n_in, n): ragged widths, one row, and one wider case
SHAPES = [(3, 5, 7), (1, 4, 2), (8, 33, 16), (16, 40, 24)]


def _operands(b, n_in, n, peephole, seed=0):
    """Seeded numpy operands: x, h in (-1, 1), c N(0, 1), weights at the
    scale of a xavier init, live biases and peepholes, and the incoming
    gradients dh, dc."""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2.0 / (n_in + n))
    ops = [rng.uniform(-1, 1, (b, n_in)), rng.uniform(-1, 1, (b, n)), rng.standard_normal((b, n)),
           rng.standard_normal((n_in, 4 * n)) * std, rng.standard_normal((n, 4 * n)) * std,
           rng.standard_normal(4 * n) * 0.3]
    peeps = [rng.standard_normal(n) * 0.3 for _ in range(3)] if peephole else None
    cts = [rng.standard_normal((b, n)), rng.standard_normal((b, n))]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(a) for a in ops], None if peeps is None else [f32(p) for p in peeps], \
        [f32(a) for a in cts]


def _port(ops, peeps, cts, dtype):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return tfl.lstm_cell_bwd(*[t(a) for a in ops], None if peeps is None
                             else tuple(t(p) for p in peeps), *[t(a) for a in cts])


def _jax(ops, peeps, cts, dtype):
    j = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    return jfl._cell_bwd_math(*[j(a) for a in ops], None if peeps is None
                              else tuple(j(p) for p in peeps), *[j(a) for a in cts])


@pytest.mark.parametrize("peephole", [False, True], ids=["lstm", "graves"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_backward_matches_jax_f32(shape, peephole):
    ops, peeps, cts = _operands(*shape, peephole)
    got, want = _port(ops, peeps, cts, torch.float32), _jax(ops, peeps, cts, jnp.float32)
    assert len(got) == len(want) == (9 if peephole else 6)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g.numpy() - w).max()) <= F32_TOL * scale, name


@pytest.mark.parametrize("peephole", [False, True], ids=["lstm", "graves"])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_matches_jax_bf16(peephole, seed):
    ops, peeps, cts = _operands(8, 33, 16, peephole, seed=seed)
    got, want = _port(ops, peeps, cts, torch.bfloat16), _jax(ops, peeps, cts, jnp.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16, name
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BF16_STEPS * BF16_STEP * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("peephole", [False, True], ids=["lstm", "graves"])
def test_parameter_gradients_take_the_parameters_dtypes(peephole):
    """The compute-dtype flow: bf16 x and weights, f32 carries. The gradients
    of the weights come back bf16, as JAX's casts give them."""
    ops, peeps, cts = _operands(4, 6, 5, peephole, seed=2)
    t = [torch.from_numpy(a) for a in ops]
    t[0], t[3], t[4], t[5] = (a.bfloat16() for a in (t[0], t[3], t[4], t[5]))
    pp = None if peeps is None else tuple(torch.from_numpy(p).bfloat16() for p in peeps)
    got = tfl.lstm_cell_bwd(*t, pp, *[torch.from_numpy(a) for a in cts])
    assert [g.dtype for g in got[3:]] == [torch.bfloat16] * (6 if peephole else 3)
    assert [g.dtype for g in got[:3]] == [torch.float32] * 3


def _autograd(ops, peeps, cts, dtype):
    """(h', c') of the plain cell and autograd's gradients of
    sum(h' dh + c' dc) with respect to every operand."""
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in ops]
    pp = [] if peeps is None else [torch.from_numpy(p).to(dtype).requires_grad_() for p in peeps]
    h2, c2 = tfl.reference_lstm_cell(*ins, *pp)
    dh, dc = (torch.from_numpy(a).to(dtype) for a in cts)
    grads = torch.autograd.grad((h2 * dh).sum() + (c2 * dc).sum(), ins + pp)
    return (h2.detach(), c2.detach()), grads


@pytest.mark.parametrize("peephole", [False, True], ids=["lstm", "graves"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=["x".join(map(str, s)) for s in SHAPES[:2]])
def test_backward_is_autograd_of_the_plain_cell(shape, peephole):
    ops, peeps, cts = _operands(*shape, peephole, seed=3)
    _, want = _autograd(ops, peeps, cts, torch.float64)
    got = _port(ops, peeps, cts, torch.float64)
    for name, g, w in zip(NAMES, got, want):
        assert float((g - w).abs().max()) <= F64_TOL * max(float(w.abs().max()), 1.0), name


def _stand_in(monkeypatch):
    """The kernel replaced by the plain cell (no card here), counting calls."""
    calls = []

    def kernel(x, h, c, Wx, Wh, b, peeps):
        calls.append(peeps is not None)
        return tfl.reference_lstm_cell(x, h, c, Wx, Wh, b, *(peeps or ()))

    monkeypatch.setattr(tfl, "_kernel", kernel)
    return calls


@pytest.mark.parametrize("peephole", [False, True], ids=["lstm", "graves"])
def test_autograd_function_gives_the_plain_cells_gradients(monkeypatch, peephole):
    calls = _stand_in(monkeypatch)
    ops, peeps, cts = _operands(5, 9, 6, peephole, seed=4)
    (hw, cw), want = _autograd(ops, peeps, cts, torch.float32)
    ins = [torch.from_numpy(a).requires_grad_() for a in ops]
    pp = [] if peeps is None else [torch.from_numpy(p).requires_grad_() for p in peeps]
    h2, c2 = tfl.FusedLstmCell.apply(*ins, *pp)
    assert calls == [peephole]
    assert torch.equal(h2, hw) and torch.equal(c2, cw)
    dh, dc = (torch.from_numpy(a) for a in cts)
    got = torch.autograd.grad((h2 * dh).sum() + (c2 * dc).sum(), ins + pp)
    for name, g, w in zip(NAMES, got, want):
        assert float((g - w).abs().max()) <= F32_TOL * max(float(w.abs().max()), 1.0), name


def test_the_cell_routes_by_device_and_gradient(monkeypatch):
    """A CPU call is the plain cell (never the kernel); off the CPU, the
    kernel alone under ``no_grad`` and the autograd function where a
    gradient is recorded ("meta" tensors stand for the card's)."""
    calls = _stand_in(monkeypatch)
    applied = []
    real_apply = tfl.FusedLstmCell.apply
    monkeypatch.setattr(tfl.FusedLstmCell, "apply",
                        lambda *a: applied.append(len(a)) or real_apply(*a))
    ops, peeps, _ = _operands(2, 3, 4, True, seed=5)
    cpu = [torch.from_numpy(a).requires_grad_() for a in ops + peeps]
    tfl.fused_lstm_cell(*cpu)
    assert calls == [] and applied == []
    meta = [torch.empty(a.shape, device="meta").requires_grad_() for a in ops + peeps]
    with torch.no_grad():
        tfl.fused_lstm_cell(*meta)
    assert calls == [True] and applied == []
    h2, c2 = tfl.fused_lstm_cell(*meta[:6])
    assert calls == [True, False] and applied == [6]
    assert h2.requires_grad and c2.requires_grad
