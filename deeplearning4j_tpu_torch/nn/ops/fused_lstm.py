"""Fused LSTM cell: one (Graves)LSTM time step as a hand-written CUDA kernel
for Hopper beside its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/fused_lstm.py``::

    z  = x @ Wx + h @ Wh + b          # (B, 4n): gates [i, f, o, g]
    i  = sig(z_i [+ pI*c]);  f = sig(z_f [+ pF*c]);  g = tanh(z_g)
    c' = f*c + i*g
    o  = sig(z_o [+ pO*c'])
    h' = o*tanh(c')

- :func:`reference_lstm_cell` is the plain version: the reference's
  expressions in the reference's order, with JAX's dtype promotion written
  out (torch refuses a mixed-dtype matmul; JAX promotes a bf16 ``x`` against
  f32 carries to f32). The CPU path and the tests use it.
- :func:`fused_lstm_cell` takes the plain version for a CPU tensor and for a
  CUDA tensor launches the kernel (``csrc/fused_lstm.cu``, which replaces the
  reference's ``_cell_kernel``) or raises: there is no fallback and no probe
  (the availability registry is ROADMAP § B0). Each launch adds one to
  ``launch_counts["fused_lstm_cell"]`` (``launch.py``). Each operand keeps
  its dtype (f32 or bf16); the outputs are bf16 when ``x``, the weights and
  the carries all are, else f32, which is the dtype the reference's
  promotion gives them.
- The backward (the reference's ``_cell_bwd_math``, an XLA composition)
  comes with the recurrent training slice: a CUDA call that would record a
  gradient raises :class:`NotImplementedError`.
- :func:`cell_for` routes a layer as the reference does: only a
  ``tanh``/``sigmoid`` cell qualifies, and a ``GravesLSTM`` (found by its
  MRO) takes the peepholes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.ops.launch import (  # noqa: F401  (counters re-exported)
    KernelLibrary,
    check_kernel_args,
    launch,
    launch_counts,
    ptrs,
    reset_launch_counts,
)

OP = "fused_lstm_cell"

_DTYPES = (torch.float32, torch.bfloat16)

NO_BACKWARD = ("the fused LSTM cell's backward comes with the recurrent "
               "training slice (ROADMAP § A, slice 5: tBPTT and the LSTM "
               "backward); run the forward under torch.no_grad() or "
               "inference_mode()")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion (bf16 against f32 computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# plain version (the CPU path, and the oracle the kernel is held to)
# ---------------------------------------------------------------------------
def reference_lstm_cell(x, h, c, Wx, Wh, b, pI=None, pF=None, pO=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``reference_lstm_cell`` (the exact math of
    ``LSTM._step``/``GravesLSTM._step`` for a tanh/sigmoid cell): same
    expressions, same order."""
    z = _mm(x, Wx) + _mm(h, Wh) + b
    n = h.shape[-1]
    if pI is not None:
        i = torch.sigmoid(z[:, :n] + pI * c)
        f = torch.sigmoid(z[:, n:2 * n] + pF * c)
        g = torch.tanh(z[:, 3 * n:])
        c_new = f * c + i * g
        o = torch.sigmoid(z[:, 2 * n:3 * n] + pO * c_new)
    else:
        i = torch.sigmoid(z[:, :n])
        f = torch.sigmoid(z[:, n:2 * n])
        o = torch.sigmoid(z[:, 2 * n:3 * n])
        g = torch.tanh(z[:, 3 * n:])
        c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
_LIB = KernelLibrary("fused_lstm", {"dl4j_fused_lstm_cell": (11, 7)},
                     "dl4j_fused_lstm_tile", tile_keys="urk")


def output_dtype(x, h, w) -> torch.dtype:
    """The dtype of the kernel's ``h'`` and ``c'``: bf16 when ``x``, the
    weights and the carries are all bf16, else f32."""
    if x.dtype == h.dtype == w.dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _kernel(x, h, c, Wx, Wh, b, peeps) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"{OP}: x must be (B, n_in) and h (B, n), got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    for name, t in (("x", x), ("h", h), ("Wx", Wx)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{OP}: the kernel takes f32 or bf16 {name}, got {t.dtype}")
    batch, n_in = x.shape
    n = h.shape[1]
    wdt, sdt = Wx.dtype, h.dtype
    specs = [("x", x, x.dtype, (batch, n_in)), ("h", h, sdt, (batch, n)),
             ("c", c, sdt, (batch, n)), ("Wx", Wx, wdt, (n_in, 4 * n)),
             ("Wh", Wh, wdt, (n, 4 * n)), ("b", b, wdt, (4 * n,))]
    if peeps is not None:
        specs += [(name, p, wdt, (n,)) for name, p in zip(("pI", "pF", "pO"), peeps)]
    check_kernel_args(OP, x, specs)
    odt = output_dtype(x, h, Wx)
    h_new = torch.empty((batch, n), dtype=odt, device=x.device)
    c_new = torch.empty((batch, n), dtype=odt, device=x.device)
    if batch == 0 or n == 0:
        return h_new, c_new
    if n_in == 0:
        raise ValueError(f"{OP}: the kernel needs n_in >= 1")
    lib = _LIB.get()
    p = ptrs(*peeps) if peeps is not None else (0, 0, 0)
    bf = torch.bfloat16
    with torch.cuda.device(x.device):
        launch(lib.dl4j_fused_lstm_cell, OP,
               (*ptrs(x, h, c, Wx, Wh, b), *p, *ptrs(h_new, c_new),
                batch, n_in, n, int(x.dtype == bf), int(wdt == bf), int(sdt == bf),
                int(peeps is not None)))
    return h_new, c_new


def fused_lstm_cell(x, h, c, Wx, Wh, b, pI=None, pF=None, pO=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step -> ``(h', c')``; peepholes (GravesLSTM) when
    ``pI``/``pF``/``pO`` are given. A CPU ``x`` takes the plain version; a
    CUDA ``x`` the kernel (contiguous f32/bf16 operands, ``h`` and ``c`` of
    one dtype, the weights of one dtype), or it raises. Forward only."""
    if x.device.type == "cpu":
        return reference_lstm_cell(x, h, c, Wx, Wh, b, pI, pF, pO)
    peeps = None if pI is None else (pI, pF, pO)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, c, Wx, Wh, b, *(peeps or ()))):
        raise NotImplementedError(f"{OP}: {NO_BACKWARD}")
    return _kernel(x, h, c, Wx, Wh, b, peeps)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def cell_for(layer) -> Optional[Callable]:
    """The fused cell for ``layer`` (an LSTM/GravesLSTM), or None for the
    layer's own step. As the reference: only ``activation="tanh"`` with
    ``gate_activation="sigmoid"`` qualifies, and a ``GravesLSTM`` (found by
    an MRO walk: importing the layer module here would be a cycle) takes
    peepholes. The reference also keys a probe on dtype and batch; the port
    has no probe (ROADMAP § B0), so the cell is the same for all."""
    if getattr(layer, "activation", None) != "tanh" or \
            getattr(layer, "gate_activation", None) != "sigmoid":
        return None
    if not getattr(layer, "n_in", None) or not getattr(layer, "n_out", None):
        return None
    peephole = any(k.__name__ == "GravesLSTM" for k in type(layer).__mro__)

    def cell(x, h, c, Wx, Wh, b, pI=None, pF=None, pO=None):
        if (pI is not None) != peephole:
            raise ValueError(f"{type(layer).__name__}: the cell "
                             f"{'needs' if peephole else 'takes no'} peepholes")
        return fused_lstm_cell(x, h, c, Wx, Wh, b, pI, pF, pO)

    return cell
