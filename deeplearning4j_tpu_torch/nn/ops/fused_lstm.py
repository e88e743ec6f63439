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
- The host side plans the kernel's tiles (:func:`lstm_tiles`: the hidden
  units and rows a block owns, and the depth split, which depends on the
  widths alone) and how each operand reaches the kernel's stages
  (:func:`lstm_route`: by TMA or 16-byte copies, by 4-byte ``cp.async``,
  or element by element, from its row length and base address).
- The backward is :func:`lstm_cell_bwd`, the reference's ``_cell_bwd_math``
  (an XLA composition, not a Pallas kernel) in plain PyTorch: it recomputes
  the gates from the saved inputs. A CUDA call that records a gradient goes
  through :class:`FusedLstmCell`, an ``autograd.Function`` whose forward
  launches the kernel and whose backward is :func:`lstm_cell_bwd`; a call
  under ``no_grad``/``inference_mode`` launches the kernel alone.
- :func:`cell_for` routes a layer as the reference does: only a
  ``tanh``/``sigmoid`` cell qualifies, and a ``GravesLSTM`` (found by its
  MRO) takes the peepholes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.ops.launch import (  # noqa: F401  (counters re-exported)
    KernelLibrary,
    check_kernel_args,
    launch,
    launch_counts,
    ptrs,
    reset_launch_counts,
    sm_count,
)

OP = "fused_lstm_cell"

_DTYPES = (torch.float32, torch.bfloat16)

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


def lstm_cell_bwd(x, h, c, Wx, Wh, b, peeps, dh, dc) -> Tuple[torch.Tensor, ...]:
    """The cell's backward, the reference's ``_cell_bwd_math``: the gates
    recomputed from the saved inputs, then the standard LSTM cell gradient,
    with JAX's dtype promotion (:func:`_mm`). Returns ``(dx, dh_prev,
    dc_prev, dWx, dWh, db)``, and ``(dpI, dpF, dpO)`` after them with
    peepholes; the parameters' gradients in their parameters' dtypes."""
    pI, pF, pO = peeps if peeps is not None else (None, None, None)
    z = _mm(x, Wx) + _mm(h, Wh) + b
    n = h.shape[-1]
    zi, zf, zo, zg = z[:, :n], z[:, n:2 * n], z[:, 2 * n:3 * n], z[:, 3 * n:]
    if pI is not None:
        i = torch.sigmoid(zi + pI * c)
        f = torch.sigmoid(zf + pF * c)
    else:
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
    g = torch.tanh(zg)
    c_new = f * c + i * g
    o = torch.sigmoid(zo + pO * c_new if pO is not None else zo)
    tanh_c = torch.tanh(c_new)

    do = dh * tanh_c
    dzo = do * o * (1.0 - o)
    dc_t = dc + dh * o * (1.0 - tanh_c * tanh_c)
    if pO is not None:
        dc_t = dc_t + dzo * pO
    di = dc_t * g
    df = dc_t * c
    dg = dc_t * i
    dzi = di * i * (1.0 - i)
    dzf = df * f * (1.0 - f)
    dzg = dg * (1.0 - g * g)
    dc_prev = dc_t * f
    if pI is not None:
        dc_prev = dc_prev + dzi * pI + dzf * pF
    dz = torch.cat([dzi, dzf, dzo, dzg], dim=1)
    dx = _mm(dz, Wx.t())
    dh_prev = _mm(dz, Wh.t())
    dWx = _mm(x.t(), dz)
    dWh = _mm(h.t(), dz)
    db = torch.sum(dz, dim=0)
    out = (dx, dh_prev, dc_prev, dWx.to(Wx.dtype), dWh.to(Wh.dtype), db.to(b.dtype))
    if pI is not None:
        return out + (torch.sum(dzi * c, dim=0).to(pI.dtype),
                      torch.sum(dzf * c, dim=0).to(pF.dtype),
                      torch.sum(dzo * c_new, dim=0).to(pO.dtype))
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
_LIB = KernelLibrary("fused_lstm", {"dl4j_fused_lstm_cell": (11, 12)},
                     "dl4j_fused_lstm_tile", tile_keys="dws")

#: the kernel's depth split (``csrc/fused_lstm.cu`` D and WARPS; the card
#: tests hold them to the library's tile query): stages of STAGE_DEPTH
#: depths of [x | h], the x stages first; warp w of DEPTH_WARPS sums depths
#: [w d, (w + 1) d) of every stage, d = STAGE_DEPTH / DEPTH_WARPS, and the
#: warps' sums are added in warp order
STAGE_DEPTH, DEPTH_WARPS = 128, 8

#: a block's hidden units (all four gates) and rows; 4 units of bf16 would
#: make a TMA box row of 8 bytes, under its 16
UNITS_F32, UNITS_BF16, ROWS = (4, 8), (8,), (8, 16, 32)

#: how an operand reaches the kernel's stages: the weights by TMA and the
#: rows of x and h by 16-byte ``cp.async`` (ROUTE_WIDE), by 4-byte
#: ``cp.async`` (ROUTE_WORDS), or by loads and shared stores (ROUTE_ELEMENTS)
ROUTE_WIDE, ROUTE_WORDS, ROUTE_ELEMENTS = 0, 1, 2


class LstmTiles(NamedTuple):
    units: int        # hidden units a block, with all four gates
    rows: int         # rows of x a block
    depth: int        # depths of [x | h] a stage
    x_stages: int     # stages over Wx and x, then
    h_stages: int     # stages over Wh and h
    warp_depths: int  # depths of each stage one warp sums, warps in order


@functools.lru_cache(maxsize=256)
def lstm_tiles(b: int, n_in: int, n: int, w_bf16: bool, sms: int) -> LstmTiles:
    """The kernel's plan for ``b`` rows of a cell of widths ``n_in`` and
    ``n``: among the tiles (units, rows) whose grid of ceil(n / units) x
    ceil(b / rows) blocks fits one wave (one block an SM), the one with the
    least work a block (units x rows), among equals the most units: the
    weights come by TMA, which moves bytes more cheaply than the rows'
    copies, so a block of more units and fewer rows is faster, though it
    reads the weights once more from L2 (PERF.md § 6, PR 17); where none
    fits, the largest tile. The depth split comes from the widths alone,
    never from ``b`` or the tile: a row's summation order is the same in
    every batch."""
    best = None
    for units in (UNITS_BF16 if w_bf16 else UNITS_F32):
        for rows in ROWS:
            blocks = -(-n // units) * -(-b // rows)
            work = units * rows if blocks <= sms else -units * rows
            cost = (blocks > sms, work, -units, -rows)
            if best is None or cost < best[0]:
                best = (cost, units, rows)
    return LstmTiles(best[1], best[2], STAGE_DEPTH, -(-n_in // STAGE_DEPTH),
                     -(-n // STAGE_DEPTH), STAGE_DEPTH // DEPTH_WARPS)


def lstm_route(row_bytes: int, address: int) -> int:
    """How an operand whose rows are ``row_bytes`` long, first byte at
    ``address``, reaches the kernel's stages: ROUTE_WIDE when every row
    starts on a 16-byte boundary (what a TMA map's strides and a 16-byte
    copy need), else ROUTE_WORDS on 4-byte boundaries, else ROUTE_ELEMENTS
    (bf16 rows of an odd length)."""
    if row_bytes % 16 == 0 and address % 16 == 0:
        return ROUTE_WIDE
    if row_bytes % 4 == 0 and address % 4 == 0:
        return ROUTE_WORDS
    return ROUTE_ELEMENTS


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
    bf = torch.bfloat16
    plan = lstm_tiles(batch, n_in, n, wdt == bf, sm_count(x.device.index or 0))
    operands = ptrs(x, h, c, Wx, Wh, b)
    px, ph, _, pwx, pwh, _ = operands
    w_row = n * Wx.element_size()
    routes = (max(lstm_route(w_row, pwx), lstm_route(w_row, pwh)),
              lstm_route(n_in * x.element_size(), px), lstm_route(n * h.element_size(), ph))
    p = ptrs(*peeps) if peeps is not None else (0, 0, 0)
    with torch.cuda.device(x.device):
        launch(lib.dl4j_fused_lstm_cell, OP,
               (*operands, *p, *ptrs(h_new, c_new),
                batch, n_in, n, int(x.dtype == bf), int(wdt == bf), int(sdt == bf),
                int(peeps is not None), plan.units, plan.rows, *routes))
    return h_new, c_new


class FusedLstmCell(torch.autograd.Function):
    """The cell on the card with a gradient: the forward launches the kernel
    and saves its inputs, the backward is :func:`lstm_cell_bwd` on them (the
    reference's ``custom_vjp``). ``apply(x, h, c, Wx, Wh, b[, pI, pF,
    pO])``."""

    @staticmethod
    def forward(ctx, x, h, c, Wx, Wh, b, *peeps):
        ctx.save_for_backward(x, h, c, Wx, Wh, b, *peeps)
        return _kernel(x, h, c, Wx, Wh, b, peeps or None)

    @staticmethod
    def backward(ctx, dh, dc):
        x, h, c, Wx, Wh, b, *peeps = ctx.saved_tensors
        # each gradient comes back in its input's dtype (autograd casts dx,
        # dh and dc as the reference's cotangents are cast)
        return lstm_cell_bwd(x, h, c, Wx, Wh, b, tuple(peeps) or None, dh, dc)


def fused_lstm_cell(x, h, c, Wx, Wh, b, pI=None, pF=None, pO=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step -> ``(h', c')``; peepholes (GravesLSTM) when
    ``pI``/``pF``/``pO`` are given. A CPU ``x`` takes the plain version
    (autograd differentiates it); a CUDA ``x`` the kernel (contiguous
    f32/bf16 operands, ``h`` and ``c`` of one dtype, the weights of one
    dtype), or it raises. Where a gradient is recorded the CUDA call goes
    through :class:`FusedLstmCell` (the kernel forward, the plain
    backward)."""
    if x.device.type == "cpu":
        return reference_lstm_cell(x, h, c, Wx, Wh, b, pI, pF, pO)
    peeps = () if pI is None else (pI, pF, pO)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, c, Wx, Wh, b, *peeps)):
        return FusedLstmCell.apply(x, h, c, Wx, Wh, b, *peeps)
    return _kernel(x, h, c, Wx, Wh, b, peeps or None)


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
