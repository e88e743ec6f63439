"""Fused conv+BN+ReLU ops: hand-written CUDA kernels for Hopper, forward and
backward, each beside its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/fused_conv.py``. Both ops
compute::

    y, stats = conv(act(x * scale + shift), W)

``scale``/``shift`` are the upstream BatchNormalization's folded per-channel
affine (f32), ``act`` is ReLU when ``relu_in``, and ``stats`` (2, Cout) f32
is ``[colsum(y); colsum(y*y)]`` over the valid rows, taken before ``y`` is
rounded to its storage type.

- :func:`pw_conv` is the 1x1 stride-1 conv on ``x (M, Cin)`` with
  ``w (Cin, Cout)``.
- :func:`conv3x3` is the 3x3 SAME stride-1 conv on NHWC ``x (N, H, W, Cin)``
  with HWIO ``w (3, 3, Cin, Cout)``.

Both are ``torch.autograd.Function`` s, as the reference's are
``jax.custom_vjp`` s: the forward saves ``(x, scale, shift, w, y)`` (``y`` in
its storage type, bf16 on the kernel path) and the backward takes both
cotangents ``(dy, dstats)``, so the gradient of a downstream BN reaches the
conv through its statistics.

Dispatch: a CPU tensor goes to the plain versions (``*_plain``). A CUDA
tensor goes to the kernels (bf16 in and out, f32 accumulation), or the
wrapper raises: there is no fallback. Every kernel is a Hopper design (TMA
tile loads, wgmma): a Cin, Cout or base their TMA loads cannot read reaches
them through :func:`tma_rows`, a zero-padded layout copy for the same
kernel. Each launch
adds one to ``launch_counts[name]`` (``launch.py``, shared with the int8
matmul):

=============  =========================  ====================================
name           kernel (csrc/)             replaces (JAX ``fused_conv.py``)
=============  =========================  ====================================
``pw_conv``    ``fused_conv.cu``          ``_pw_fwd_kernel``
``conv3x3``    ``fused_conv.cu``          ``_c3_fwd_kernel``
``pw_conv_dx`` ``fused_conv_bwd.cu``      ``_pw_bwd_dx_kernel``
``pw_conv_dw`` ``fused_conv_bwd.cu``      ``_pw_bwd_dw_kernel``
``conv3x3_dx`` ``fused_conv_bwd.cu``      ``_c3_bwd_dx_kernel``
``conv3x3_dw`` ``fused_conv_bwd.cu``      ``_c3_bwd_dw_kernel``
=============  =========================  ====================================
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.ops.launch import (  # noqa: F401 (re-exported)
    KernelLaunchError,
    KernelLibrary,
    check_kernel_args as _check_kernel_args,
    launch as _launch,
    launch_counts,
    ptrs as _ptrs,
    reset_launch_counts,
    sm_count as _sm_count,
)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the oracle the kernels are held to)
# ---------------------------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type: f32 (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def _fold(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          relu_in: bool) -> torch.Tensor:
    """The input fold in f32: upstream normalize + ReLU. The ReLU is a
    maximum with 0 whose gradient at a tie is 0.5, as ``jnp.maximum``'s
    (``clamp_min`` would give 1 and ``relu`` 0)."""
    u = x.to(_acc(x.dtype)) * scale + shift
    if relu_in:
        u = torch.maximum(u, torch.zeros_like(u))
    return u


def pw_conv_plain(x, scale, shift, w, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the :func:`pw_conv` forward. Follows ``x.dtype`` as
    the JAX ``pw_conv_reference`` does: the folded input is rounded to
    ``x.dtype``, the product accumulates in f32 (bf16 products are exact in
    f32), the statistics come from the f32 result and ``y`` is stored in
    ``x.dtype``."""
    acc = _acc(x.dtype)
    xn = _fold(x, scale, shift, relu_in).to(x.dtype)
    y = xn.to(acc) @ w.to(acc)
    stats = torch.stack([y.sum(0), (y * y).sum(0)])
    return y.to(x.dtype), stats


def conv3x3_plain(x, scale, shift, w, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the :func:`conv3x3` forward, as the JAX
    ``conv3x3_reference``: the folded input rounded to ``x.dtype`` (the SAME
    halo is zero after the fold), an f32 convolution, statistics from the
    f32 result."""
    acc = _acc(x.dtype)
    xn = _fold(x, scale, shift, relu_in).to(x.dtype).to(acc)
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    stats = torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    return y.to(x.dtype).contiguous(), stats


def _dz_eff(x, z, dz, dst) -> torch.Tensor:
    """``dz + dst[0] + 2*z*dst[1]`` in f32, rounded to ``x.dtype`` (bf16 on
    the kernel path) and widened back: the statistics' cotangent folded into
    ``y``'s, as the Pallas backward kernels form it."""
    acc = _acc(x.dtype)
    g = dz.to(acc) + dst[0] + 2.0 * z.to(acc) * dst[1]
    return g.to(x.dtype).to(acc)


def _input_grads(x, scale, shift, dxn, relu_in, dims):
    """dxn (the gradient of the folded input) -> (dx, dscale, dshift).
    The ReLU mask is ``u > 0``, as the Pallas kernels have it."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    u = xf * scale + shift
    du = torch.where(u > 0, dxn, torch.zeros_like(dxn)) if relu_in else dxn
    return (du * scale).to(x.dtype), (du * xf).sum(dims), du.sum(dims)


def pw_conv_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """Plain version of the ``pw_conv_dx`` kernel (``_pw_bwd_dx_kernel``):
    ``(dx, dscale, dshift)``; ``dxn = dz_eff @ W^T`` accumulated in f32."""
    dxn = _dz_eff(x, z, dz, dst) @ w.to(_acc(x.dtype)).T
    return _input_grads(x, scale, shift, dxn, relu_in, 0)


def pw_conv_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """Plain version of the ``pw_conv_dw`` kernel (``_pw_bwd_dw_kernel``):
    ``dW = xn^T @ dz_eff`` over bf16-rounded operands, accumulated in f32,
    rounded to ``w.dtype``."""
    acc = _acc(x.dtype)
    xn = _fold(x, scale, shift, relu_in).to(x.dtype).to(acc)
    return (xn.T @ _dz_eff(x, z, dz, dst)).to(w.dtype)


def conv3x3_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """Plain version of the ``conv3x3_dx`` kernel (``_c3_bwd_dx_kernel``):
    the transposed SAME conv of ``dz_eff`` (taps flipped; dz_eff is zero
    outside the image), then the mask and scale of :func:`_input_grads`."""
    wf = w.to(_acc(x.dtype)).flip(0, 1).permute(2, 3, 0, 1)   # (Cin, Cout, 3, 3)
    dxn = F.conv2d(_dz_eff(x, z, dz, dst).permute(0, 3, 1, 2), wf,
                   padding=1).permute(0, 2, 3, 1)
    return _input_grads(x, scale, shift, dxn, relu_in, (0, 1, 2))


def conv3x3_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """Plain version of the ``conv3x3_dw`` kernel (``_c3_bwd_dw_kernel``):
    nine ``Cin x Cout`` products of the zero-halo folded input, shifted by
    the tap, with ``dz_eff`` over all pixels."""
    acc = _acc(x.dtype)
    n, h, wd, cin = x.shape
    xn = _fold(x, scale, shift, relu_in).to(x.dtype).to(acc)
    xp = F.pad(xn, (0, 0, 1, 1, 1, 1))
    g = _dz_eff(x, z, dz, dst).reshape(-1, w.shape[3])
    dw = torch.stack([
        torch.stack([xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, cin).T @ g
                     for dx in range(3)])
        for dy in range(3)])
    return dw.to(w.dtype)


def pw_conv_bwd_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """The whole pointwise backward, ``(dx, dscale, dshift, dW)``: the math
    of the JAX ``_pw_bwd_rule``."""
    return (*pw_conv_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in),
            pw_conv_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in))


def conv3x3_bwd_plain(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """The whole 3x3 backward, ``(dx, dscale, dshift, dW)``: the math of the
    JAX ``_c3_bwd_rule``."""
    return (*conv3x3_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in),
            conv3x3_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

#: tiles of the forward: "m" rows of a block (its partials have one row per
#: row block), "n" the widest column tile, "k" input channels per step
_FWD = KernelLibrary("fused_conv",
                     {"dl4j_pw_conv_fwd": (8, 6), "dl4j_conv3x3_fwd": (8, 8)},
                     "dl4j_fused_conv_tile")
#: tiles of the backward: "m" rows of a 3x3 dx block, "p" rows of a
#: pointwise dx block (each dx kernel's partials have one row per row
#: block: they are sized by the key, not by a constant), "c" dW rows of a
#: block (input channels of a pointwise dW block, two 64-row panels of the
#: 3x3's (tap, Cin) rows), "s" pixels of a dW stage
_BWD = KernelLibrary("fused_conv_bwd", {
    "dl4j_pw_conv_bwd_dx": (10, 5), "dl4j_conv3x3_bwd_dx": (10, 9),
    "dl4j_pw_conv_bwd_dw": (8, 8), "dl4j_conv3x3_bwd_dw": (8, 10)},
    "dl4j_fused_conv_bwd_tile", tile_keys="mpcs")
#: TMA reads 16-byte aligned bases and row strides (8 bf16)
_TMA_ALIGN = 16


def _geometry(op: str, x, w):
    """(pointwise?, pixel count, Cin, Cout, the kernel's geometry ints) of
    the op's x and w; raises on a rank or shape the op does not take."""
    pointwise = op.startswith("pw_conv")
    if x.dim() != (2 if pointwise else 4):
        raise ValueError(f"{op}: x must have rank {2 if pointwise else 4}, "
                         f"got {tuple(x.shape)}")
    cin = x.shape[-1]
    w_rank = 2 if pointwise else 4
    if w.dim() != w_rank or tuple(w.shape[:-1]) != ((cin,) if pointwise else (3, 3, cin)):
        want = f"({cin}, Cout)" if pointwise else f"(3, 3, {cin}, Cout)"
        raise ValueError(f"{op}: w must be {want}, got {tuple(w.shape)}")
    cout = w.shape[-1]
    m = x.numel() // cin if cin else 0
    dims = (m,) if pointwise else tuple(x.shape[:3])
    return pointwise, m, cin, cout, dims


def fwd_tiles(m: int, cin: int, cout: int, taps: int, sms: int,
              rows: int = 128, depth: int = 64) -> Tuple[int, int]:
    """``(n, splits)`` of the forward kernel: its column tile ``n`` is Cout
    rounded up to 64, 128 or 256 (the grid covers a wider Cout in such
    tiles); when the ``rows``-row x ``n`` tiles would leave two thirds of
    the SMs idle over a depth of at least 32 steps (taps x Cin in steps of
    ``depth`` channels: the 3x3 convs of the 7x7 stage, the deepest
    pointwise ones, small batches), ``splits`` blocks share each tile's
    depth, at least eight steps each, and a second kernel adds their f32
    sums in split order. A shallower depth does not repay the workspace."""
    n = 64 if cout <= 64 else 128 if cout <= 128 else 256
    tiles = -(-m // rows) * -(-cout // n)
    steps = taps * -(-cin // depth)
    if 3 * tiles > sms or steps < 32:
        return n, 1
    return n, min(sms // tiles, steps // 8)


def _tma_vector(v: torch.Tensor, n: int) -> torch.Tensor:
    """A contiguous f32 (..., c) vector (or stack of them) as the Hopper
    kernels' bulk copies read it: ``v`` itself when c is ``n`` and its base
    16-byte aligned, else a copy zero-padded to (..., n)."""
    if v.shape[-1] == n and v.data_ptr() % _TMA_ALIGN == 0:
        return v
    return F.pad(v, (0, n - v.shape[-1]))


def _fwd_operands(x, scale, shift, w):
    """(x, scale, shift, w, Cout8) as the forward kernel reads them: x as an
    (M, Cin8) matrix and w as a (taps * Cin, Cout8) one (Cin and Cout rounded
    up to a multiple of 8, TMA's 16-byte row stride; the kernel's maps stop
    at Cin and Cout, so the padded columns are never read), scale and shift
    with Cin8 entries (the kernel masks the channels past Cin), each 16-byte
    aligned: the operands themselves where they are so (contiguous, as the
    wrapper checked), else a padded layout copy."""
    cin, cout = w.shape[-2], w.shape[-1]
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    if cin8 != cin or x.data_ptr() % _TMA_ALIGN:
        x = tma_rows(x.reshape(-1, cin), cin8)
    if cout8 != cout or w.data_ptr() % _TMA_ALIGN:
        w = tma_rows(w.reshape(-1, cout), cout8)
    return x, _tma_vector(scale, cin8), _tma_vector(shift, cin8), w, cout8


def _fused_fwd(op: str, x, scale, shift, w, relu_in: bool):
    """The forward kernel of ``op`` ("pw_conv" or "conv3x3"). y is written
    with row stride Cout8: a ragged Cout drops y's padding after the
    launch. A depth split (:func:`fwd_tiles`) takes an f32 workspace of
    (splits, M, Cout8)."""
    pointwise, m, cin, cout, dims = _geometry(op, x, w)
    _check_kernel_args(op, x, (
        ("x", x, torch.bfloat16, x.shape), ("w", w, torch.bfloat16, w.shape),
        ("scale", scale, torch.float32, (cin,)),
        ("shift", shift, torch.float32, (cin,))))
    y_shape = (*x.shape[:-1], cout)
    if m == 0:
        return (torch.empty(y_shape, dtype=torch.bfloat16, device=x.device),
                torch.zeros((2, cout), dtype=torch.float32, device=x.device))
    lib = _FWD.get()
    with torch.cuda.device(x.device):
        xk, sk, tk, wk, cout8 = _fwd_operands(x, scale, shift, w)
        n, splits = fwd_tiles(m, cin, cout, 1 if pointwise else 9,
                              _sm_count(x.device.index or 0), _FWD.tile["m"],
                              _FWD.tile["k"])
        y = torch.empty((*y_shape[:-1], cout8), dtype=torch.bfloat16, device=x.device)
        partial = torch.empty((-(-m // _FWD.tile["m"]), 2, cout),
                              dtype=torch.float32, device=x.device)
        stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
        ws = (torch.empty((splits, m, cout8), dtype=torch.float32, device=x.device)
              if splits > 1 else stats)
        fn = lib.dl4j_pw_conv_fwd if pointwise else lib.dl4j_conv3x3_fwd
        _launch(fn, op, (*_ptrs(xk, sk, tk, wk, y, partial, stats, ws),
                         *dims, cin, cout, int(bool(relu_in)), n, splits))
        if cout8 != cout:
            y = y[..., :cout].contiguous()
    return y, stats


def _check_bwd_args(op, x, scale, shift, w, z, dz, dst):
    pointwise, m, cin, cout, dims = _geometry(op, x, w)
    y_shape = (*x.shape[:-1], cout)
    _check_kernel_args(op, x, (
        ("x", x, torch.bfloat16, x.shape), ("w", w, torch.bfloat16, w.shape),
        ("scale", scale, torch.float32, (cin,)),
        ("shift", shift, torch.float32, (cin,)),
        ("z", z, torch.bfloat16, y_shape), ("dz", dz, torch.bfloat16, y_shape),
        ("dst", dst, torch.float32, (2, cout))))
    return pointwise, m, cin, cout, dims


def tma_rows(t: torch.Tensor, cols: int) -> torch.Tensor:
    """A contiguous (rows, c) bf16 matrix as the Hopper kernels' TMA loads
    read it: ``t`` itself when its base is 16-byte aligned and ``c ==
    cols``, else a copy into a zero-filled (rows, cols) buffer (the layout
    copy for a ragged Cin or Cout or a misaligned view; the same kernel)."""
    if t.shape[1] == cols and t.data_ptr() % _TMA_ALIGN == 0:
        return t
    out = t.new_zeros((t.shape[0], cols))
    out[:, :t.shape[1]].copy_(t)
    return out


def _dx_operands(x, w, z, dz, dst):
    """(x, w, z, dz, dst, Cout8) as the dx kernels read them: x, z and dz as
    :func:`_dw_operands` gives them, w as (taps * Cin, Cout8) rows (the
    3x3's kernel reads them through a 3-D map of (Cout, Cin, 9)) and dst as
    (2, Cout8), zero past Cout, so padded columns add nothing to ``dz_eff
    W^T`` (x's are never read: dx takes x's padded width, and its padding is
    dropped after the launch)."""
    cout8 = -(-w.shape[-1] // 8) * 8
    x, z, dz = _dw_operands(x, z, dz)
    w = tma_rows(w if w.dim() == 2 else w.reshape(-1, w.shape[-1]), cout8)
    return x, w, z, dz, _tma_vector(dst, cout8), cout8


def c3_dx_tiles(cin: int) -> int:
    """The column tile ``n`` of the 3x3 dx kernel: 64 for a Cin of at most
    64, else 128. A block forms the same dz_eff, over the same nine-tap
    depth, whatever its ``n``: narrower tiles form it more often, wider ones
    fill fewer SMs. Measured on an H100 at ResNet-50's batch-32 shapes
    (PERF.md), 128 beat 64 wherever Cin > 64, and 256 lost at every shape."""
    return 64 if cin <= 64 else 128


def _fused_bwd_dx(op: str, x, scale, shift, w, z, dz, dst, relu_in: bool):
    """The dx kernel of ``op`` ("pw_conv_dx" or "conv3x3_dx"):
    ``(dx, dscale, dshift)``."""
    pointwise, m, cin, cout, dims = _check_bwd_args(op, x, scale, shift, w, z, dz, dst)
    if m == 0:
        zeros = torch.zeros((cin,), dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    lib = _BWD.get()
    relu = int(bool(relu_in))
    with torch.cuda.device(x.device):
        rows = _BWD.tile["p" if pointwise else "m"]
        partial = torch.empty((-(-m // rows), 2, cin), dtype=torch.float32, device=x.device)
        gst = torch.empty((2, cin), dtype=torch.float32, device=x.device)
        # dx is written by TMA: it takes x's padded row stride
        xk, wk, zk, dzk, dstk, cout8 = _dx_operands(x, w, z, dz, dst)
        dx = torch.empty_like(xk)
        if pointwise:
            fn, ints = lib.dl4j_pw_conv_bwd_dx, (m, cin, cout8, xk.shape[1], relu)
        else:
            n = c3_dx_tiles(cin)
            fn, ints = lib.dl4j_conv3x3_bwd_dx, (*dims, cin, cout, xk.shape[1], cout8, relu, n)
        _launch(fn, op, (*_ptrs(xk, scale, shift, wk, zk, dzk, dstk, dx, partial, gst), *ints))
        if dx.shape[-1] != cin:
            dx = dx[:, :cin].contiguous()
    return dx.reshape(x.shape), gst[0], gst[1]


def _dw_chunks(m: int, cout: int, row_tiles: int, sms: int, step: int
               ) -> Tuple[int, int, int]:
    """``(n, chunk, splits)`` of a dW kernel whose blocks own one of
    ``row_tiles`` row tiles by ``n`` output channels (Cout rounded up to 64,
    128 or 256; the grid covers a wider Cout in such tiles) over one chunk
    of the ``m`` pixels: ``chunk`` is a whole number of ``step``-pixel
    stages, and the ``splits`` chunks cover every pixel once. The chunks are
    as long as one wave of blocks allows (two blocks an SM at n 64, one
    otherwise): fewer, longer chunks keep the ring full and the f32
    partials (splits, rows, Cout) small."""
    n = 64 if cout <= 64 else 128 if cout <= 128 else 256
    tiles = row_tiles * -(-cout // n)
    blocks = (2 if n == 64 else 1) * sms
    splits = max(1, min(-(-m // step), blocks // tiles))
    chunk = -(-(-(-m // splits)) // step) * step
    return n, chunk, -(-m // chunk)


def pw_dw_tiles(m: int, cin: int, cout: int, sms: int, rows: int = 128,
                step: int = 32) -> Tuple[int, int, int]:
    """``(n, chunk, splits)`` of the pointwise dW kernel: a block owns
    ``rows`` input channels (the grid covers a wider Cin in such tiles);
    the rest as :func:`_dw_chunks`."""
    return _dw_chunks(m, cout, -(-cin // rows), sms, step)


def c3_dw_tiles(m: int, cin: int, cout: int, sms: int, rows: int = 128,
                step: int = 32) -> Tuple[int, int, int]:
    """``(n, chunk, splits)`` of the 3x3 dW kernel. Its rows are dW's (tap,
    Cin) rows in panels of ``rows / 2`` that never straddle a tap
    (``ceil(Cin / 64)`` a tap), and a block owns two neighbouring panels;
    the rest as :func:`_dw_chunks`."""
    panels = 9 * -(-cin // (rows // 2))
    return _dw_chunks(m, cout, -(-panels // 2), sms, step)


def _dw_operands(x, z, dz):
    """(x, z, dz) as the backward kernels' TMA loads read them: (M, Cin8)
    and (M, Cout8) rows (Cin and Cout rounded up to a multiple of 8, TMA's
    16-byte row stride; the 3x3's NHWC tensors as their pixel rows),
    16-byte aligned: the tensors themselves (or views of them) where they
    are so, else a copy whose padded columns are zero (the dW kernels'
    maps stop at Cin and Cout and never read them)."""
    rows = lambda t: t if t.dim() == 2 else t.reshape(-1, t.shape[-1])  # noqa: E731
    cin, cout = x.shape[-1], z.shape[-1]
    return (tma_rows(rows(x), -(-cin // 8) * 8), tma_rows(rows(z), -(-cout // 8) * 8),
            tma_rows(rows(dz), -(-cout // 8) * 8))


def _fused_bwd_dw(op: str, x, scale, shift, w, z, dz, dst, relu_in: bool):
    """The dW kernel of ``op`` ("pw_conv_dw" or "conv3x3_dw"): dW in bf16.
    Each split of the pixels writes an f32 (Cin, Cout) slice of the
    partials (nine of them for the 3x3), and the kernel's second pass sums
    the splits in a fixed order; the 3x3 kernel with one split stores dW
    itself and takes no partials."""
    pointwise, m, cin, cout, dims = _check_bwd_args(op, x, scale, shift, w, z, dz, dst)
    if m == 0:
        return torch.zeros_like(w)
    lib = _BWD.get()
    sms = _sm_count(x.device.index or 0)
    with torch.cuda.device(x.device):
        dw = torch.empty_like(w)
        plan = pw_dw_tiles if pointwise else c3_dw_tiles
        n, chunk, splits = plan(m, cin, cout, sms, _BWD.tile["c"], _BWD.tile["s"])
        x, z, dz = _dw_operands(x, z, dz)
        shape = ((splits, cin, cout) if pointwise
                 else (splits if splits > 1 else 0, 9, cin, cout))
        partial = torch.empty(shape, dtype=torch.float32, device=x.device)
        fn = lib.dl4j_pw_conv_bwd_dw if pointwise else lib.dl4j_conv3x3_bwd_dw
        _launch(fn, op, (*_ptrs(x, scale, shift, z, dz, dst, partial, dw), *dims, cin, cout,
                         x.shape[1], z.shape[1], int(bool(relu_in)), n, chunk))
    return dw


# ---------------------------------------------------------------------------
# wrappers: the plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------


def pw_conv_fwd(x, scale, shift, w, relu_in: bool = False):
    """Pointwise forward: ``(y, stats)``. x (M, Cin) bf16; scale/shift
    (Cin,) f32; w (Cin, Cout) bf16 -> y (M, Cout) bf16, stats (2, Cout) f32."""
    if x.device.type == "cpu":
        return pw_conv_plain(x, scale, shift, w, relu_in)
    return _fused_fwd("pw_conv", x, scale, shift, w, relu_in)


def conv3x3_fwd(x, scale, shift, w, relu_in: bool = False):
    """3x3 forward with the contract of :func:`pw_conv_fwd`; x (N, H, W,
    Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, scale, shift, w, relu_in)
    return _fused_fwd("conv3x3", x, scale, shift, w, relu_in)


def pw_conv_bwd_dx(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """``(dx, dscale, dshift)`` of :func:`pw_conv`; z/dz (M, Cout) bf16,
    dst (2, Cout) f32."""
    if x.device.type == "cpu":
        return pw_conv_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in)
    return _fused_bwd_dx("pw_conv_dx", x, scale, shift, w, z, dz, dst, relu_in)


def pw_conv_bwd_dw(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """dW (Cin, Cout) of :func:`pw_conv`, in ``w.dtype``."""
    if x.device.type == "cpu":
        return pw_conv_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in)
    return _fused_bwd_dw("pw_conv_dw", x, scale, shift, w, z, dz, dst, relu_in)


def conv3x3_bwd_dx(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """``(dx, dscale, dshift)`` of :func:`conv3x3`; z/dz (N, H, W, Cout)."""
    if x.device.type == "cpu":
        return conv3x3_bwd_dx_plain(x, scale, shift, w, z, dz, dst, relu_in)
    return _fused_bwd_dx("conv3x3_dx", x, scale, shift, w, z, dz, dst, relu_in)


def conv3x3_bwd_dw(x, scale, shift, w, z, dz, dst, relu_in: bool = False):
    """dW (3, 3, Cin, Cout) of :func:`conv3x3`, in ``w.dtype``."""
    if x.device.type == "cpu":
        return conv3x3_bwd_dw_plain(x, scale, shift, w, z, dz, dst, relu_in)
    return _fused_bwd_dw("conv3x3_dw", x, scale, shift, w, z, dz, dst, relu_in)


_OPS = {"pw": (pw_conv_fwd, pw_conv_bwd_dx, pw_conv_bwd_dw),
        "c3": (conv3x3_fwd, conv3x3_bwd_dx, conv3x3_bwd_dw)}


class _FusedConv(torch.autograd.Function):
    """The differentiable op (``jax.custom_vjp`` in the reference): residuals
    ``(x, scale, shift, w, y)`` as ``_pw_fwd_rule``/``_c3_fwd_rule`` keep
    them, cotangents ``(dy, dstats)``."""

    @staticmethod
    def forward(ctx, op, x, scale, shift, w, relu_in):
        y, stats = _OPS[op][0](x, scale, shift, w, relu_in)
        ctx.save_for_backward(x, scale, shift, w, y)
        ctx.op, ctx.relu_in = op, relu_in
        return y, stats

    @staticmethod
    def backward(ctx, dy, dstats):
        x, scale, shift, w, z = ctx.saved_tensors
        _, bwd_dx, bwd_dw = _OPS[ctx.op]
        args = (x, scale, shift, w, z, dy.contiguous(), dstats.contiguous(),
                ctx.relu_in)
        need = ctx.needs_input_grad
        dx = ds = dt = dw = None
        if any(need[1:4]):
            dx, ds, dt = bwd_dx(*args)
        if need[4]:
            dw = bwd_dw(*args)
        return (None, dx if need[1] else None, ds if need[2] else None,
                dt if need[3] else None, dw, None)


def pw_conv(x, scale, shift, w, relu_in: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pointwise conv: ``(y, stats) = 1x1conv(act(x*scale+shift), w)``,
    differentiable in x, scale, shift and w.

    x: (M, Cin) bf16; scale/shift: (Cin,) f32; w: (Cin, Cout) bf16.
    Returns y (M, Cout) bf16 and stats (2, Cout) f32."""
    return _FusedConv.apply("pw", x, scale, shift, w, bool(relu_in))


def conv3x3(x, scale, shift, w, relu_in: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 3x3 SAME stride-1 conv with the contract of :func:`pw_conv`.

    x: (N, H, W, Cin) bf16 NHWC; w: (3, 3, Cin, Cout) bf16 HWIO."""
    return _FusedConv.apply("c3", x, scale, shift, w, bool(relu_in))
