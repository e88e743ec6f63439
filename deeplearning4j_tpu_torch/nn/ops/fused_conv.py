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
wrapper raises: there is no fallback. Each launch adds one to
``launch_counts[name]`` (``launch.py``, shared with the int8 matmul):

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

_FWD = KernelLibrary("fused_conv",
                     {"dl4j_pw_conv_fwd": (7, 4), "dl4j_conv3x3_fwd": (7, 6)},
                     "dl4j_fused_conv_tile")
_BWD = KernelLibrary("fused_conv_bwd", {
    "dl4j_pw_conv_bwd_dx": (10, 4), "dl4j_conv3x3_bwd_dx": (10, 6),
    "dl4j_pw_conv_bwd_dw": (8, 5), "dl4j_conv3x3_bwd_dw": (8, 7)},
    "dl4j_fused_conv_bwd_tile")


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


def _fused_fwd(op: str, x, scale, shift, w, relu_in: bool):
    """The forward kernel of ``op`` ("pw_conv" or "conv3x3")."""
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
        y = torch.empty(y_shape, dtype=torch.bfloat16, device=x.device)
        partial = torch.empty((-(-m // _FWD.tile["m"]), 2, cout),
                              dtype=torch.float32, device=x.device)
        stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
        fn = lib.dl4j_pw_conv_fwd if pointwise else lib.dl4j_conv3x3_fwd
        _launch(fn, op, (*_ptrs(x, scale, shift, w, y, partial, stats),
                         *dims, cin, cout, int(bool(relu_in))))
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


def _fused_bwd_dx(op: str, x, scale, shift, w, z, dz, dst, relu_in: bool):
    """The dx kernel of ``op`` ("pw_conv_dx" or "conv3x3_dx"):
    ``(dx, dscale, dshift)``."""
    pointwise, m, cin, cout, dims = _check_bwd_args(op, x, scale, shift, w, z, dz, dst)
    if m == 0:
        zeros = torch.zeros((cin,), dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    lib = _BWD.get()
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        partial = torch.empty((-(-m // _BWD.tile["m"]), 2, cin),
                              dtype=torch.float32, device=x.device)
        gst = torch.empty((2, cin), dtype=torch.float32, device=x.device)
        fn = lib.dl4j_pw_conv_bwd_dx if pointwise else lib.dl4j_conv3x3_bwd_dx
        _launch(fn, op, (*_ptrs(x, scale, shift, w, z, dz, dst, dx, partial, gst),
                         *dims, cin, cout, int(bool(relu_in))))
    return dx, gst[0], gst[1]


def dw_split(m: int, cin: int, cout: int, taps: int, sms: int,
             tile: int = 64, step: int = 32) -> Tuple[int, int]:
    """``(chunk, splits)``: the dW kernels split the ``m`` pixels of their
    depth into ``splits`` chunks of ``chunk`` pixels (a multiple of the
    depth ``step``), one block per (output tile, tap, chunk), so that about
    two blocks per SM are in flight even when the output is one tile."""
    tiles = -(-cin // tile) * -(-cout // tile) * taps
    splits = max(1, min(-(-m // step), -(-2 * sms // tiles)))
    chunk = -(-(-(-m // splits)) // step) * step
    return chunk, -(-m // chunk)


def _fused_bwd_dw(op: str, x, scale, shift, w, z, dz, dst, relu_in: bool):
    """The dW kernel of ``op`` ("pw_conv_dw" or "conv3x3_dw"): dW in bf16."""
    pointwise, m, cin, cout, dims = _check_bwd_args(op, x, scale, shift, w, z, dz, dst)
    if m == 0:
        return torch.zeros_like(w)
    lib = _BWD.get()
    taps = 1 if pointwise else 9
    chunk, splits = dw_split(m, cin, cout, taps, _sm_count(x.device.index or 0),
                             _BWD.tile["n"], _BWD.tile["k"])
    with torch.cuda.device(x.device):
        dw = torch.empty_like(w)
        partial = torch.empty((splits, taps, cin, cout), dtype=torch.float32,
                              device=x.device)
        fn = lib.dl4j_pw_conv_bwd_dw if pointwise else lib.dl4j_conv3x3_bwd_dw
        _launch(fn, op, (*_ptrs(x, scale, shift, z, dz, dst, partial, dw),
                         *dims, cin, cout, int(bool(relu_in)), chunk))
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
