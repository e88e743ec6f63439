"""Fused conv+BN+ReLU forward ops: hand-written CUDA kernels for Hopper,
each beside its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/fused_conv.py``. Both ops
compute::

    y, stats = conv(act(x * scale + shift), W)

``scale``/``shift`` are the upstream BatchNormalization's folded per-channel
affine (f32), ``act`` is ReLU when ``relu_in``, and ``stats`` (2, Cout) f32
is ``[colsum(y); colsum(y*y)]`` over the valid rows, taken before ``y`` is
rounded to its storage type.

- :func:`pw_conv` is the 1x1 stride-1 conv on ``x (M, Cin)`` with
  ``w (Cin, Cout)``; its kernel replaces the Pallas ``_pw_fwd_kernel``.
- :func:`conv3x3` is the 3x3 SAME stride-1 conv on NHWC ``x (N, H, W, Cin)``
  with HWIO ``w (3, 3, Cin, Cout)``; its kernel replaces ``_c3_fwd_kernel``.

Dispatch: a CPU tensor goes to the plain version (:func:`pw_conv_plain`,
:func:`conv3x3_plain`). A CUDA tensor goes to the kernel in
``csrc/fused_conv.cu`` (bf16 in and out, f32 accumulation), or the wrapper
raises: there is no fallback. Each launch adds one to
``launch_counts[name]``. The backward kernels wait for the training slice.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.ops import build

#: kernel launches in this process, by op name; callers reset it to 0
#: around the work they want to attribute
launch_counts: "collections.Counter[str]" = collections.Counter()


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (the C function returned a nonzero
    ``cudaGetLastError``)."""


def reset_launch_counts() -> None:
    launch_counts.clear()


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the oracle the kernels are held to)
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          relu_in: bool) -> torch.Tensor:
    """The input fold in f32 (f64 stays f64): upstream normalize + ReLU."""
    u = x.to(torch.promote_types(x.dtype, torch.float32)) * scale + shift
    if relu_in:
        u = torch.clamp_min(u, 0.0)
    return u


def pw_conv_plain(x, scale, shift, w, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`pw_conv`. Follows ``x.dtype`` as the JAX
    ``pw_conv_reference`` does: the folded input is rounded to ``x.dtype``,
    the product accumulates in f32 (bf16 products are exact in f32), the
    statistics come from the f32 result and ``y`` is stored in ``x.dtype``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xn = _fold(x, scale, shift, relu_in).to(x.dtype)
    y = xn.to(acc) @ w.to(acc)
    stats = torch.stack([y.sum(0), (y * y).sum(0)])
    return y.to(x.dtype), stats


def conv3x3_plain(x, scale, shift, w, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`conv3x3`, as the JAX ``conv3x3_reference``:
    the folded input rounded to ``x.dtype`` (the SAME halo is zero after the
    fold), an f32 convolution, statistics from the f32 result."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xn = _fold(x, scale, shift, relu_in).to(x.dtype).to(acc)
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    stats = torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    return y.to(x.dtype).contiguous(), stats


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


class _Lib:
    """ctypes binding of ``csrc/fused_conv.cu``, loaded (and built) on the
    first kernel call."""

    handle = None
    block_m = 0

    @classmethod
    def get(cls):
        if cls.handle is None:
            lib = build.load("fused_conv")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.dl4j_fused_conv_block_m.argtypes = []
            lib.dl4j_fused_conv_block_m.restype = i
            lib.dl4j_pw_conv_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
            lib.dl4j_pw_conv_fwd.restype = i
            lib.dl4j_conv3x3_fwd.argtypes = [p] * 7 + [i] * 6 + [p]
            lib.dl4j_conv3x3_fwd.restype = i
            cls.block_m = int(lib.dl4j_fused_conv_block_m())
            cls.handle = lib
        return cls.handle


def _check_kernel_args(op: str, x, scale, shift, w, x_rank: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got {x.device}")
    for name, t, dt in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                        ("scale", scale, torch.float32),
                        ("shift", shift, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{op}: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{op}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(
                f"{op}: {name} must be contiguous (strides {t.stride()}); "
                "a strided view such as x[:, ::2, ::2, :] needs .contiguous()")
    if x.dim() != x_rank:
        raise ValueError(f"{op}: x must have rank {x_rank}, got {tuple(x.shape)}")
    cin = x.shape[-1]
    if scale.shape != (cin,) or shift.shape != (cin,):
        raise ValueError(f"{op}: scale/shift must be ({cin},), got "
                         f"{tuple(scale.shape)}/{tuple(shift.shape)}")


def _launch(fn, op: str, args) -> None:
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise KernelLaunchError(f"{op} kernel launch failed: cudaError {rc}")
    launch_counts[op] += 1


def _outputs(x, m: int, cout: int, y_shape):
    tiles = -(-m // _Lib.block_m)
    y = torch.empty(y_shape, dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((tiles, 2, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    return y, partial, stats


def pw_conv(x, scale, shift, w, relu_in: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pointwise conv: ``(y, stats) = 1x1conv(act(x*scale+shift), w)``.

    x: (M, Cin) bf16; scale/shift: (Cin,) f32; w: (Cin, Cout) bf16.
    Returns y (M, Cout) bf16 and stats (2, Cout) f32."""
    if x.device.type == "cpu":
        return pw_conv_plain(x, scale, shift, w, relu_in)
    _check_kernel_args("pw_conv", x, scale, shift, w, 2)
    m, cin = x.shape
    if w.dim() != 2 or w.shape[0] != cin:
        raise ValueError(f"pw_conv: w must be ({cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[1]
    if m == 0:
        return (torch.empty((0, cout), dtype=torch.bfloat16, device=x.device),
                torch.zeros((2, cout), dtype=torch.float32, device=x.device))
    lib = _Lib.get()
    with torch.cuda.device(x.device):
        y, partial, stats = _outputs(x, m, cout, (m, cout))
        _launch(lib.dl4j_pw_conv_fwd, "pw_conv",
                (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                 y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
                 m, cin, cout, int(bool(relu_in))))
    return y, stats


def conv3x3(x, scale, shift, w, relu_in: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 3x3 SAME stride-1 conv with the contract of :func:`pw_conv`.

    x: (N, H, W, Cin) bf16 NHWC; w: (3, 3, Cin, Cout) bf16 HWIO."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, scale, shift, w, relu_in)
    _check_kernel_args("conv3x3", x, scale, shift, w, 4)
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(
            f"conv3x3: w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    m = n * h * wd
    if m == 0:
        return (torch.empty((n, h, wd, cout), dtype=torch.bfloat16,
                            device=x.device),
                torch.zeros((2, cout), dtype=torch.float32, device=x.device))
    lib = _Lib.get()
    with torch.cuda.device(x.device):
        y, partial, stats = _outputs(x, m, cout, (n, h, wd, cout))
        _launch(lib.dl4j_conv3x3_fwd, "conv3x3",
                (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                 y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
                 n, h, wd, cin, cout, int(bool(relu_in))))
    return y, stats
