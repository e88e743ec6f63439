"""Convolution and spatial pooling layers, NHWC with HWIO weights.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/conv.py``: the 2-D
convolutions (plain, transposed, depthwise, separable), pooling (max, avg,
pnorm), upsampling, zero padding, cropping, space-to-depth and
space-to-batch, and the 1-D layers over recurrent ``(b, T, C)`` input (conv,
pooling, upsampling, zero padding). The public layout is the reference's:
NHWC activations, (kh, kw, in, out) weights. Inside, the NHWC tensor is
viewed as NCHW with channels_last strides for ``F.conv2d`` and the pooling
ops (the reference leaves these ops to XLA outside Pallas, so they are not
kernels of the port), and results come back as contiguous NHWC.

ConvolutionMode "same" follows XLA's SAME padding, which is asymmetric at
stride 2: total = max((ceil(in/s) - 1)*s + k_eff - in, 0), lo = total // 2,
hi = total - lo (the stem 7x7/2 on 224 pads (2, 3); the 3x3/2 max-pool on 112
pads (0, 1), with -inf). torch pads symmetrically, so the pad is explicit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import remat
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayer,
    Layer,
)

IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _conv_out(size: int, k: int, s: int, p: int, mode: str, dilation: int = 1) -> int:
    eff_k = k + (k - 1) * (dilation - 1)
    if mode == "same":
        return math.ceil(size / s)
    out = (size + 2 * p - eff_k) // s + 1
    if mode == "strict" and (size + 2 * p - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.Strict: (in={size} + 2*pad={p} - k={eff_k}) "
            f"not divisible by stride={s}")
    return out


def same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA "SAME" (lo, hi) padding of one spatial axis."""
    eff_k = (k - 1) * dilation + 1
    total = max((math.ceil(size / s) - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(layer, x: torch.Tensor, dilation=(1, 1)):
    """((lo_h, hi_h), (lo_w, hi_w)) for an NHWC input."""
    if layer.convolution_mode == "same":
        kh, kw = layer.kernel_size
        sh, sw = layer.stride
        return (same_pads(x.shape[1], kh, sh, dilation[0]),
                same_pads(x.shape[2], kw, sw, dilation[1]))
    ph, pw = layer.padding
    return (ph, ph), (pw, pw)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _window_sums(xc: torch.Tensor, kernel, stride, pads) -> torch.Tensor:
    """Each window's sum over an NCHW view, zeros padded explicitly (XLA's
    "same" pads can be asymmetric; ``avg_pool2d`` pads evenly)."""
    (lh, hh), (lw, hw) = pads
    xc = F.pad(xc, (lw, hw, lh, hh))
    return F.avg_pool2d(xc, tuple(kernel), tuple(stride), divisor_override=1)


class BaseConvLayer(FeedForwardLayer):
    """Shared kernel/stride/padding/mode handling."""

    def __init__(self, kernel_size: IntPair = 3, stride: IntPair = 1,
                 padding: IntPair = 0, convolution_mode: str = "truncate",
                 dilation: IntPair = 1, has_bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.kernel_size = list(_pair(kernel_size))
        self.stride = list(_pair(stride))
        self.padding = list(_pair(padding))
        self.convolution_mode = convolution_mode.lower()
        self.dilation = list(_pair(dilation))
        self.has_bias = bool(has_bias)

    def initialize(self, input_type: InputType) -> None:
        if input_type.kind not in ("convolutional", "convolutional_flat"):
            raise ValueError(
                f"{type(self).__name__} needs convolutional input, got {input_type}")
        if self.n_in is None:
            self.n_in = input_type.channels

    def get_output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        dh, dw = self.dilation
        h = _conv_out(input_type.height, kh, sh, ph, self.convolution_mode, dh)
        w = _conv_out(input_type.width, kw, sw, pw, self.convolution_mode, dw)
        return InputType.convolutional(h, w, self.n_out)


@serde.register
class ConvolutionLayer(BaseConvLayer):
    """2D convolution. W: (kh, kw, inC, outC) HWIO; fan_in = kh*kw*inC,
    fan_out = kh*kw*outC."""

    #: what :meth:`apply` names for the remat policy (``nn/remat.py``)
    checkpoint_names = ("conv_out",)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = self.kernel_size
        p = {"W": self._draw_weight(gen, (kh, kw, self.n_in, self.n_out),
                                    kh * kw * self.n_in, kh * kw * self.n_out,
                                    dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_out,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        (lh, hh), (lw, hw) = _spatial_pads(self, x, self.dilation)
        xc = _nchw(x)
        if (lh, lw) != (hh, hw):
            xc = F.pad(xc, (lw, hw, lh, hh))
            lh = lw = 0
        w = params["W"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        # the raw convolution is "conv_out", as in the reference: under the
        # "save_conv_outputs" remat policy it is kept, its bias and
        # activation recomputed from it; elsewhere the name changes nothing
        with remat.checkpoint_name("conv_out"):
            y = F.conv2d(xc, w, stride=tuple(self.stride), padding=(lh, lw),
                         dilation=tuple(self.dilation))
        y = _nhwc(y)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class SubsamplingLayer(Layer):
    """Spatial pooling: max, avg (the mean over the window's in-image
    elements: padding is not counted) or pnorm ((sum |x|^p)^(1/p))."""

    def __init__(self, pooling_type: str = "max", kernel_size: IntPair = 2,
                 stride: IntPair = 2, padding: IntPair = 0,
                 convolution_mode: str = "truncate", pnorm: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.pooling_type = pooling_type.lower()
        self.kernel_size = list(_pair(kernel_size))
        self.stride = list(_pair(stride))
        self.padding = list(_pair(padding))
        self.convolution_mode = convolution_mode.lower()
        self.pnorm = int(pnorm)

    def get_output_type(self, input_type):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        h = _conv_out(input_type.height, kh, sh, ph, self.convolution_mode)
        w = _conv_out(input_type.width, kw, sw, pw, self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        pads = _spatial_pads(self, x)
        (lh, hh), (lw, hw) = pads
        pt = self.pooling_type
        if pt == "max":
            # at equal values in a window, the gradient may go to another
            # element than XLA's select-and-scatter picks (after a ReLU, zeros)
            xc = F.pad(_nchw(x), (lw, hw, lh, hh), value=float("-inf"))
            y = F.max_pool2d(xc, tuple(self.kernel_size), tuple(self.stride))
        elif pt in ("avg", "average"):
            # divided by the count of in-image elements, as the reference
            # counts them: a ones image reduced with the same padding
            ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype, device=x.device)
            y = (_window_sums(_nchw(x), self.kernel_size, self.stride, pads)
                 / _window_sums(ones, self.kernel_size, self.stride, pads))
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = _window_sums(_nchw(x.abs() ** p), self.kernel_size, self.stride,
                             pads) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        return _nhwc(y), state or {}


@serde.register
class SpaceToDepthLayer(Layer):
    """Each ``block_size`` x ``block_size`` block of pixels into one pixel
    of ``block_size**2 * c`` channels, in (block row, block col, channel)
    order, the reference's (a stem conv's carried weights depend on it)."""

    def __init__(self, block_size: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.block_size = int(block_size)

    def get_output_type(self, input_type):
        bs = self.block_size
        return InputType.convolutional(input_type.height // bs, input_type.width // bs,
                                       input_type.channels * bs * bs)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        b, h, w, c = x.shape
        bs = self.block_size
        y = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, h // bs, w // bs, bs * bs * c), state or {}


def _conv_transpose_pads(k: int, s: int, mode: str, p: int) -> Tuple[int, int]:
    """(lo, hi) padding of the stride-dilated input of a transposed conv, as
    XLA's ``conv_transpose`` takes it: "same" (output ``in * s``; uneven for
    an even kernel, and where ``k < s``), else ``k - 1 - p`` a side (output
    ``s*(in-1) + k - 2p``)."""
    if mode == "same":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else math.ceil(total / 2)
        return lo, total - lo
    return k - 1 - p, k - 1 - p


def _depthwise(layer, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise conv of an NHWC input with (kh, kw, 1, n_in*dm) weights
    (``feature_group_count = n_in``): output channel ``c*dm + m`` reads input
    channel ``c``, as torch's ``groups=n_in`` weight (n_in*dm, 1, kh, kw)
    orders them. Returns an NCHW view."""
    (lh, hh), (lw, hw) = _spatial_pads(layer, x, layer.dilation)
    xc = F.pad(_nchw(x), (lw, hw, lh, hh))
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(xc, wc, stride=tuple(layer.stride), dilation=tuple(layer.dilation),
                    groups=layer.n_in)


@serde.register
class Deconvolution2D(BaseConvLayer):
    """Transposed convolution, the gradient of a forward conv: W is (kh, kw,
    n_out, n_in), the HWIO kernel of the conv this one transposes (TF/Keras
    Conv2DTranspose). Explicit padding is the forward conv's: the output is
    ``s*(in-1) + k - 2p``, or ``in * s`` in "same" mode (XLA's transposed
    SAME padding, which torch's symmetric ``padding`` cannot always express:
    the full transposed conv is cropped, or zero-padded, explicitly)."""

    def get_output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        if self.convolution_mode == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = self.kernel_size
        p = {"W": self._draw_weight(gen, (kh, kw, self.n_out, self.n_in),
                                    kh * kw * self.n_in, kh * kw * self.n_out, dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_out,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        lh, hh = _conv_transpose_pads(kh, sh, self.convolution_mode, ph)
        lw, hw = _conv_transpose_pads(kw, sw, self.convolution_mode, pw)
        # conv_transpose2d's weight (in, out, kh, kw) is the forward conv's
        # (out=n_in, in=n_out) kernel: W's HWIO read as OIHW
        w = params["W"].permute(3, 2, 0, 1).contiguous()
        y = F.conv_transpose2d(_nchw(x), w, stride=(sh, sw))
        # the full transposed conv has k - 1 rows of padding a side; crop to
        # (or zero-pad up to) XLA's
        y = F.pad(y, (lw - (kw - 1), hw - (kw - 1), lh - (kh - 1), hh - (kh - 1)))
        y = _nhwc(y)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class DepthwiseConvolution2D(BaseConvLayer):
    """Depthwise conv: each input channel convolved with ``depth_multiplier``
    kernels of its own; W (kh, kw, 1, n_in*dm)."""

    def __init__(self, depth_multiplier: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.depth_multiplier = int(depth_multiplier)

    def initialize(self, input_type):
        super().initialize(input_type)
        if self.n_out is None:
            self.n_out = self.n_in * self.depth_multiplier

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = self.kernel_size
        dm = self.depth_multiplier
        p = {"W": self._draw_weight(gen, (kh, kw, 1, self.n_in * dm), kh * kw,
                                    kh * kw * dm, dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_in * dm,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = _nhwc(_depthwise(self, x, params["W"]))
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class SeparableConvolution2D(BaseConvLayer):
    """Depthwise conv (``dW``: (kh, kw, 1, n_in*dm)) then a pointwise conv
    (``pW``: (1, 1, n_in*dm, n_out)), one bias after both."""

    def __init__(self, depth_multiplier: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.depth_multiplier = int(depth_multiplier)

    def init_params(self, gen, input_type, dtype=torch.float32):
        kh, kw = self.kernel_size
        dm = self.depth_multiplier
        dw_out = self.n_in * dm
        p = {"dW": self._draw_weight(gen, (kh, kw, 1, dw_out), kh * kw, kh * kw * dm, dtype),
             "pW": self._draw_weight(gen, (1, 1, dw_out, self.n_out), dw_out, self.n_out,
                                     dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_out,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = _depthwise(self, x, params["dW"])
        pw = params["pW"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = _nhwc(F.conv2d(y, pw))
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size`` (rows, cols)."""

    def __init__(self, size: IntPair = 2, **kwargs):
        super().__init__(**kwargs)
        self.size = list(_pair(size))

    def get_output_type(self, input_type):
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1], input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = x.repeat_interleave(self.size[0], dim=1).repeat_interleave(self.size[1], dim=2)
        return y, state or {}


def _four(v) -> list:
    """A (top, bottom, left, right) list from an int, a (rows, cols) pair or
    four values."""
    if isinstance(v, int):
        v = (v, v, v, v)
    elif len(v) == 2:
        v = (v[0], v[0], v[1], v[1])
    return [int(p) for p in v]


@serde.register
class ZeroPaddingLayer(Layer):
    """Zeros around the image; ``pad``: (top, bottom, left, right), or one
    value, or (rows, cols)."""

    def __init__(self, pad: Sequence[int] = (0, 0, 0, 0), **kwargs):
        super().__init__(**kwargs)
        self.pad = _four(pad)

    def get_output_type(self, input_type):
        t, b, l, r = self.pad
        return InputType.convolutional(input_type.height + t + b, input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        t, b, l, r = self.pad
        return F.pad(x, (0, 0, l, r, t, b)), state or {}


@serde.register
class Cropping2D(Layer):
    """Rows and columns cut off the image; ``crop``: (top, bottom, left,
    right), or one value, or (rows, cols)."""

    def __init__(self, crop: Sequence[int] = (0, 0, 0, 0), **kwargs):
        super().__init__(**kwargs)
        self.crop = _four(crop)

    def get_output_type(self, input_type):
        t, b, l, r = self.crop
        return InputType.convolutional(input_type.height - t - b, input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        t, b, l, r = self.crop
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state or {}


@serde.register
class SpaceToBatchLayer(Layer):
    """Each ``blocks`` (bh, bw) offset of the image into a batch of its own:
    output batch index ``(i*bw + j)*b + n`` holds pixels ``(y*bh + i, x*bw +
    j)`` of example ``n``, the reference's (bh, bw, b) order."""

    def __init__(self, blocks: IntPair = 2, **kwargs):
        super().__init__(**kwargs)
        self.blocks = list(_pair(blocks))

    def get_output_type(self, input_type):
        bh, bw = self.blocks
        return InputType.convolutional(input_type.height // bh, input_type.width // bw,
                                       input_type.channels)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        bh, bw = self.blocks
        b, h, w, c = x.shape
        y = x.reshape(b, h // bh, bh, w // bw, bw, c).permute(2, 4, 0, 1, 3, 5)
        return y.reshape(b * bh * bw, h // bh, w // bw, c), state or {}


# --------------------------------------------------------------------------
# 1-D layers over recurrent (b, T, C) activations
# --------------------------------------------------------------------------


def _time_pads(size: int, k: int, s: int, mode: str, p: int, dilation: int = 1):
    return same_pads(size, k, s, dilation) if mode == "same" else (p, p)


@serde.register
class Convolution1DLayer(BaseConvLayer):
    """1-D conv over time: W (k, n_in, n_out); "same" is XLA's SAME (uneven
    at stride 2)."""

    def __init__(self, kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 dilation: int = 1, **kwargs):
        kwargs.setdefault("convolution_mode", "truncate")
        super().__init__(kernel_size=(kernel_size, 1), stride=(stride, 1), padding=(padding, 1),
                         dilation=(dilation, 1), **kwargs)
        self.kernel_size = [int(kernel_size)]
        self.stride = [int(stride)]
        self.padding = [int(padding)]
        self.dilation = [int(dilation)]

    def initialize(self, input_type):
        if input_type.kind != "recurrent":
            raise ValueError("Convolution1DLayer needs recurrent input")
        if self.n_in is None:
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        ts = input_type.timesteps
        if ts is not None:
            ts = _conv_out(ts, self.kernel_size[0], self.stride[0], self.padding[0],
                           self.convolution_mode, self.dilation[0])
        return InputType.recurrent(self.n_out, ts)

    def init_params(self, gen, input_type, dtype=torch.float32):
        k = self.kernel_size[0]
        p = {"W": self._draw_weight(gen, (k, self.n_in, self.n_out), k * self.n_in,
                                    k * self.n_out, dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_out,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        lo, hi = _time_pads(x.shape[1], k, s, self.convolution_mode, self.padding[0], d)
        xc = F.pad(x.transpose(1, 2), (lo, hi))
        y = F.conv1d(xc, params["W"].permute(2, 1, 0), stride=s, dilation=d)
        y = y.transpose(1, 2).contiguous()
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class Subsampling1DLayer(Layer):
    """1-D pooling over time: max, or (any other type) the mean over the
    window's in-range steps (padding is not counted)."""

    def __init__(self, pooling_type: str = "max", kernel_size: int = 2, stride: int = 2,
                 padding: int = 0, convolution_mode: str = "truncate", **kwargs):
        super().__init__(**kwargs)
        self.pooling_type = pooling_type.lower()
        self.kernel_size = int(kernel_size)
        self.stride = int(stride)
        self.padding = int(padding)
        self.convolution_mode = convolution_mode.lower()

    def get_output_type(self, input_type):
        ts = input_type.timesteps
        if ts is not None:
            ts = _conv_out(ts, self.kernel_size, self.stride, self.padding,
                           self.convolution_mode)
        return InputType.recurrent(input_type.size, ts)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        lo, hi = _time_pads(x.shape[1], self.kernel_size, self.stride,
                            self.convolution_mode, self.padding)
        xc = x.transpose(1, 2)
        if self.pooling_type == "max":
            y = F.max_pool1d(F.pad(xc, (lo, hi), value=float("-inf")), self.kernel_size,
                             self.stride)
        else:
            ones = torch.ones((1, 1, 1, x.shape[1]), dtype=x.dtype, device=x.device)
            k, st, pads = (1, self.kernel_size), (1, self.stride), ((0, 0), (lo, hi))
            y = (_window_sums(xc[:, :, None, :], k, st, pads)
                 / _window_sums(ones, k, st, pads))[:, :, 0, :]
        return y.transpose(1, 2).contiguous(), state or {}


@serde.register
class Upsampling1D(Layer):
    """Each time step repeated ``size`` times."""

    def __init__(self, size: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.size = int(size)

    def get_output_type(self, input_type):
        ts = input_type.timesteps
        return InputType.recurrent(input_type.size, None if ts is None else ts * self.size)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return x.repeat_interleave(self.size, dim=1), state or {}


@serde.register
class ZeroPadding1DLayer(Layer):
    """Zero steps before and after; ``pad``: one value or (before, after)."""

    def __init__(self, pad: IntPair = 1, **kwargs):
        super().__init__(**kwargs)
        self.pad = list(_pair(pad))

    def get_output_type(self, input_type):
        ts = input_type.timesteps
        return InputType.recurrent(input_type.size,
                                   None if ts is None else ts + self.pad[0] + self.pad[1])

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return F.pad(x, (0, 0, self.pad[0], self.pad[1])), state or {}


@serde.register
class Pooling2D(SubsamplingLayer):
    """The name ``Pooling2D`` of :class:`SubsamplingLayer`."""


@serde.register
class Pooling1D(Subsampling1DLayer):
    """The name ``Pooling1D`` of :class:`Subsampling1DLayer`."""
