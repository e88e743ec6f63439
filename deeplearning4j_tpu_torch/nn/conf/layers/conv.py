"""Convolution and spatial pooling layers, NHWC with HWIO weights.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/conv.py``:
``ConvolutionLayer``, ``SubsamplingLayer`` (max, avg, pnorm) and
``SpaceToDepthLayer``; the other spatial layers come with the rest of the
layer catalog (ROADMAP § A4). The public layout is the reference's: NHWC
activations, (kh, kw, in, out) weights. Inside, the NHWC tensor is viewed
as NCHW with channels_last strides for ``F.conv2d`` and the pooling ops
(the reference leaves these ops to XLA outside Pallas, so they are not
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

    def _window_sums(self, xc: torch.Tensor, pads) -> torch.Tensor:
        """Each window's sum over an NCHW view, zeros padded explicitly
        (XLA's "same" pads can be asymmetric; ``avg_pool2d`` pads evenly)."""
        (lh, hh), (lw, hw) = pads
        xc = F.pad(xc, (lw, hw, lh, hh))
        return F.avg_pool2d(xc, tuple(self.kernel_size), tuple(self.stride),
                            divisor_override=1)

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
            y = self._window_sums(_nchw(x), pads) / self._window_sums(ones, pads)
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = self._window_sums(_nchw(x.abs() ** p), pads) ** (1.0 / p)
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
