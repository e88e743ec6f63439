"""FusedResNetBottleneck: one ResNet bottleneck block (1x1 reduce -> 3x3 ->
1x1 expand, + identity/projection shortcut) as a single layer driving the
fused conv+BN+ReLU kernels (``nn/ops/fused_conv.py``).

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/fused_block.py``, eval
path, with the same parameter and state names. Each conv folds the
upstream BatchNormalization's normalize (+ReLU) into its input read; the
per-channel fold coefficients are computed here in f32 from the running
statistics.

Routing follows the reference: the CUDA kernels run for CUDA tensors in
bf16 unless ``use_pallas is False`` (the option keeps the reference's
name); otherwise the block computes through the plain versions, with the
same parameter layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayer,
    check_inference,
)
from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc


@serde.register
class FusedResNetBottleneck(FeedForwardLayer):
    """width -> the bottleneck channel count (output channels = 4*width);
    ``stride=2`` subsamples in the reduce conv and the projection;
    ``project=True`` adds the 1x1 projection shortcut."""

    #: BN affine params stay f32 under mixed precision
    keep_fp32_params = ("gamma_a", "beta_a", "gamma_b", "beta_b",
                        "gamma_c", "beta_c", "gamma_p", "beta_p")

    def __init__(self, width: int, stride: int = 1, project: bool = False,
                 decay: float = 0.9, eps: float = 1e-5,
                 use_pallas: Optional[bool] = None, **kwargs):
        kwargs.setdefault("n_out", 4 * int(width))
        super().__init__(**kwargs)
        self.width = int(width)
        self.stride = int(stride)
        self.project = bool(project)
        self.decay = float(decay)
        self.eps = float(eps)
        self.use_pallas = use_pallas

    def initialize(self, input_type: InputType) -> None:
        if input_type.kind != "convolutional":
            raise ValueError("FusedResNetBottleneck needs convolutional input")
        if self.n_in is None:
            self.n_in = input_type.channels
        if not self.project and self.n_in != 4 * self.width:
            raise ValueError(
                f"identity shortcut needs n_in == 4*width "
                f"({self.n_in} != {4 * self.width}); set project=True")
        if self.stride == 2 and not self.project:
            raise ValueError("stride-2 blocks need a projection shortcut")

    def get_output_type(self, input_type: InputType) -> InputType:
        h = math.ceil(input_type.height / self.stride)
        w = math.ceil(input_type.width / self.stride)
        return InputType.convolutional(h, w, 4 * self.width)

    def init_params(self, gen, input_type, dtype=torch.float32):
        wd, cin, cout = self.width, self.n_in, 4 * self.width

        def conv_w(shape):
            fan_in = math.prod(shape[:-1])
            fan_out = (math.prod(shape[:-2]) * shape[-1] if len(shape) > 2
                       else shape[-1])
            return self._draw_weight(gen, shape, fan_in, fan_out, dtype)

        p = {"W_a": conv_w((cin, wd)), "W_b": conv_w((3, 3, wd, wd)),
             "W_c": conv_w((wd, cout))}
        for tag, c in (("a", wd), ("b", wd), ("c", cout)):
            p[f"gamma_{tag}"] = torch.ones((c,), dtype=torch.float32)
            p[f"beta_{tag}"] = torch.zeros((c,), dtype=torch.float32)
        if self.project:
            p["W_p"] = conv_w((cin, cout))
            p["gamma_p"] = torch.ones((cout,), dtype=torch.float32)
            p["beta_p"] = torch.zeros((cout,), dtype=torch.float32)
        return p

    def init_layer_state(self, input_type, dtype=torch.float32):
        wd, cout = self.width, 4 * self.width
        tags = (("a", wd), ("b", wd), ("c", cout))
        if self.project:
            tags += (("p", cout),)
        s = {}
        for tag, c in tags:
            s[f"mean_{tag}"] = torch.zeros((c,), dtype=torch.float32)
            s[f"var_{tag}"] = torch.ones((c,), dtype=torch.float32)
        return s

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether this block runs the CUDA kernels (all its convs) or the
        plain versions (all its convs): CUDA bf16 input, not opted out."""
        return (x.device.type == "cuda" and x.dtype == torch.bfloat16
                and self.use_pallas is not False)

    def _bn_fold(self, gamma, beta, mean, var):
        """Running statistics -> (scale, shift) f32 for the consumer's fold."""
        inv = torch.rsqrt(var + self.eps)
        return gamma * inv, beta - mean * inv * gamma

    def apply(self, params, x, *, state=None, train=False):
        check_inference(self, train)
        if state is None or "mean_a" not in state:
            raise ValueError("FusedResNetBottleneck needs its running-stat state")
        if self.uses_kernels(x):
            pw, c3 = fc.pw_conv, fc.conv3x3
        else:
            pw, c3 = fc.pw_conv_plain, fc.conv3x3_plain

        n, _, _, cin = x.shape
        wd, cout = self.width, 4 * self.width
        # the stride-2 subsample is a strided view; the kernels take only
        # contiguous tensors, so it is materialized here
        x_in = x[:, ::2, ::2, :].contiguous() if self.stride == 2 else x
        hs, ws = x_in.shape[1], x_in.shape[2]
        m = n * hs * ws
        ones = torch.ones((cin,), dtype=torch.float32, device=x.device)
        zeros = torch.zeros((cin,), dtype=torch.float32, device=x.device)

        def fold(tag):
            return self._bn_fold(params[f"gamma_{tag}"], params[f"beta_{tag}"],
                                 state[f"mean_{tag}"], state[f"var_{tag}"])

        # conv a: the block input is already normalized, no fold
        za, _ = pw(x_in.reshape(m, cin), ones, zeros, params["W_a"], False)
        s_a, t_a = fold("a")
        zb, _ = c3(za.reshape(n, hs, ws, wd), s_a, t_a, params["W_b"], True)
        s_b, t_b = fold("b")
        zc, _ = pw(zb.reshape(m, wd), s_b, t_b, params["W_c"], True)
        s_c, t_c = fold("c")
        dt = x.dtype
        nc = zc.reshape(n, hs, ws, cout).to(dt) * s_c.to(dt) + t_c.to(dt)
        if self.project:
            zp, _ = pw(x_in.reshape(m, cin), ones, zeros, params["W_p"], False)
            s_p, t_p = fold("p")
            shortcut = zp.reshape(n, hs, ws, cout).to(dt) * s_p.to(dt) + t_p.to(dt)
        else:
            shortcut = x
        return torch.relu(nc + shortcut), state
