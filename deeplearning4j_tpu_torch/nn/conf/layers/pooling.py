"""Global pooling over space.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/pooling.py`` for CNN
input ``(b, h, w, c)`` -> ``(b, c)``. The mean accumulates in f32 and is
cast back to the input dtype, as ``jnp.mean`` does for bf16. Pooling over
time with masks comes with the recurrent slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer, check_inference


@serde.register
class GlobalPoolingLayer(Layer):
    """Pooling types: max | avg (sum and pnorm wait for a later slice)."""

    def __init__(self, pooling_type: str = "max", pnorm: int = 2,
                 collapse_dimensions: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.pooling_type = pooling_type.lower()
        self.pnorm = int(pnorm)
        self.collapse_dimensions = bool(collapse_dimensions)

    def get_output_type(self, input_type):
        if input_type.kind == "recurrent":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "convolutional":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, state=None, train=False):
        check_inference(self, train)
        if x.dim() != 4:
            raise NotImplementedError(
                "GlobalPoolingLayer over time (rank-3 input) comes with the "
                "recurrent slice (ROADMAP § A)")
        pt = self.pooling_type
        if pt == "max":
            y = x.amax(dim=(1, 2))
        elif pt in ("avg", "average"):
            acc = torch.promote_types(x.dtype, torch.float32)
            y = x.to(acc).mean(dim=(1, 2)).to(x.dtype)
        else:
            raise NotImplementedError(
                f"pooling type '{pt}' is not ported yet (ROADMAP § A)")
        return y, state or {}
