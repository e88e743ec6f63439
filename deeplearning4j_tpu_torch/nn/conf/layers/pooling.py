"""Global pooling over space or time, and MaskLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/pooling.py``: CNN input
``(b, h, w, c)`` pools over space to ``(b, c)``, recurrent input
``(b, T, d)`` over time to ``(b, d)``, skipping masked steps. The unmasked
mean accumulates in f32 and is cast back to the input dtype, as
``jnp.mean`` does for bf16. ``MaskLayer`` zeroes the masked steps of
recurrent input.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer


@serde.register
class GlobalPoolingLayer(Layer):
    """Pooling types: max | avg | sum | pnorm."""

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

    def _pool(self, x, dims, mask_b=None):
        pt = self.pooling_type
        if pt == "max":
            if mask_b is not None:
                x = torch.where(mask_b > 0, x, torch.full((), float("-inf"),
                                                          dtype=x.dtype, device=x.device))
            return x.amax(dim=dims)
        if pt in ("avg", "average"):
            if mask_b is not None:
                s = (x * mask_b).sum(dim=dims)
                cnt = torch.clamp(mask_b.sum(dim=dims), min=1.0)
                return s / cnt
            # f32 accumulation, back to the input dtype, as jnp.mean on bf16
            acc = torch.promote_types(x.dtype, torch.float32)
            return x.to(acc).mean(dim=dims).to(x.dtype)
        if pt == "sum":
            if mask_b is not None:
                x = x * mask_b
            return x.sum(dim=dims)
        if pt == "pnorm":
            p = float(self.pnorm)
            if mask_b is not None:
                x = x * mask_b
            return (x.abs() ** p).sum(dim=dims) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {pt}")

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        if x.dim() == 3:  # (b, T, d): over time, mask-aware
            mask_b = None if mask is None else mask[..., None]
            y = self._pool(x, (1,), mask_b)
        elif x.dim() == 4:  # (b, h, w, c): over space
            y = self._pool(x, (1, 2))
        else:
            raise ValueError(f"GlobalPooling expects 3d/4d input, got {tuple(x.shape)}")
        return y, state or {}


@serde.register
class MaskLayer(Layer):
    """Recurrent input times its (b, T) feature mask; other input, or no
    mask, passes unchanged."""

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        if mask is not None and x.dim() == 3:
            x = x * mask[..., None]
        return x, state or {}
