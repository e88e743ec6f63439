"""Core feed-forward layers: ActivationLayer, DenseLayer, OutputLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/core.py``. Dense and
output layers are a plain matmul (``torch.matmul``, TF32 off), as the
reference leaves them to XLA. Under ``compute_dtype`` the output layer keeps
f32 params while its input is bf16: JAX promotes the product to f32
silently, torch refuses mixed-dtype matmuls, so :func:`_affine` promotes
explicitly and the softmax runs in f32 as in JAX.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayer,
    Layer,
    check_inference,
)


def _affine(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with JAX's dtype promotion."""
    w, b = params["W"], params["b"]
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype), b.dtype)
    return x.to(dt) @ w.to(dt) + b.to(dt)


@serde.register
class DenseLayer(FeedForwardLayer):
    """Fully connected layer: y = act(xW + b), W: (nIn, nOut)."""

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in,
                                       self.n_out, dtype),
                "b": self._bias((self.n_out,), dtype)}

    def apply(self, params, x, *, state=None, train=False):
        check_inference(self, train)
        return self.act_fn()(_affine(params, x)), state or {}


@serde.register
class ActivationLayer(Layer):
    """Applies an activation only."""

    def __init__(self, activation: str = "relu", **kwargs):
        super().__init__(**kwargs)
        self.activation = activation

    def apply(self, params, x, *, state=None, train=False):
        check_inference(self, train)
        return _act.get(self.activation)(x), state or {}


@serde.register
class BaseOutputLayer(DenseLayer):
    """Dense layer + loss head; inference applies the activation (the loss
    is scored by the training slice)."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss


@serde.register
class OutputLayer(BaseOutputLayer):
    pass
