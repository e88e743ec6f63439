"""Core feed-forward layers: ActivationLayer, DenseLayer, OutputLayer,
LossLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/core.py``. Dense and
output layers go through ``int8_matmul.serving_matmul``, as the reference's
do: a plain matmul (``torch.matmul``, TF32 off) for f32 params, the int8
kernel for a serving snapshot's quantized ``W_q8``/``W_scale``. Under
``compute_dtype`` the output layer keeps f32 params while its input is
bf16: JAX promotes the product to f32 silently, torch refuses mixed-dtype
matmuls, so :func:`_affine` promotes explicitly and the softmax runs in f32
as in JAX. A layer's ``dropout`` is the identity in eval, as in JAX.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.nn.ops.int8_matmul import serving_matmul


def _affine(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with JAX's dtype promotion (``W`` or its int8 form)."""
    y = serving_matmul(params, x)
    b = params["b"]
    dt = torch.promote_types(y.dtype, b.dtype)
    return y.to(dt) + b.to(dt)


@serde.register
class DenseLayer(FeedForwardLayer):
    """Fully connected layer: y = act(xW + b), W: (nIn, nOut)."""

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in,
                                       self.n_out, dtype),
                "b": self._bias((self.n_out,), dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self.act_fn()(_affine(params, x)), state or {}

    def pre_output(self, params, x):
        """``x W + b`` before the activation."""
        return _affine(params, x)


@serde.register
class ActivationLayer(Layer):
    """Applies an activation only."""

    def __init__(self, activation: str = "relu", **kwargs):
        super().__init__(**kwargs)
        self.activation = activation

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return _act.get(self.activation)(x), state or {}


@serde.register
class BaseOutputLayer(DenseLayer):
    """Dense layer + loss head: inference applies the activation, training
    scores the loss from the logits."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss

    def compute_score(self, params, x, labels, mask=None) -> torch.Tensor:
        """Per-example loss vector from this layer's input activations
        (the graph hands them over in f32 under a compute dtype)."""
        return _losses.get(self.loss)(labels, _affine(params, x),
                                      self.activation, mask)


@serde.register
class OutputLayer(BaseOutputLayer):
    pass


@serde.register
class LossLayer(Layer):
    """A loss head without params: the activation on its input in
    inference, the loss of its input (as the pre-activation) in training."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", activation: str = "identity", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss
        self.activation = activation

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return _act.get(self.activation)(x), state or {}

    def compute_score(self, params, x, labels, mask=None) -> torch.Tensor:
        return _losses.get(self.loss)(labels, x, self.activation, mask)
