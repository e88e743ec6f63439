"""Core feed-forward layers: ActivationLayer, DenseLayer, OutputLayer,
LossLayer, DropoutLayer, the two embedding layers,
ElementWiseMultiplicationLayer, AutoEncoder and DummyLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/core.py``. Dense and
output layers go through ``int8_matmul.serving_matmul``, as the reference's
do: a plain matmul (``torch.matmul``, TF32 off) for f32 params, the int8
kernel for a serving snapshot's quantized ``W_q8``/``W_scale``. Under
``compute_dtype`` the output layer keeps f32 params while its input is
bf16: JAX promotes the product to f32 silently, torch refuses mixed-dtype
matmuls, so :func:`_affine` promotes explicitly and the softmax runs in f32
as in JAX. A layer's ``dropout`` is the identity in eval, as in JAX.

The embedding layers take their indices as floats (truncated to integers)
and look the rows up with ``F.embedding``, whose gradient sums the rows of
repeated indices in a fixed order on the card too; ``W[idx]``'s would take
``index_put_(accumulate=True)``, whose float atomics sum them in any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
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


@serde.register
class DropoutLayer(Layer):
    """A layer of input dropout alone: the network drops its input (its
    ``dropout``) in training, ``apply`` is the identity."""

    def __init__(self, dropout: float = 0.5, **kwargs):
        kwargs["dropout"] = dropout
        super().__init__(**kwargs)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return x, state or {}


def _indices(x: torch.Tensor, squeeze_dim: int) -> torch.Tensor:
    """Float indices as int64 (truncated, as ``astype(int32)``), a trailing
    axis of 1 at ``squeeze_dim`` dims dropped."""
    idx = x.long()
    if idx.dim() == squeeze_dim and idx.shape[-1] == 1:
        idx = idx[..., 0]
    return idx


@serde.register
class EmbeddingLayer(FeedForwardLayer):
    """One index an example, (b,) or (b, 1), to its row of W (n_in, n_out)
    plus the bias; ``n_in`` is the vocabulary size and must be given."""

    def initialize(self, input_type):
        if self.n_in is None:
            raise ValueError("EmbeddingLayer requires explicit n_in (vocab size)")

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in,
                                       self.n_out, dtype),
                "b": self._bias((self.n_out,), dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = F.embedding(_indices(x, 2), params["W"]) + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class EmbeddingSequenceLayer(FeedForwardLayer):
    """A sequence of indices, (b, T) or (b, T, 1), to (b, T, n_out) rows of
    W (n_in, n_out), plus a bias where ``has_bias``."""

    def __init__(self, input_length=None, has_bias: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.input_length = input_length
        self.has_bias = bool(has_bias)

    def initialize(self, input_type):
        if self.n_in is None:
            raise ValueError("EmbeddingSequenceLayer requires explicit n_in (vocab size)")

    def get_output_type(self, input_type):
        ts = self.input_length
        if input_type.kind == "recurrent" and input_type.timesteps:
            ts = input_type.timesteps
        return InputType.recurrent(self.n_out, ts)

    def init_params(self, gen, input_type, dtype=torch.float32):
        p = {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                                    dtype)}
        if self.has_bias:
            p["b"] = self._bias((self.n_out,), dtype)
        return p

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = F.embedding(_indices(x, 3), params["W"])
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y), state or {}


@serde.register
class ElementWiseMultiplicationLayer(FeedForwardLayer):
    """y = act(x * w + b), a learned scale a feature (W starts at ones)."""

    def initialize(self, input_type):
        super().initialize(input_type)
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_in != self.n_out:
            raise ValueError("ElementWiseMultiplicationLayer requires nIn == nOut")

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": torch.ones((self.n_in,), dtype=dtype), "b": self._bias((self.n_in,), dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self.act_fn()(x * params["W"] + params["b"]), state or {}


@serde.register
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder: in a network, the encoder ``act(x W + b)``;
    pretrained on its reconstruction of the input through the tied weights,
    ``act(h W^T + vb)`` (visible bias ``vb``), from an input whose elements
    are zeroed with probability ``corruption_level``."""

    is_pretrain_layer = True

    def __init__(self, corruption_level: float = 0.3, sparsity: float = 0.0,
                 loss: str = "mse", **kwargs):
        super().__init__(**kwargs)
        self.corruption_level = float(corruption_level)
        self.sparsity = float(sparsity)
        self.loss = loss

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in,
                                       self.n_out, dtype),
                "b": self._bias((self.n_out,), dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype)}

    def _encode(self, params, x):
        return self.act_fn()(x @ params["W"] + params["b"])

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self._encode(params, x), state or {}

    def pretrain_loss(self, params, x, rng=None) -> torch.Tensor:
        """The mean reconstruction loss (``loss`` with the layer's
        activation) of ``x`` from its corrupted copy; ``rng`` (a noise
        source) draws the kept elements, None: no corruption."""
        corrupted = x
        if self.corruption_level > 0 and rng is not None:
            keep = rng.bernoulli(1.0 - self.corruption_level, x.shape, x.device)
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        recon_pre = self._encode(params, corrupted) @ params["W"].T + params["vb"]
        return _losses.get(self.loss)(x, recon_pre, self.activation).mean()

    def reconstruct(self, params, x) -> torch.Tensor:
        """The uncorrupted reconstruction ``act(act(x W + b) W^T + vb)``."""
        x = torch.as_tensor(x)
        return self.act_fn()(self._encode(params, x) @ params["W"].T + params["vb"])


@serde.register
class DummyLayer(Layer):
    """The identity."""

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return x, state or {}
