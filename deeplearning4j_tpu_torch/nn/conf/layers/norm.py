"""BatchNormalization, inference math.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/norm.py``. Eval mode
normalizes with the running statistics: the per-channel scale and bias are
computed in f32 and cast once to the input dtype, then ``y = x*scale + bias``
in that dtype, as the reference does. Batch statistics (``train=True``)
come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer, check_inference


@serde.register
class BatchNormalization(Layer):
    activation = "identity"  # class-level default, as in the reference

    def __init__(self, decay: float = 0.9, eps: float = 1e-5, gamma: float = 1.0,
                 beta: float = 0.0, lock_gamma_beta: bool = False,
                 activation: str = "identity", **kwargs):
        super().__init__(**kwargs)
        self.decay = float(decay)
        self.eps = float(eps)
        self.gamma = float(gamma)
        self.beta = float(beta)
        self.lock_gamma_beta = bool(lock_gamma_beta)
        self.activation = activation
        self.n_feat: Optional[int] = None

    def initialize(self, input_type: InputType) -> None:
        if input_type.kind == "convolutional":
            self.n_feat = input_type.channels
        else:
            self.n_feat = input_type.size

    def get_output_type(self, input_type):
        return input_type

    def init_params(self, gen, input_type, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_feat,), self.gamma, dtype=dtype),
                "beta": torch.full((self.n_feat,), self.beta, dtype=dtype)}

    def init_layer_state(self, input_type, dtype=torch.float32):
        return {"mean": torch.zeros((self.n_feat,), dtype=dtype),
                "var": torch.ones((self.n_feat,), dtype=dtype)}

    def apply(self, params, x, *, state=None, train=False):
        check_inference(self, train)
        if state is None or "mean" not in state:
            raise ValueError("BatchNormalization needs its running-stat state")
        mean, var = state["mean"], state["var"]
        inv = torch.rsqrt(var + self.eps)
        if self.lock_gamma_beta:
            gamma, beta = self.gamma, self.beta
        else:
            gamma, beta = params["gamma"], params["beta"]
        scale = (gamma * inv).to(x.dtype)
        bias = (beta - mean * inv * gamma).to(x.dtype)
        y = x * scale + bias
        if self.activation != "identity":
            y = _act.get(self.activation)(y)
        return y, state
