"""BatchNormalization and LocalResponseNormalization.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/norm.py``. Eval mode
normalizes with the running statistics; train mode with the batch's, over
every axis but the last, and returns the running statistics moved by the
EMA ``decay*old + (1-decay)*batch``. For bf16 (and f16) input the
statistics are taken in f32 as ``max(E[x^2] - mean^2, 0)``; for f32 input
the variance is ``var``. The per-channel scale and bias are computed in f32
and cast once to the input dtype, then ``y = x*scale + bias`` in that
dtype, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch.nn import batch_stats
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer


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

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        if state is None or "mean" not in state:
            raise ValueError("BatchNormalization needs its running-stat state")
        if train:
            dims = tuple(range(x.dim() - 1))
            across = batch_stats.crosses_ranks()

            def means(*ts):  # over the batch, or over the global batch of the ranks
                if not across:
                    return [t.mean(dims) for t in ts]
                sums, rows = batch_stats.global_sums([t.sum(dims) for t in ts],
                                                     x.numel() // x.shape[-1])
                return [s / rows for s in sums]

            if x.dtype in (torch.bfloat16, torch.float16):
                xf = x.float()
                mean, sq = means(xf, xf * xf)
                var = sq - mean * mean
                # jnp.maximum: gradient 0.5 at a tie
                var = torch.maximum(var, torch.zeros_like(var))
            else:
                (mean,) = means(x)
                var = (means((x - mean) ** 2)[0] if across
                       else x.var(dims, unbiased=False))
            # the running statistics are state, not differentiated
            new_state = {
                "mean": (self.decay * state["mean"] + (1 - self.decay) * mean).detach(),
                "var": (self.decay * state["var"] + (1 - self.decay) * var).detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
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
        return y, new_state


@serde.register
class LocalResponseNormalization(Layer):
    """Across-channel LRN (AlexNet's; the reference's defaults k=2, n=5,
    alpha=1e-4, beta=0.75): ``x / (k + alpha * sum of x² over n adjacent
    channels) ** beta``, the window over the last (NHWC channel) axis,
    zero past the edges, summed in the reference's order."""

    def __init__(self, k: float = 2.0, n: float = 5.0, alpha: float = 1e-4,
                 beta: float = 0.75, **kwargs):
        super().__init__(**kwargs)
        self.k = float(k)
        self.n = float(n)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        half = int(self.n) // 2
        c = x.shape[-1]
        padded = F.pad(x * x, (half, half))
        window = sum(padded[..., i:i + c] for i in range(int(self.n)))
        return x / (self.k + self.alpha * window) ** self.beta, state or {}
