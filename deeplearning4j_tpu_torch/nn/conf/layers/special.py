"""FrozenLayer and CenterLossOutputLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/special.py``.

``FrozenLayer`` wraps any layer, the transfer-learning building block: the
wrapped layer runs in inference mode even in training (BN's running
statistics, which it does not move; no dropout), and no update touches its
params or updater state (``nn/multilayer.apply_layer_updates``, the ZeRO-1
layout of ``parallel/zero.py``). The networks record no gradient for its
params, so a frozen prefix runs no backward at all, while gradients still
flow through a frozen layer to trainable layers before it. Its
regularization terms still count in the score, as the reference's
``_reg_score`` counts them. Under a compute dtype it keeps the wrapped
layer's f32 params in f32 (``nn/multilayer.cast_layer_params_for_compute``).

``CenterLossOutputLayer``'s loss is the classification loss plus ``lambda/2 * ||f - c_y||²``, the
distance of each example's input features ``f`` to its class's center. The
centers are layer state, not params: no gradient reaches them. The networks
move them after the score, from the head's input, in training only
(:meth:`update_centers`), as they move BN's running statistics: inside a
captured bundle, skipped with the rest of the step's state by the fault
guard, once a step under every remat policy (the head is never a
recomputed region), in the zip's ``state.bin``. Inside a step that spans
several ranks (``nn/batch_stats.across_ranks``) the class means are those
of the global batch, as the reference's one program over the sharded batch
takes them.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn import batch_stats
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.layers.base import FeedForwardLayer, Layer, LayerWrapper
from deeplearning4j_tpu_torch.nn.conf.layers.core import _affine


def is_frozen(layer) -> bool:
    """Whether no update touches ``layer``'s params."""
    return getattr(layer, "is_frozen", False)


@serde.register
class FrozenLayer(LayerWrapper):
    """``layer`` run in inference mode and never updated."""

    is_frozen = True

    def __init__(self, layer: Optional[Layer] = None, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer

    @property
    def is_output_layer(self):
        return self.layer.is_output_layer

    @property
    def is_recurrent(self):
        return self.layer.is_recurrent

    @property
    def checkpoint_names(self):
        return getattr(self.layer, "checkpoint_names", ())

    def get_output_type(self, input_type):
        return self.layer.get_output_type(input_type)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self.layer.init_params(gen, input_type, dtype)

    def init_layer_state(self, input_type, dtype=torch.float32):
        return self.layer.init_layer_state(input_type, dtype)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self.layer.apply(params, x, state=state, train=False, rng=rng, mask=mask)

    def compute_score(self, params, x, labels, mask=None):
        return self.layer.compute_score(params, x, labels, mask)


@serde.register
class CenterLossOutputLayer(FeedForwardLayer):
    """Softmax output plus center loss; ``alpha``: the centers' EMA rate
    toward the batch's class means, ``lambda_``: the center loss's weight."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", alpha: float = 0.05,
                 lambda_: float = 2e-4, **kwargs):
        super().__init__(**kwargs)
        self.loss = loss
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in,
                                       self.n_out, dtype),
                "b": self._bias((self.n_out,), dtype)}

    def init_layer_state(self, input_type, dtype=torch.float32):
        return {"centers": torch.zeros((self.n_out, self.n_in), dtype=dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self.act_fn()(_affine(params, x)), state or {}

    def compute_score(self, params, x, labels, mask=None, state=None) -> torch.Tensor:
        """Per-example loss; with ``state``, the center loss against its
        centers is added."""
        score = _losses.get(self.loss)(labels, _affine(params, x), self.activation, mask)
        if state is not None and "centers" in state:
            centers = state["centers"][torch.argmax(labels, dim=-1)]  # (b, n_in)
            score = score + 0.5 * self.lambda_ * torch.sum((x - centers) ** 2, dim=-1)
        return score

    @torch.no_grad()
    def update_centers(self, state, x, labels):
        """The state with each center present in the batch moved by
        ``alpha`` toward its class's mean input; the others kept."""
        centers = state["centers"]
        cls = torch.argmax(labels, dim=-1)
        onehot = (cls[:, None] == torch.arange(self.n_out, device=x.device)).to(x.dtype)
        (sums, counts), _ = batch_stats.global_sums([onehot.T @ x, onehot.sum(dim=0)],
                                                    x.shape[0])
        class_means = sums / torch.clamp(counts, min=1.0)[:, None]
        new = torch.where((counts > 0)[:, None],
                          (1 - self.alpha) * centers + self.alpha * class_means, centers)
        return {**state, "centers": new}
