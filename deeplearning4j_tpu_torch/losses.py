"""Loss functions.

Counterpart of ``deeplearning4j_tpu/losses.py``: each loss is a function
``loss(labels, preout, activation, mask) -> per-example score vector``,
differentiated by autograd with the rest of the step. Softmax
cross-entropy is computed from logits (log-softmax) when the activation is
softmax. This slice ports ``mcxent`` (and ``negativeloglikelihood``, the
same function for one-hot labels); the reference's other losses raise.

Masking: ``mask`` broadcasts to the per-element score; masked elements
contribute zero.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from deeplearning4j_tpu_torch import activations as _act

EPS = 1e-7


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as min(max(x, lo), hi), so the gradient at a bound is
    the reference's (0.5 at a tie)."""
    lo_t = torch.full_like(x, lo)
    return torch.minimum(torch.maximum(x, lo_t), torch.full_like(x, hi))


def _reduce_elementwise(per_elem: torch.Tensor, mask: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """Sum per-element scores over the feature axes -> per-example vector."""
    if mask is not None:
        per_elem = per_elem * mask
    dims = tuple(range(1, per_elem.dim()))
    return per_elem.sum(dims) if dims else per_elem


def mcxent(labels, preout, activation="softmax", mask=None) -> torch.Tensor:
    """Multi-class cross-entropy with one-hot (or soft) labels."""
    if activation in ("softmax", None):
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(_clip(_act.get(activation)(preout), EPS, 1.0))
    return _reduce_elementwise(-labels * logp, mask)


_REGISTRY = {"mcxent": mcxent, "negativeloglikelihood": mcxent}

#: the reference's other losses: a configuration may name them, training
#: with them raises
_NOT_PORTED = ("mse", "squared_loss", "l2", "mae", "mean_absolute_error", "l1",
               "mape", "mean_absolute_percentage_error", "msle",
               "mean_squared_logarithmic_error", "xent", "sparse_mcxent",
               "kl_divergence", "kld", "cosine_proximity", "hinge",
               "squared_hinge", "poisson", "reconstruction_crossentropy",
               "wasserstein")

LossLike = Union[str, Callable]


def get(name_or_fn: LossLike) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"loss '{name_or_fn}' is not ported yet (ROADMAP § A, training "
            f"slices); ported: {sorted(_REGISTRY)}")
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: "
                         f"{sorted((*_REGISTRY, *_NOT_PORTED))}")
    return _REGISTRY[key]
