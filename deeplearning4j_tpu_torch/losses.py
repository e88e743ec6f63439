"""Loss functions.

Counterpart of ``deeplearning4j_tpu/losses.py``: each loss is a function
``loss(labels, preout, activation, mask) -> per-example score vector``,
differentiated by autograd with the rest of the step, under the
reference's 22 names. Each is the reference's formula in the same
operations, so that the gradient at a clip bound or a tie is the
reference's too: ``jnp.clip`` is :func:`_clip` (min then max), a
``jnp.maximum`` against a constant is ``torch.maximum`` against a filled
tensor (half the gradient at a tie), ``jnp.abs`` is :func:`_abs` (slope 1
at 0) and ``jnp.where`` is ``torch.where``.
Softmax and sigmoid cross-entropies are computed from logits when the
activation is their canonical one.

Masking: ``mask`` broadcasts to the per-element score; masked elements
contribute zero.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from deeplearning4j_tpu_torch import activations as _act

EPS = 1e-7

_clip = _act.clip
_abs = _act.abs_


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``."""
    return torch.maximum(x, torch.full_like(x, lo))


def _out(preout, activation) -> torch.Tensor:
    return _act.get(activation)(preout)


def _reduce_elementwise(per_elem: torch.Tensor, mask: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """Sum per-element scores over the feature axes -> per-example vector."""
    if mask is not None:
        per_elem = per_elem * mask
    dims = tuple(range(1, per_elem.dim()))
    return per_elem.sum(dims) if dims else per_elem


def _sum_rows(per: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, per.dim()))
    return per.sum(dims) if dims else per


def mse(labels, preout, activation=None, mask=None) -> torch.Tensor:
    """Mean over the output features of the squared error."""
    out = _out(preout, activation)
    return _reduce_elementwise((out - labels) ** 2, mask) / labels.shape[-1]


def l2(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    return _reduce_elementwise((out - labels) ** 2, mask)


def mae(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    return _reduce_elementwise(_abs(out - labels), mask) / labels.shape[-1]


def l1(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    return _reduce_elementwise(_abs(out - labels), mask)


def mape(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    den = torch.where(_abs(labels) < EPS, torch.full_like(labels, EPS), labels)
    per = _abs((labels - out) / den) * 100.0
    return _reduce_elementwise(per, mask) / labels.shape[-1]


def msle(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    per = (torch.log1p(_floor(out, -1 + EPS)) - torch.log1p(_floor(labels, -1 + EPS))) ** 2
    return _reduce_elementwise(per, mask) / labels.shape[-1]


def xent(labels, preout, activation="sigmoid", mask=None) -> torch.Tensor:
    """Binary cross-entropy; from logits when the activation is sigmoid."""
    if activation in ("sigmoid", None):
        per = (_floor(preout, 0.0) - preout * labels
               + torch.log1p(torch.exp(-_abs(preout))))
    else:
        out = _clip(_out(preout, activation), EPS, 1 - EPS)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return _reduce_elementwise(per, mask)


def _log_probs(preout, activation) -> torch.Tensor:
    if activation in ("softmax", None):
        return torch.log_softmax(preout, dim=-1)
    return torch.log(_clip(_out(preout, activation), EPS, 1.0))


def mcxent(labels, preout, activation="softmax", mask=None) -> torch.Tensor:
    """Multi-class cross-entropy with one-hot (or soft) labels."""
    return _reduce_elementwise(-labels * _log_probs(preout, activation), mask)


def sparse_mcxent(labels, preout, activation="softmax", mask=None) -> torch.Tensor:
    """MCXENT with integer class-index labels, (B,) or (B, 1)."""
    labels = labels.to(torch.int32)
    if labels.dim() == preout.dim():  # (batch, 1)
        labels = labels.squeeze(-1)
    logp = _log_probs(preout, activation)
    per = -torch.gather(logp, -1, labels[..., None].long()).squeeze(-1)
    if mask is not None:
        m = mask
        while m.dim() > per.dim():
            m = m.squeeze(-1)
        per = per * m
    return _sum_rows(per)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None) -> torch.Tensor:
    """The reference's LossNegativeLogLikelihood: MCXENT for one-hot labels."""
    return mcxent(labels, preout, activation, mask)


def kl_divergence(labels, preout, activation="softmax", mask=None) -> torch.Tensor:
    out = _clip(_out(preout, activation), EPS, 1.0)
    lab = _clip(labels, EPS, 1.0)
    return _reduce_elementwise(labels * (torch.log(lab) - torch.log(out)), mask)


def cosine_proximity(labels, preout, activation=None, mask=None) -> torch.Tensor:
    """Minus the cosine of output and labels; both masked before the norms."""
    out = _out(preout, activation)
    if mask is not None:
        out = out * mask
        labels = labels * mask
    dot = torch.sum(out * labels, dim=-1)
    no = torch.sqrt(torch.sum(out * out, dim=-1) + EPS)
    nl = torch.sqrt(torch.sum(labels * labels, dim=-1) + EPS)
    return _sum_rows(-(dot / (no * nl)))


def hinge(labels, preout, activation=None, mask=None) -> torch.Tensor:
    """Labels in {-1, +1}."""
    out = _out(preout, activation)
    return _reduce_elementwise(_floor(1.0 - labels * out, 0.0), mask)


def squared_hinge(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    return _reduce_elementwise(_floor(1.0 - labels * out, 0.0) ** 2, mask)


def poisson(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _floor(_out(preout, activation), EPS)
    return _reduce_elementwise(out - labels * torch.log(out), mask)


def reconstruction_crossentropy(labels, preout, activation="sigmoid", mask=None
                                ) -> torch.Tensor:
    out = _clip(_out(preout, activation), EPS, 1 - EPS)
    per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return _reduce_elementwise(per, mask)


def wasserstein(labels, preout, activation=None, mask=None) -> torch.Tensor:
    out = _out(preout, activation)
    return _reduce_elementwise(labels * out, mask)


_REGISTRY = {
    "mse": mse,
    "squared_loss": mse,
    "l2": l2,
    "mae": mae,
    "mean_absolute_error": mae,
    "l1": l1,
    "mape": mape,
    "mean_absolute_percentage_error": mape,
    "msle": msle,
    "mean_squared_logarithmic_error": msle,
    "xent": xent,
    "mcxent": mcxent,
    "sparse_mcxent": sparse_mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "kl_divergence": kl_divergence,
    "kld": kl_divergence,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "poisson": poisson,
    "reconstruction_crossentropy": reconstruction_crossentropy,
    "wasserstein": wasserstein,
}

LossLike = Union[str, Callable]


def get(name_or_fn: LossLike) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list:
    return sorted(_REGISTRY)
