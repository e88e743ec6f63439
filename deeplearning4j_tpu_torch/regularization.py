"""Regularization and gradient normalization.

Counterpart of ``deeplearning4j_tpu/regularization.py``:

- :class:`RegularizationConf`: per-layer l1/l2/weight-decay coefficients,
  weights vs biases, applied to the gradient before the updater
  (:meth:`~RegularizationConf.grad_term`) and to the score
  (:meth:`~RegularizationConf.score_term`). A parameter whose name starts
  with ``b`` (or contains "bias") takes the bias coefficients: so a
  bottleneck's ``beta_*`` gets no l2 while its ``gamma_*`` and ``W_*`` do,
  exactly as in the reference.
- :func:`normalize_layer_gradients`: the gradient-normalization modes.
- The parameter constraints (:class:`MaxNormConstraint`,
  :class:`MinMaxNormConstraint`, :class:`NonNegativeConstraint`,
  :class:`UnitNormConstraint`), applied to a layer's new params after each
  update, last (``nn/multilayer.apply_layer_updates``,
  ``parallel/zero.apply_sharded_updates``). Only a param named exactly
  ``W`` is constrained (``applies_to``); norms are taken over every axis but
  the last (per output unit: a dense ``W`` (nIn, nOut), an HWIO conv
  kernel). They serialize as the reference's ``{"@type": "constraint",
  "@class": ..., ...}`` dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.serde import TaggedConf


class RegularizationConf(TaggedConf):
    """The reference's ``{"@type": "regularization", ...}`` dict, with the
    regularizer's math."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0, l1_bias: float = 0.0,
                 l2_bias: float = 0.0, weight_decay: float = 0.0,
                 weight_decay_bias: float = 0.0):
        super().__init__({"@type": "regularization", "l1": float(l1),
                          "l2": float(l2), "l1_bias": float(l1_bias),
                          "l2_bias": float(l2_bias),
                          "weight_decay": float(weight_decay),
                          "weight_decay_bias": float(weight_decay_bias)})

    def coeffs_for(self, param_name: str):
        """(l1, l2, weight_decay) for a parameter by name ('b*' = bias)."""
        if param_name.startswith("b") or "bias" in param_name.lower():
            return self["l1_bias"], self["l2_bias"], self["weight_decay_bias"]
        return self["l1"], self["l2"], self["weight_decay"]

    def grad_term(self, param_name: str, param: torch.Tensor) -> Optional[torch.Tensor]:
        """dReg/dParam, added to the raw gradient (None when zero). Weight
        decay is folded into the gradient, as the reference does."""
        l1, l2, wd = self.coeffs_for(param_name)
        term = None
        if l2:
            term = l2 * param
        if l1:
            t = l1 * torch.sign(param)
            term = t if term is None else term + t
        if wd:
            t = wd * param
            term = t if term is None else term + t
        return term

    def to_dict(self) -> dict:
        """The reference's ``to_dict``: the six coefficients."""
        return {k: v for k, v in self.items() if k != "@type"}

    @staticmethod
    def from_dict(d: dict) -> "RegularizationConf":
        return RegularizationConf(**{k: v for k, v in d.items() if not k.startswith("@")})

    def score_term(self, param_name: str, param: torch.Tensor) -> torch.Tensor:
        """0.5*l2*sum(p^2) + l1*sum|p|, accumulated in f32 (f64 stays f64)."""
        l1, l2, _ = self.coeffs_for(param_name)
        p = param.to(torch.promote_types(param.dtype, torch.float32))
        s = torch.zeros((), dtype=p.dtype, device=p.device)
        if l2:
            s = s + 0.5 * l2 * torch.sum(p ** 2)
        if l1:
            s = s + l1 * torch.sum(torch.abs(p))
        return s


def as_regularization(conf) -> Optional[RegularizationConf]:
    """A layer's ``regularization`` config as a :class:`RegularizationConf`
    (a dict read from JSON becomes one; None stays None)."""
    if conf is None or isinstance(conf, RegularizationConf):
        return conf
    reg = RegularizationConf.__new__(RegularizationConf)
    dict.__init__(reg, conf)
    return reg


def normalize_layer_gradients(grads: Dict[str, torch.Tensor], mode: Optional[str],
                              threshold: float = 1.0, eps: float = 1e-8
                              ) -> Dict[str, torch.Tensor]:
    """Apply a gradient-normalization mode to one layer's gradient dict, on
    the raw gradients before the updater (reference ``preApply``)."""
    if not mode or mode == "none" or not grads:
        return grads
    mode = mode.lower()

    def sq(g):
        return torch.sum(g.to(torch.float32) ** 2)

    if mode == "renormalize_l2_per_layer":
        norm = torch.sqrt(sum(sq(g) for g in grads.values()) + eps)
        return {k: g / norm for k, g in grads.items()}
    if mode == "renormalize_l2_per_param_type":
        return {k: g / torch.sqrt(sq(g) + eps) for k, g in grads.items()}
    if mode == "clip_element_wise_absolute_value":
        return {k: torch.clamp(g, -threshold, threshold) for k, g in grads.items()}
    if mode == "clip_l2_per_layer":
        norm = torch.sqrt(sum(sq(g) for g in grads.values()) + eps)
        scale = torch.where(norm > threshold, threshold / norm, 1.0)
        return {k: g * scale for k, g in grads.items()}
    if mode == "clip_l2_per_param_type":
        out = {}
        for k, g in grads.items():
            norm = torch.sqrt(sq(g) + eps)
            out[k] = g * torch.where(norm > threshold, threshold / norm, 1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{mode}'")


# ---------------------------------------------------------------------------
# Constraints (applied to params after each update)
# ---------------------------------------------------------------------------
class Constraint:
    """Base parameter constraint (reference ``nn/conf/constraint/BaseConstraint``)."""

    applies_to = ("W",)  # param names; the reference constrains weights only

    def apply(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@type": "constraint", "@class": type(self).__name__, **self.__dict__}

    @staticmethod
    def from_dict(d: dict) -> "Constraint":
        d = {k: v for k, v in d.items() if k != "@type"}
        cls = _CONSTRAINTS[d.pop("@class")]
        obj = cls.__new__(cls)
        obj.__dict__.update(d)
        return obj

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def _norm(param: torch.Tensor) -> torch.Tensor:
    """The L2 norm over every axis but the last (per output unit), kept as
    broadcastable dims, with the reference's ``+ 1e-12`` under the root."""
    axes = tuple(range(param.dim() - 1)) if param.dim() > 1 else (0,)
    return torch.sqrt(torch.sum(param ** 2, dim=axes, keepdim=True) + 1e-12)


@serde.register
class MaxNormConstraint(Constraint):
    def __init__(self, max_norm: float = 1.0):
        self.max_norm = float(max_norm)

    def apply(self, param):
        return param * torch.clamp(self.max_norm / _norm(param), max=1.0)


@serde.register
class MinMaxNormConstraint(Constraint):
    def __init__(self, min_norm: float = 0.0, max_norm: float = 1.0, rate: float = 1.0):
        self.min_norm = float(min_norm)
        self.max_norm = float(max_norm)
        self.rate = float(rate)

    def apply(self, param):
        norm = _norm(param)
        clipped = torch.clamp(norm, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1 - self.rate) * norm
        return param * (target / norm)


@serde.register
class NonNegativeConstraint(Constraint):
    def __init__(self):
        pass

    def apply(self, param):
        return torch.clamp(param, min=0.0)


@serde.register
class UnitNormConstraint(Constraint):
    def __init__(self):
        pass

    def apply(self, param):
        return param / _norm(param)


_CONSTRAINTS = {
    c.__name__: c
    for c in [MaxNormConstraint, MinMaxNormConstraint, NonNegativeConstraint, UnitNormConstraint]
}


def apply_constraints(layer, new_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A layer's constraints over its new params, in the configured order
    (the reference's ``BaseOptimizer.applyConstraints``); ``new_params`` is
    not changed."""
    if not layer.constraints:
        return new_params
    out = dict(new_params)
    for c in layer.constraints:
        for name in out:
            if name in c.applies_to:
                out[name] = c.apply(out[name])
    return out
