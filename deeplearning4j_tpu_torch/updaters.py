"""Per-parameter gradient updaters (optimizers).

Counterpart of ``deeplearning4j_tpu/updaters.py``. Each updater is a
:class:`TaggedConf`: it holds exactly the dict that the reference's
``serde.encode`` writes for its counterpart (so configuration dicts match
and round-trip), and has the reference's two methods:

- ``init_state(param)`` -> dict of state tensors (zeros, the param's shape)
- ``apply(grad, state, t, iteration, epoch)`` -> ``(update, new_state)``;
  the train step computes ``param - update``.

``t`` is the 1-based step count. Scalars (learning rate, momentum, bias
corrections) are 0-dim f32 tensors, so they round as the reference's f32
scalars do. This slice ports ``Sgd``, ``NoOp``, ``Nesterovs`` and ``Adam``
(whose :meth:`Adam.alpha` the fused-Adam kernel shares), and ``RmsProp`` as
configuration data; a configuration naming another updater still loads,
and :func:`as_updater` raises when it is trained.

``apply`` takes each per-step scalar through :meth:`Updater.step_scalar`:
the host pipeline (a 0-dim f32 tensor on the CPU), unless a bundled train
step is being captured into a CUDA graph (``train/pipeline.py``). Then a
scalar that changes with the step (Adam's bias-corrected ``alpha``, any
schedule other than a fixed one) comes from a device buffer that the host
fills before each replay by the same pipeline, so that the graph does not
freeze the value of the step it was captured at.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.serde import TaggedConf
from deeplearning4j_tpu_torch.schedules import FixedSchedule, as_schedule

State = Dict[str, torch.Tensor]

#: the scalar feed of a bundled step being captured (``train/pipeline.py``),
#: else None: set only through :func:`scalar_feed`
_FEED = None


class scalar_feed:
    """Context manager: route :meth:`Updater.step_scalar` through ``feed``
    (an object with ``take(updater, kind, t, iteration, epoch)``)."""

    def __init__(self, feed):
        self.feed = feed

    def __enter__(self):
        global _FEED
        self.prev, _FEED = _FEED, self.feed
        return self.feed

    def __exit__(self, *exc):
        global _FEED
        _FEED = self.prev


def _schedule_dict(value) -> dict:
    return {"@schedule": True, **as_schedule(value).to_dict()}


class Updater(TaggedConf):
    """Base updater config: a dict ``{"@type": "updater", "@class": ...}``."""

    def __init__(self, fields: dict):
        super().__init__({"@type": "updater", "@class": type(self).__name__,
                          **fields})

    def _sched(self, key: str, iteration, epoch) -> torch.Tensor:
        return as_schedule(self[key]).value_at(iteration, epoch)

    def lr(self, iteration, epoch) -> torch.Tensor:
        return self._sched("learning_rate", iteration, epoch)

    def scalar_value(self, kind: str, t, iteration, epoch) -> torch.Tensor:
        """The host pipeline of one per-step scalar: ``kind`` is a schedule
        key of this updater ("learning_rate", "momentum") or "alpha"."""
        if kind == "alpha":
            return self.alpha(t, iteration, epoch)
        return self._sched(kind, iteration, epoch)

    def varies(self, kind: str) -> bool:
        """Whether the scalar ``kind`` can change from step to step (a fixed
        schedule cannot)."""
        return kind == "alpha" or not isinstance(as_schedule(self[kind]), FixedSchedule)

    def step_scalar(self, kind: str, t, iteration, epoch) -> torch.Tensor:
        """A per-step scalar as ``apply`` uses it: :meth:`scalar_value`, or,
        while a bundled step is captured, the feed's device scalar for a
        value that varies between steps."""
        if _FEED is None or not self.varies(kind):
            return self.scalar_value(kind, t, iteration, epoch)
        return _FEED.take(self, kind, t, iteration, epoch)

    def init_state(self, param: torch.Tensor) -> State:
        return {}

    def apply(self, grad, state, t, iteration, epoch) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError


class Sgd(Updater):
    def __init__(self, learning_rate=1e-1):
        super().__init__({"learning_rate": _schedule_dict(learning_rate)})

    def apply(self, grad, state, t, iteration, epoch):
        return self.step_scalar("learning_rate", t, iteration, epoch) * grad, state


class NoOp(Updater):
    """Pass the raw gradient through unchanged."""

    def __init__(self):
        super().__init__({"learning_rate": None})

    def apply(self, grad, state, t, iteration, epoch):
        return grad, state


class Nesterovs(Updater):
    """v' = mu*v - lr*g ;  update = mu*v - (1+mu)*v'."""

    def __init__(self, learning_rate=0.1, momentum=0.9):
        super().__init__({"learning_rate": _schedule_dict(learning_rate),
                          "momentum": _schedule_dict(momentum)})

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        mu = self.step_scalar("momentum", t, iteration, epoch)
        v_prev = state["v"]
        v = mu * v_prev - self.step_scalar("learning_rate", t, iteration, epoch) * grad
        return mu * v_prev - (1.0 + mu) * v, {"v": v}


class Adam(Updater):
    def __init__(self, learning_rate=1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__({"learning_rate": _schedule_dict(learning_rate),
                          "beta1": float(beta1), "beta2": float(beta2),
                          "epsilon": float(epsilon)})

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def alpha(self, t, iteration, epoch) -> torch.Tensor:
        """The bias-corrected step size ``lr*sqrt(1-b2^t)/(1-b1^t)``, a 0-dim
        f32 tensor: the one scalar pipeline of :meth:`apply` and of the fused
        update (``nn/ops/fused_update.py``), so both use the same bits."""
        tf = torch.tensor(float(t), dtype=torch.float32)
        return (self.lr(iteration, epoch) * torch.sqrt(1 - self["beta2"] ** tf)
                / (1 - self["beta1"] ** tf))

    def apply(self, grad, state, t, iteration, epoch):
        b1, b2 = self["beta1"], self["beta2"]
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        alpha = self.step_scalar("alpha", t, iteration, epoch)
        return alpha * m / (torch.sqrt(v) + self["epsilon"]), {"m": m, "v": v}


class RmsProp(Updater):
    """Configuration data only (``TextGenerationLSTM.conf()`` names it): it
    writes the reference's dict and makes its one slot, ``r``; training
    with it comes with the recurrent training slice."""

    def __init__(self, learning_rate=1e-1, rms_decay: float = 0.95,
                 epsilon: float = 1e-8):
        super().__init__({"learning_rate": _schedule_dict(learning_rate),
                          "rms_decay": float(rms_decay), "epsilon": float(epsilon)})

    def init_state(self, param):
        return {"r": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        raise NotImplementedError(
            "RmsProp updates are not ported yet (ROADMAP § A, slice 4: the "
            "rest of the training core)")


_UPDATERS = {c.__name__: c for c in (Sgd, NoOp, Nesterovs, Adam, RmsProp)}


def as_updater(conf) -> Updater:
    """The updater for a layer's ``updater`` config: an :class:`Updater`
    passes through; a dict read from JSON becomes its class (same dict);
    None is :class:`NoOp`, as in the reference."""
    if conf is None:
        return NoOp()
    if isinstance(conf, Updater):
        return conf
    name = conf.get("@class")
    if name not in _UPDATERS:
        raise NotImplementedError(
            f"updater {name!r} is not ported yet (ROADMAP § A, training "
            f"slices); ported: {sorted(_UPDATERS)}")
    upd = _UPDATERS[name].__new__(_UPDATERS[name])
    dict.__init__(upd, conf)
    return upd
