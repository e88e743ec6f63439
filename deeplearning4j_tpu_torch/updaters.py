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
scalars do. All ten of the reference's updaters are here: ``Sgd``,
``NoOp``, ``Nesterovs``, ``Adam`` (whose :meth:`Adam.alpha` the fused-Adam
kernel shares), ``AdaMax``, ``Nadam``, ``AMSGrad``, ``AdaGrad``,
``AdaDelta`` and ``RmsProp``, with the reference's slot names (the zip's
``updaterState.bin`` orders slots by name). :func:`get` resolves a name as
the reference's ``updaters.get`` does.

``apply`` takes each per-step scalar through :meth:`Updater.step_scalar`:
the host pipeline (a 0-dim f32 tensor on the CPU), unless a bundled train
step is being captured into a CUDA graph (``train/pipeline.py``). Then a
scalar that changes with the step comes from a device buffer that the host
fills before each replay by the same pipeline, so that the graph does not
freeze the value of the step it was captured at. Such a scalar is any
schedule other than a fixed one, or one of the class's ``T_KINDS``: the
scalars computed from ``t`` (a bias correction, alone or times the learning
rate), each a method of the class named by its kind. ``apply`` computes
nothing from ``t`` itself, and multiplies by a per-step scalar, never
divides by one (see :class:`Nadam`).

Under a fault policy (``train/faults.py``) the guarded step's clock is the
fault state's ``good_count``, a 0-dim int32 tensor on the device: ``t`` is
then that tensor plus one, and the ``T_KINDS`` and iteration schedules are
computed on the device from it by the same operations as on the host
(bit-equal on the CPU), so that no step reads the clock back and a bundle's
captured graph follows the skips. A schedule that reads only the epoch (a
host count) still comes from the bundle's feed there.
"""

from __future__ import annotations

import copy
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


def step_iteration(iteration: int):
    """The host iteration of the step being run, as the step sees it:
    ``iteration`` itself, or, while a bundled step is captured, the device
    scalar that the host fills with each step's iteration before a replay
    (what fault injection compares, ``train/faults.py``)."""
    return iteration if _FEED is None else _FEED.iteration(iteration)


def _schedule_dict(value) -> dict:
    return {"@schedule": True, **as_schedule(value).to_dict()}


def _f32(t) -> torch.Tensor:
    """The step count as a 0-dim f32 tensor (on ``t``'s device)."""
    return (t.to(torch.float32) if isinstance(t, torch.Tensor)
            else torch.tensor(float(t), dtype=torch.float32))


class Updater(TaggedConf):
    """Base updater config: a dict ``{"@type": "updater", "@class": ...}``.
    An updater with a learning rate takes ``DEFAULT_LR`` for None, as in
    the reference."""

    DEFAULT_LR = 1e-3
    #: the per-step scalars computed from ``t``, each by the method of its name
    T_KINDS: Tuple[str, ...] = ()

    def __init__(self, fields: dict):
        super().__init__({"@type": "updater", "@class": type(self).__name__,
                          **fields})

    @classmethod
    def _lr(cls, learning_rate) -> dict:
        return _schedule_dict(cls.DEFAULT_LR if learning_rate is None else learning_rate)

    def _sched(self, key: str, iteration, epoch) -> torch.Tensor:
        return as_schedule(self[key]).value_at(iteration, epoch)

    def lr(self, iteration, epoch) -> torch.Tensor:
        return self._sched("learning_rate", iteration, epoch)

    def _lr_in(self, t, iteration, epoch) -> torch.Tensor:
        """The learning rate inside a ``T_KINDS`` scalar: on the guarded
        step's device clock through :meth:`step_scalar` (an epoch schedule
        then comes from the bundle's feed), else the host's."""
        if isinstance(t, torch.Tensor):
            return self.step_scalar("learning_rate", t, iteration, epoch)
        return self.lr(iteration, epoch)

    def scalar_value(self, kind: str, t, iteration, epoch) -> torch.Tensor:
        """The host pipeline of one per-step scalar: ``kind`` is a schedule
        key of this updater ("learning_rate", "momentum") or one of its
        ``T_KINDS``."""
        if kind in self.T_KINDS:
            return getattr(self, kind)(t, iteration, epoch)
        return self._sched(kind, iteration, epoch)

    def varies(self, kind: str) -> bool:
        """Whether the scalar ``kind`` can change from step to step (a fixed
        schedule cannot)."""
        return kind in self.T_KINDS or not isinstance(as_schedule(self[kind]), FixedSchedule)

    def step_scalar(self, kind: str, t, iteration, epoch) -> torch.Tensor:
        """A per-step scalar as ``apply`` uses it: :meth:`scalar_value`, or,
        while a bundled step is captured, the feed's device scalar for a
        value that varies between steps. A device ``t`` (the guarded step's
        clock) is computed from on the device, feed or not, except by a
        schedule that reads only the epoch."""
        if _FEED is None or not self.varies(kind):
            return self.scalar_value(kind, t, iteration, epoch)
        if isinstance(t, torch.Tensor):
            if kind in self.T_KINDS or as_schedule(self[kind]).reads_iteration():
                return self.scalar_value(kind, t, iteration, epoch)
            return _FEED.take(self, kind, _FEED.base, _FEED.base, epoch)
        return _FEED.take(self, kind, t, iteration, epoch)

    def init_state(self, param: torch.Tensor) -> State:
        return {}

    def to_dict(self) -> dict:
        """The reference's ``Updater.to_dict``: ``@class``, then the fields,
        a schedule as its ``{"@schedule": True, ...}`` dict."""
        return {k: v for k, v in copy.deepcopy(dict(self)).items() if k != "@type"}

    @staticmethod
    def from_dict(d: dict) -> "Updater":
        """The updater a :meth:`to_dict` dict (the reference's, or one read
        from JSON) describes."""
        return as_updater({"@type": "updater", **d})

    def apply(self, grad, state, t, iteration, epoch) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError


class Sgd(Updater):
    DEFAULT_LR = 1e-1

    def __init__(self, learning_rate=None):
        super().__init__({"learning_rate": self._lr(learning_rate)})

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

    DEFAULT_LR = 0.1

    def __init__(self, learning_rate=None, momentum=0.9):
        super().__init__({"learning_rate": self._lr(learning_rate),
                          "momentum": _schedule_dict(momentum)})

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        mu = self.step_scalar("momentum", t, iteration, epoch)
        v_prev = state["v"]
        v = mu * v_prev - self.step_scalar("learning_rate", t, iteration, epoch) * grad
        return mu * v_prev - (1.0 + mu) * v, {"v": v}


class _Betas(Updater):
    """The Adam family's configuration: a learning rate, beta1, beta2 and
    epsilon."""

    def __init__(self, learning_rate=None, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__({"learning_rate": self._lr(learning_rate),
                          "beta1": float(beta1), "beta2": float(beta2),
                          "epsilon": float(epsilon)})

    def _moments(self, grad, state):
        b1, b2 = self["beta1"], self["beta2"]
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        return m, v

    def _adam_alpha(self, t, iteration, epoch) -> torch.Tensor:
        tf = _f32(t)
        return (self._lr_in(t, iteration, epoch) * torch.sqrt(1 - self["beta2"] ** tf)
                / (1 - self["beta1"] ** tf))


class Adam(_Betas):
    T_KINDS = ("alpha",)

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def alpha(self, t, iteration, epoch) -> torch.Tensor:
        """The bias-corrected step size ``lr*sqrt(1-b2^t)/(1-b1^t)``, a 0-dim
        f32 tensor: the one scalar pipeline of :meth:`apply` and of the fused
        update (``nn/ops/fused_update.py``), so both use the same bits. A
        tensor ``t`` (the guarded step's clock) gives alpha on its device."""
        return self._adam_alpha(t, iteration, epoch)

    def apply(self, grad, state, t, iteration, epoch):
        m, v = self._moments(grad, state)
        alpha = self.step_scalar("alpha", t, iteration, epoch)
        return alpha * m / (torch.sqrt(v) + self["epsilon"]), {"m": m, "v": v}


class AMSGrad(_Betas):
    """Adam with the running maximum of v (slot ``v_hat``) in the
    denominator. Not an ``Adam``: the fused Adam never takes it."""

    T_KINDS = ("alpha",)

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "v_hat": torch.zeros_like(param)}

    def alpha(self, t, iteration, epoch) -> torch.Tensor:
        """``lr*sqrt(1-b2^t)/(1-b1^t)``, as :meth:`Adam.alpha`."""
        return self._adam_alpha(t, iteration, epoch)

    def apply(self, grad, state, t, iteration, epoch):
        m, v = self._moments(grad, state)
        v_hat = torch.maximum(state["v_hat"], v)
        alpha = self.step_scalar("alpha", t, iteration, epoch)
        return (alpha * m / (torch.sqrt(v_hat) + self["epsilon"]),
                {"m": m, "v": v, "v_hat": v_hat})


class AdaMax(_Betas):
    """m' = b1*m + (1-b1)*g ; u' = max(b2*u, |g|) ;
    update = lr/(1-b1^t) * m' / (u' + eps)."""

    T_KINDS = ("alpha",)

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    def alpha(self, t, iteration, epoch) -> torch.Tensor:
        """``lr/(1-b1^t)``."""
        return self._lr_in(t, iteration, epoch) / (1 - self["beta1"] ** _f32(t))

    def apply(self, grad, state, t, iteration, epoch):
        b1 = self["beta1"]
        m = b1 * state["m"] + (1 - b1) * grad
        u = torch.maximum(self["beta2"] * state["u"], torch.abs(grad))
        alpha = self.step_scalar("alpha", t, iteration, epoch)
        return alpha * m / (u + self["epsilon"]), {"m": m, "u": u}


class Nadam(_Betas):
    """Adam with Nesterov momentum: m_hat = m'/(1-b1^(t+1)), g_hat =
    g/(1-b1^t), v_hat = v'/(1-b2^t);
    update = lr*(b1*m_hat + (1-b1)*g_hat) / (sqrt(v_hat) + eps).

    The three bias corrections are per-step scalars, taken as reciprocals
    and multiplied: on the card a tensor divided by a host scalar is
    multiplied by its reciprocal, by a device scalar (a bundle's feed) truly
    divided, and the two would differ in the last bit."""

    T_KINDS = ("inv_bias1_next", "inv_bias1", "inv_bias2")

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def inv_bias1_next(self, t, iteration, epoch) -> torch.Tensor:
        """``1/(1 - b1^(t+1))``."""
        return 1 / (1 - self["beta1"] ** (_f32(t) + 1.0))

    def inv_bias1(self, t, iteration, epoch) -> torch.Tensor:
        """``1/(1 - b1^t)``."""
        return 1 / (1 - self["beta1"] ** _f32(t))

    def inv_bias2(self, t, iteration, epoch) -> torch.Tensor:
        """``1/(1 - b2^t)``."""
        return 1 / (1 - self["beta2"] ** _f32(t))

    def apply(self, grad, state, t, iteration, epoch):
        b1 = self["beta1"]
        m, v = self._moments(grad, state)
        m_hat = m * self.step_scalar("inv_bias1_next", t, iteration, epoch)
        g_hat = grad * self.step_scalar("inv_bias1", t, iteration, epoch)
        v_hat = v * self.step_scalar("inv_bias2", t, iteration, epoch)
        lr = self.step_scalar("learning_rate", t, iteration, epoch)
        update = lr * (b1 * m_hat + (1 - b1) * g_hat) / (torch.sqrt(v_hat) + self["epsilon"])
        return update, {"m": m, "v": v}


class AdaGrad(Updater):
    """h' = h + g² ; update = lr*g / (sqrt(h') + eps)."""

    DEFAULT_LR = 1e-1

    def __init__(self, learning_rate=None, epsilon: float = 1e-6):
        super().__init__({"learning_rate": self._lr(learning_rate),
                          "epsilon": float(epsilon)})

    def init_state(self, param):
        return {"h": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        h = state["h"] + grad * grad
        lr = self.step_scalar("learning_rate", t, iteration, epoch)
        return lr * grad / (torch.sqrt(h) + self["epsilon"]), {"h": h}


class AdaDelta(Updater):
    """No learning rate (``learning_rate`` is None in its dict):
    msg' = rho*msg + (1-rho)*g² ; update = g*sqrt(msdx+eps)/sqrt(msg'+eps) ;
    msdx' = rho*msdx + (1-rho)*update²."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        super().__init__({"learning_rate": None, "rho": float(rho),
                          "epsilon": float(epsilon)})

    def init_state(self, param):
        return {"msg": torch.zeros_like(param), "msdx": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        rho, eps = self["rho"], self["epsilon"]
        msg = rho * state["msg"] + (1 - rho) * grad * grad
        update = grad * torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps)
        msdx = rho * state["msdx"] + (1 - rho) * update * update
        return update, {"msg": msg, "msdx": msdx}


class RmsProp(Updater):
    """r' = decay*r + (1-decay)*g² ; update = lr*g / sqrt(r' + eps)."""

    DEFAULT_LR = 1e-1

    def __init__(self, learning_rate=None, rms_decay: float = 0.95,
                 epsilon: float = 1e-8):
        super().__init__({"learning_rate": self._lr(learning_rate),
                          "rms_decay": float(rms_decay), "epsilon": float(epsilon)})

    def init_state(self, param):
        return {"r": torch.zeros_like(param)}

    def apply(self, grad, state, t, iteration, epoch):
        d = self["rms_decay"]
        r = d * state["r"] + (1 - d) * grad * grad
        lr = self.step_scalar("learning_rate", t, iteration, epoch)
        return lr * grad / torch.sqrt(r + self["epsilon"]), {"r": r}


_UPDATERS = {c.__name__: c for c in (Sgd, NoOp, Nesterovs, Adam, AdaMax, Nadam, AMSGrad,
                                     AdaGrad, AdaDelta, RmsProp)}


def get(name_or_obj) -> Updater:
    """An updater passes through; a name (case-insensitive class name) gives
    that class's default instance, as the reference's ``updaters.get``."""
    if isinstance(name_or_obj, Updater):
        return name_or_obj
    key = str(name_or_obj).lower()
    for name, cls in _UPDATERS.items():
        if name.lower() == key:
            return cls()
    raise ValueError(f"Unknown updater '{name_or_obj}'. Known: {sorted(_UPDATERS)}")


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
        raise ValueError(f"Unknown updater {name!r}. Known: {sorted(_UPDATERS)}")
    upd = _UPDATERS[name].__new__(_UPDATERS[name])
    dict.__init__(upd, conf)
    return upd
