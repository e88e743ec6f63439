"""In-graph training telemetry.

Counterpart of ``deeplearning4j_tpu/obs/telemetry.py``: the monitoring
quantities the reference's listeners read every step (the gradient's global
norm, the params' norm, the update's norm and its ratio to the params', the
loss scale, the fault guard's bad-step count) computed inside the train step
on the device, from tensors the step has anyway. A bundled step
(``train/pipeline.py``) stacks them over its K steps beside the scores (on
the card into static buffers of the captured graph), and the host sees them
through one fetch a bundle (:class:`BundleTelemetry`), handed to listeners
with a ``telemetry_done`` hook.

Telemetry only reads: the step's params, updater state and score are the
same bits with it on or off.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import serde

#: host fetches of stacked telemetry in this process (tests count them)
_host_fetches = 0


@serde.register
class TelemetryConf:
    """Which signals the train step computes; ``GlobalConf.telemetry`` (True
    there means all of them). Its JSON is the reference's."""

    def __init__(self, grad_norm: bool = True, param_norm: bool = True,
                 update_ratio: bool = True, loss_scale: bool = True):
        self.grad_norm = bool(grad_norm)
        self.param_norm = bool(param_norm)
        self.update_ratio = bool(update_ratio)
        self.loss_scale = bool(loss_scale)

    def to_dict(self) -> dict:
        return {"@class": "TelemetryConf", "grad_norm": self.grad_norm,
                "param_norm": self.param_norm, "update_ratio": self.update_ratio,
                "loss_scale": self.loss_scale}

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryConf":
        return cls(**{k: v for k, v in d.items() if not k.startswith("@")})

    def key(self) -> tuple:
        """The fields as a hashable tuple (what a cached step holds)."""
        return tuple(sorted((k, v) for k, v in self.to_dict().items() if not k.startswith("@")))

    def __eq__(self, other):
        return isinstance(other, TelemetryConf) and self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"TelemetryConf({dict(self.key())})"


def resolve(model) -> Optional[TelemetryConf]:
    """The model's telemetry configuration, or None when off: ``True`` means
    the defaults; a configuration dict (a zip written before the class was
    registered) is read as its fields."""
    conf = getattr(model.conf.global_conf, "telemetry", None)
    if conf is None or conf is False:
        return None
    if conf is True:
        return TelemetryConf()
    if isinstance(conf, dict):
        return TelemetryConf.from_dict(conf)
    return conf


def telemetry_key(model) -> Optional[tuple]:
    """What a cached train step of ``model`` holds of its telemetry."""
    conf = resolve(model)
    return None if conf is None else conf.key()


# --------------------------------------------------------------------------
# on the device, inside the step
# --------------------------------------------------------------------------
def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every float tensor of ``tree``, a 0-dim f32 tensor,
    the squares summed in f32 whatever the tensors' dtype (a bf16 sum of
    squares overflows at norms a healthy network reaches)."""
    total = None
    device = None
    for t in _leaves(tree):
        if not t.is_floating_point():
            continue
        device = t.device
        s = torch.sum(torch.square(t.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.sqrt(total)


@torch.no_grad()
def step_telemetry(conf: TelemetryConf, grads, params, new_params,
                   fstate: Optional[Dict[str, Any]] = None, scale=None,
                   grad_norm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One step's telemetry dict of 0-dim tensors on the device. ``grads``
    are the unscaled gradients the update read; ``params`` and
    ``new_params`` bracket the update, so a skipped step reports
    ``update_norm`` 0; ``fstate`` is the fault state after the step
    (``bad_count`` is its running count); ``scale`` the loss scale this
    step's loss was multiplied by. ``grad_norm``: the gradient's norm where
    the caller holds it already (the sharded step, whose ranks hold chunks
    of the global gradient)."""
    t: Dict[str, torch.Tensor] = {}
    if conf.grad_norm:
        t["grad_norm"] = global_norm(grads) if grad_norm is None else grad_norm
    pn = None
    if conf.param_norm or conf.update_ratio:
        pn = global_norm(params)
    if conf.param_norm:
        t["param_norm"] = pn
    if conf.update_ratio:
        old = list(_leaves(params))
        new = list(_leaves(new_params))
        un = global_norm([n.to(torch.float32) - o.to(torch.float32)
                          for n, o in zip(new, old) if o.is_floating_point()])
        t["update_norm"] = un
        t["update_ratio"] = un / torch.clamp(pn, min=1e-12)
    if conf.loss_scale and scale is not None:
        t["loss_scale"] = torch.as_tensor(scale).to(torch.float32)
    if fstate is not None:
        t["bad_count"] = fstate["bad_count"]
    return t


def stack_steps(steps: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """K steps' telemetry dicts as one dict of (K,) tensors."""
    return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}


# --------------------------------------------------------------------------
# on the host
# --------------------------------------------------------------------------
class BundleTelemetry:
    """One bundle's stacked telemetry (a single step's is a bundle of one),
    on the device; :meth:`host` copies it to the host at most once, however
    many listeners read it."""

    def __init__(self, tree: Dict[str, torch.Tensor], k: int):
        self.dev = tree
        self.k = int(k)
        self._host: Optional[Dict[str, np.ndarray]] = None
        self.fetch_count = 0

    def __len__(self) -> int:
        return self.k

    def keys(self):
        return self.dev.keys()

    def host(self) -> Dict[str, np.ndarray]:
        """name -> (k,) numpy array."""
        if self._host is None:
            global _host_fetches
            self._host = {k: np.atleast_1d(v.detach().cpu().numpy())
                          for k, v in self.dev.items()}
            self.fetch_count += 1
            _host_fetches += 1
        return self._host

    def step(self, j: int) -> Dict[str, float]:
        """Step ``j``'s signals as floats (fetches the bundle)."""
        return {k: float(v[j]) for k, v in self.host().items()}


def dispatch_telemetry(listeners: Sequence[Any], model, it0: int, epoch: int,
                       bt: BundleTelemetry) -> None:
    """``telemetry_done(model, it0, epoch, bt)`` to every listener that has
    the hook, before the score hooks, so that a listener can fold the
    signals into the records it writes from them."""
    for lst in listeners:
        hook = getattr(lst, "telemetry_done", None)
        if hook is not None:
            hook(model, it0, epoch, bt)
