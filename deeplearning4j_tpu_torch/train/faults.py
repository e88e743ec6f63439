"""Step-level training fault tolerance: the fault policy, the non-finite
guard, dynamic loss scaling, fault injection and the checkpoint helpers.

Counterpart of ``deeplearning4j_tpu/train/faults.py`` (``:60-356`` and the
checkpoint helpers ``:380-606``: validation, retention, the newest valid
checkpoint):

- :class:`FaultPolicy` rides on ``GlobalConf.fault_policy`` and round-trips
  through the configuration JSON of either package, key for key.
- The guarded train step (both models' ``_apply_step``, the wrapper's
  replicated and ZeRO-1 steps, ``SharedTrainingMaster``) multiplies the loss
  by the loss scale and the gradients by its inverse, injects the armed
  faults, takes one verdict over every float gradient (:func:`all_finite`),
  runs the updater at ``t = good_count + 1`` and iteration ``good_count``,
  keeps params, updater state and layer state where the verdict is false
  (:func:`where_tree`: ``torch.where`` on the 0-dim verdict, no branch) and
  advances the fault state (:func:`advance_fault_state`).
- The fault state is a dict of 0-dim tensors on the model's device:
  ``bad_count``, ``consec``, ``good_count`` and, with loss scaling,
  ``loss_scale`` and ``scale_good``. Nothing of it leaves the device during
  a step, so an eager step syncs with the host only where the tripwire is
  armed (``max_consecutive_bad_steps``), and a bundled step carries it in
  its captured graph. The host iteration counter keeps counting every batch
  seen; the updater's clock is ``good_count``, so a skipped batch leaves
  the run exactly as if it had been removed.
- :func:`check_fault_state` is the host-side tripwire, run after each
  eager step and once per bundle.

The reference's flight-recorder events (``nan_skip``, ``divergence_trip``
and the dump before the raise, ``tmp_sweep``, ``checkpoint_write``,
``checkpoint_fallback``, ``checkpoint_load``) come with ROADMAP § A9; here
the tripwire returns the per-owner bad-count delta that would feed them,
and raises. Checkpoint retention (:func:`save_checkpoint` with
``keep_last``, :func:`prune_checkpoints`, :func:`sweep_stale_tmp`,
:func:`load_latest_valid`) writes and removes files with plain ``os``
calls, where the reference goes through its chaos file layer (also § A9).
Elastic training comes with § A8.
"""

from __future__ import annotations

import contextlib
import functools
import os
import uuid
import warnings
import weakref
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.train.pipeline import tree_leaves, tree_map

_TMP_MARKER = ".tmp-"

FaultState = Dict[str, torch.Tensor]


class TrainingDivergedError(RuntimeError):
    """Raised when ``max_consecutive_bad_steps`` non-finite gradient steps
    occur back to back: the run is diverging, not hitting stray bad
    batches, and skipping forever would hide it."""


# --------------------------------------------------------------------------
# policy
# --------------------------------------------------------------------------
class FaultPolicy:
    """Training fault-tolerance configuration, carried on
    ``GlobalConf.fault_policy`` (JSON round-trips with the network conf).

    - ``skip_nonfinite``: skip the weight update on a non-finite gradient
      instead of poisoning the parameters.
    - ``max_consecutive_bad_steps``: raise :class:`TrainingDivergedError`
      after this many back-to-back skipped steps (None = never; checking
      costs one host sync per step, so it is opt-in).
    - ``loss_scaling``: dynamic loss scaling. None (default) turns it on
      exactly when the model trains with a reduced ``compute_dtype``;
      True/False force it.
    - ``init_loss_scale`` / ``scale_growth_interval`` / ``scale_backoff`` /
      ``scale_growth`` / ``min_loss_scale`` / ``max_loss_scale``: the
      loss-scale schedule (back off on overflow, grow after N good steps).
    - ``keep_last``: checkpoint retention, carried as configuration as the
      reference carries it (no step reads it; :func:`save_checkpoint`
      takes its own ``keep_last``).
    """

    def __init__(self, skip_nonfinite: bool = True,
                 max_consecutive_bad_steps: Optional[int] = None,
                 loss_scaling: Optional[bool] = None,
                 init_loss_scale: float = 2.0 ** 15,
                 scale_growth_interval: int = 200,
                 scale_backoff: float = 0.5,
                 scale_growth: float = 2.0,
                 min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0 ** 24,
                 keep_last: Optional[int] = None):
        self.skip_nonfinite = bool(skip_nonfinite)
        self.max_consecutive_bad_steps = (None if max_consecutive_bad_steps is None
                                          else int(max_consecutive_bad_steps))
        self.loss_scaling = loss_scaling if loss_scaling is None else bool(loss_scaling)
        self.init_loss_scale = float(init_loss_scale)
        self.scale_growth_interval = int(scale_growth_interval)
        self.scale_backoff = float(scale_backoff)
        self.scale_growth = float(scale_growth)
        self.min_loss_scale = float(min_loss_scale)
        self.max_loss_scale = float(max_loss_scale)
        self.keep_last = None if keep_last is None else int(keep_last)

    def scaling_active(self, compute_dtype) -> bool:
        """Loss scaling applies iff forced on, or (by default) the model
        computes in a reduced dtype, whose backward can overflow."""
        if self.loss_scaling is not None:
            return self.loss_scaling
        return compute_dtype is not None

    def guard_active(self, compute_dtype) -> bool:
        return (self.skip_nonfinite or self.max_consecutive_bad_steps is not None
                or self.scaling_active(compute_dtype))

    def skips(self, compute_dtype) -> bool:
        """Whether a non-finite step keeps the old state: with
        ``skip_nonfinite``, and always under loss scaling (an overflowed
        step is dropped while the scale backs off)."""
        return self.skip_nonfinite or self.scaling_active(compute_dtype)

    def to_dict(self) -> dict:
        return {
            "@class": "FaultPolicy",
            "skip_nonfinite": self.skip_nonfinite,
            "max_consecutive_bad_steps": self.max_consecutive_bad_steps,
            "loss_scaling": self.loss_scaling,
            "init_loss_scale": self.init_loss_scale,
            "scale_growth_interval": self.scale_growth_interval,
            "scale_backoff": self.scale_backoff,
            "scale_growth": self.scale_growth,
            "min_loss_scale": self.min_loss_scale,
            "max_loss_scale": self.max_loss_scale,
            "keep_last": self.keep_last,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPolicy":
        return cls(**{k: v for k, v in d.items() if not k.startswith("@")})

    def __eq__(self, other):
        return isinstance(other, FaultPolicy) and self.to_dict() == other.to_dict()

    def __repr__(self):
        fields = {k: v for k, v in self.to_dict().items() if not k.startswith("@")}
        return f"FaultPolicy({fields})"


def _register_serde():
    from deeplearning4j_tpu_torch.nn.conf import serde

    serde.register(FaultPolicy)


_register_serde()


def active_policy(policy: Optional[FaultPolicy], compute_dtype) -> Optional[FaultPolicy]:
    """The policy iff its guard has anything to do for this model."""
    if policy is None or not policy.guard_active(compute_dtype):
        return None
    return policy


# --------------------------------------------------------------------------
# the fault state and the guarded step's parts
# --------------------------------------------------------------------------
def init_fault_state(policy: FaultPolicy, scaling: bool, start_step: int = 0,
                     device=None) -> FaultState:
    """The fault state's 0-dim tensors on ``device``. ``good_count`` starts
    at the model's iteration, so a resumed run keeps its updater clock."""
    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    st = {"bad_count": i32(0), "consec": i32(0), "good_count": i32(start_step)}
    if scaling:
        st["loss_scale"] = torch.tensor(policy.init_loss_scale, dtype=torch.float32,
                                        device=device)
        st["scale_good"] = i32(0)
    return st


def all_finite(tree) -> torch.Tensor:
    """0-dim bool tensor: every element of every float tensor in ``tree``
    (nested dicts and lists) is finite. Each tensor times 0 is 0 where it is
    finite and NaN elsewhere, so its norm is finite exactly when the tensor
    is: two multi-tensor passes over all of them (``_foreach_mul``,
    ``_foreach_norm``) in place of a reduction a tensor; on the device,
    nothing read back."""
    leaves = [t for t in tree_leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    norms = torch._foreach_norm(torch._foreach_mul(leaves, 0.0))
    return torch.isfinite(torch.stack(norms)).all()


def where_tree(finite: torch.Tensor, new, old):
    """``new`` where ``finite``, else ``old``, tensor by tensor over two
    trees of one structure: the skip, with no branch and no host sync.
    Entries that are one object in both pass through."""
    if new is old:
        return new
    if isinstance(new, dict):
        return {k: where_tree(finite, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(where_tree(finite, n, o) for n, o in zip(new, old))
    if isinstance(new, torch.Tensor):
        return torch.where(finite, new, old)
    return new


def advance_fault_state(policy: FaultPolicy, fstate: FaultState,
                        finite: torch.Tensor) -> FaultState:
    """The next fault state given this step's verdict."""
    fin_i = finite.to(torch.int32)
    consec = fstate["consec"]
    new = {
        "bad_count": fstate["bad_count"] + (1 - fin_i),
        "consec": torch.where(finite, torch.zeros_like(consec), consec + 1),
        "good_count": fstate["good_count"] + fin_i,
    }
    if "loss_scale" in fstate:
        scale, good = fstate["loss_scale"], fstate["scale_good"]
        grown = (good + 1) >= policy.scale_growth_interval
        up = torch.clamp(scale * policy.scale_growth, max=policy.max_loss_scale)
        down = torch.clamp(scale * policy.scale_backoff, min=policy.min_loss_scale)
        new["loss_scale"] = torch.where(finite, torch.where(grown, up, scale), down)
        new["scale_good"] = torch.where(finite & ~grown, good + 1, torch.zeros_like(good))
    return new


def unscale(loss: torch.Tensor, grads, scale: Optional[torch.Tensor]):
    """``(loss * inv, grads * inv)`` with ``inv = 1 / scale``, the loss and
    gradients of a loss that was multiplied by ``scale`` (unchanged when
    ``scale`` is None); the gradients in one multi-tensor pass."""
    if scale is None:
        return loss, grads
    inv = 1.0 / scale
    floats = [t for t in tree_leaves(grads) if t.is_floating_point()]
    done = dict(zip(map(id, floats), torch._foreach_mul(floats, inv))) if floats else {}
    return loss * inv, tree_map(lambda g: done.get(id(g), g), grads)


class GuardedModel:
    """The fault-policy surface of ``MultiLayerNetwork`` and
    ``ComputationGraph`` (the reference's ``_active_fault_policy``,
    ``_ensure_fault_state``, ``set_fault_policy``, ``bad_step_count``,
    ``loss_scale``). The model holds ``conf``, ``_compute_dtype``,
    ``iteration``, ``device``, ``_bundled`` and ``fault_state_``."""

    def _active_fault_policy(self) -> Optional[FaultPolicy]:
        return active_policy(getattr(self.conf.global_conf, "fault_policy", None),
                             self._compute_dtype)

    def _ensure_fault_state(self, policy: FaultPolicy, scaling: Optional[bool] = None
                            ) -> FaultState:
        """The fault state, made when missing or when it disagrees with the
        policy on loss scaling (``scaling`` overrides the policy's, as the
        shared-training master, which never scales, asks)."""
        if scaling is None:
            scaling = policy.scaling_active(self._compute_dtype)
        fs = self.fault_state_
        if fs is None or ("loss_scale" in fs) != scaling:
            self.fault_state_ = init_fault_state(policy, scaling, start_step=self.iteration,
                                                 device=self.device)
        return self.fault_state_

    def _step_scale(self) -> Optional[torch.Tensor]:
        """The loss scale the next step multiplies its loss by (None
        without loss scaling)."""
        policy = self._active_fault_policy()
        if policy is None or not policy.scaling_active(self._compute_dtype):
            return None
        return self._ensure_fault_state(policy)["loss_scale"]

    def set_fault_policy(self, policy: Optional[FaultPolicy]) -> None:
        """Install (or clear, with None) the training fault policy; it takes
        effect at the next step, and a bundle captured under the old one is
        dropped."""
        self.conf.global_conf.fault_policy = policy
        self.fault_state_ = None
        self._bundled = None

    @property
    def bad_step_count(self) -> int:
        """Lifetime count of skipped (non-finite gradient) steps; reads the
        device."""
        return 0 if self.fault_state_ is None else int(self.fault_state_["bad_count"])

    @property
    def loss_scale(self) -> Optional[float]:
        """The current dynamic loss scale, or None when scaling is off;
        reads the device."""
        if self.fault_state_ is None or "loss_scale" not in self.fault_state_:
            return None
        return float(self.fault_state_["loss_scale"])


#: model -> bad_count at its previous check. Under bundling the tripwire
#: sees only the end-of-bundle ``consec``, so a mid-bundle NaN that recovers
#: before the boundary leaves it 0: the delta against this map still shows
#: it. Weak keys: a dropped model does not pin its entry.
_last_reported_bad: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def check_fault_state(policy: Optional[FaultPolicy], fstate: Optional[FaultState],
                      owner=None) -> int:
    """The host-side divergence tripwire. Costs one device sync, so it runs
    only when ``max_consecutive_bad_steps`` is armed (else returns 0 at
    once). Returns how many steps were skipped since ``owner``'s previous
    check (all of ``bad_count`` at the first, or after the fault state was
    reset below it): what the reference's flight recorder logs as
    ``nan_skip``. Raises :class:`TrainingDivergedError` when ``consec`` has
    reached the limit."""
    if policy is None or fstate is None or policy.max_consecutive_bad_steps is None:
        return 0
    consec, bad_count = (int(v) for v in torch.stack(
        [fstate["consec"], fstate["bad_count"]]).cpu())
    new_bad = bad_count
    if owner is not None:
        prev = _last_reported_bad.get(owner)
        _last_reported_bad[owner] = bad_count
        if prev is not None and bad_count >= prev:
            new_bad = bad_count - prev
    if consec >= policy.max_consecutive_bad_steps:
        raise TrainingDivergedError(
            f"{consec} consecutive non-finite gradient steps (limit "
            f"max_consecutive_bad_steps={policy.max_consecutive_bad_steps}): training "
            "is diverging; lower the learning rate, check the data pipeline, or "
            "restore the last checkpoint")
    return new_bad


# --------------------------------------------------------------------------
# deterministic fault injection (tests and chaos drills)
# --------------------------------------------------------------------------
_INJECT_NAN_STEPS: frozenset = frozenset()


def set_fault_injection(nan_grad_steps: Sequence[int] = ()) -> frozenset:
    """Arm the gradient-NaN injector; returns the previous setting. Steps
    are HOST iteration numbers (the model's ``iteration`` when the step
    runs)."""
    global _INJECT_NAN_STEPS
    prev = _INJECT_NAN_STEPS
    _INJECT_NAN_STEPS = frozenset(int(s) for s in nan_grad_steps)
    return prev


@contextlib.contextmanager
def fault_injection(nan_grad_steps: Sequence[int] = ()):
    prev = set_fault_injection(nan_grad_steps)
    try:
        yield
    finally:
        set_fault_injection(prev)


def inject_gradient_faults(grads, iteration):
    """Every float gradient replaced by NaN at the armed host iterations.

    An eager step reads the armed set when it runs. A bundled step reads it
    when its graph is captured, as the reference's steps read it when they
    are traced: a bundle captured while no step is armed never injects, and
    one captured while injection is armed keeps comparing its steps'
    iterations with that set after the context exits (the model keeps its
    captured bundle). Drills therefore use a fresh model per armed context.
    Inside a captured bundle the step's iteration is the device scalar the
    host fills before each replay (``updaters.step_iteration``), not the
    iteration of the capture."""
    if not _INJECT_NAN_STEPS:
        return grads
    from deeplearning4j_tpu_torch.updaters import step_iteration

    it = step_iteration(iteration)
    if isinstance(it, torch.Tensor):
        bad = functools.reduce(torch.logical_or,
                               [it == s for s in sorted(_INJECT_NAN_STEPS)])
        return tree_map(lambda g: torch.where(bad, torch.full_like(g, float("nan")), g)
                        if g.is_floating_point() else g, grads)
    if int(it) not in _INJECT_NAN_STEPS:
        return grads
    return tree_map(lambda g: torch.full_like(g, float("nan")) if g.is_floating_point() else g,
                    grads)


def atomic_tmp_path(path: str) -> str:
    """Same-directory staging name for an atomic ``os.replace`` publish
    (rename is only atomic within a filesystem)."""
    return f"{path}{_TMP_MARKER}{os.getpid()}-{uuid.uuid4().hex[:8]}"


def validate_checkpoint(path: str) -> Tuple[bool, str]:
    """(ok, reason). Detects truncation (zip central directory gone), CRC
    corruption, and zips that are not model checkpoints (required entries
    missing)."""
    from deeplearning4j_tpu_torch.train.model_serializer import (
        COEFFICIENTS_ENTRY,
        CONFIG_ENTRY,
    )

    if not os.path.isfile(path):
        return False, "not a file"
    try:
        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            missing = {CONFIG_ENTRY, COEFFICIENTS_ENTRY} - names
            if missing:
                return False, (f"missing checkpoint entries {sorted(missing)}"
                               f" (found {sorted(names)})")
            bad = z.testzip()  # CRC over every member
            if bad is not None:
                return False, f"CRC mismatch in entry {bad!r}"
    except (zipfile.BadZipFile, OSError, EOFError) as e:
        return False, f"unreadable zip ({type(e).__name__}: {e})"
    return True, "ok"


def checkpoint_files(directory: str) -> List[str]:
    """Checkpoint candidates in ``directory``, oldest -> newest (mtime, then
    name). Staging files of in-flight or crashed atomic writes are never
    candidates."""
    out = []
    for name in os.listdir(directory):
        if _TMP_MARKER in name or not name.endswith((".zip", ".bin")):
            continue
        p = os.path.join(directory, name)
        try:
            # stat now, not in the sort key: a concurrent prune may delete
            # entries between listdir and the sort
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        if os.path.isfile(p):
            out.append((mtime, p))
    return [p for _, p in sorted(out)]


def is_valid_checkpoint(path: str) -> bool:
    return validate_checkpoint(path)[0]


#: staging files older than this (seconds) are debris of a crashed write
_TMP_SWEEP_AGE_S = 900.0


def sweep_stale_tmp(directory: str, max_age_s: float = _TMP_SWEEP_AGE_S,
                    surface: Optional[str] = None, recursive: bool = False) -> List[str]:
    """Remove the staging files of earlier crashed atomic writes (older than
    ``max_age_s``: a younger one may belong to a writer about to publish
    it); returns the removed paths. ``surface`` names the caller in the
    reference's ``tmp_sweep`` flight event (ROADMAP § A9: not recorded
    here)."""
    import time

    removed: List[str] = []
    if not os.path.isdir(directory):
        return removed
    now = time.time()
    walk = ([(root, files) for root, _d, files in os.walk(directory)] if recursive
            else [(directory, os.listdir(directory))])
    for root, names in walk:
        for name in names:
            if _TMP_MARKER not in name:
                continue
            p = os.path.join(root, name)
            try:
                if os.path.isfile(p) and now - os.path.getmtime(p) > max_age_s:
                    os.remove(p)
                    removed.append(p)
            except OSError:
                pass
    return removed


def prune_checkpoints(directory: str, keep_last: Optional[int]) -> List[str]:
    """Delete all but the newest ``keep_last`` checkpoints (and stale
    staging files); returns the removed paths."""
    removed: List[str] = list(sweep_stale_tmp(directory))
    if keep_last is None:
        return removed
    files = checkpoint_files(directory)
    for p in files[: max(len(files) - int(keep_last), 0)]:
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def save_checkpoint(model, directory: str, keep_last: Optional[int] = None,
                    stem: Optional[str] = None) -> str:
    """Atomic write of ``model`` (with its updater state) into
    ``directory``, then keep-last-``keep_last`` retention; returns the
    path."""
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    os.makedirs(directory, exist_ok=True)
    name = (stem or f"checkpoint_iter_{int(model.iteration):08d}") + ".zip"
    path = os.path.join(directory, name)
    ModelSerializer.write_model(model, path, save_updater=True)
    prune_checkpoints(directory, keep_last)
    return path


def checkpoint_error_class(reason: str) -> str:
    """The coarse class of a :func:`validate_checkpoint` failure reason."""
    r = reason.lower()
    if "crc" in r:
        return "crc_mismatch"
    if "unreadable" in r:
        return "unreadable_zip"
    if "missing" in r:
        return "missing_entries"
    if "not a file" in r:
        return "not_a_file"
    return "invalid"


def checkpoint_fingerprint(path: str) -> Tuple[int, int]:
    """Cheap identity of a checkpoint's on-disk content: ``(mtime_ns,
    size)``. Atomic publishes change both together, so an unchanged
    fingerprint means an unchanged checkpoint (the engine's ``reload``
    then does nothing)."""
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


def latest_valid_checkpoint(directory: str, missing_ok: bool = False
                            ) -> Optional[str]:
    """Newest checkpoint in ``directory`` that passes validation, warning
    about (and skipping) corrupt or truncated newer ones. Raises
    FileNotFoundError when no valid checkpoint exists (``missing_ok=True``
    returns None instead)."""
    candidates = checkpoint_files(directory) if os.path.isdir(directory) else []
    if not candidates:
        if missing_ok:
            return None
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    for path in reversed(candidates):
        ok, reason = validate_checkpoint(path)
        if ok:
            return path
        warnings.warn(f"skipping corrupt checkpoint {path!r}: {reason}; "
                      "falling back to the previous one", stacklevel=2)
    if missing_ok:
        return None
    raise FileNotFoundError(
        f"no VALID checkpoint in {directory!r} "
        f"({len(candidates)} candidates, all corrupt)")


def load_latest_valid(directory: str, device=None):
    """Restore the newest valid checkpoint in ``directory`` (its model type
    read from the zip) on ``device`` (default the card); returns ``(model,
    path)``."""
    from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser

    path = latest_valid_checkpoint(directory)
    return ModelGuesser.load_model_guess(path, device=device), path
