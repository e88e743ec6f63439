"""Bundled train steps (``steps_per_call > 1``): K optimizer steps per call.

Counterpart of ``deeplearning4j_tpu/train/pipeline.py``, where one jitted
``lax.scan`` dispatch runs K steps and the per-step scores come back as one
(K,) device array. Here a :class:`BundledStep` takes a stacked batch (the
model's batch tensors with a leading K axis, ``data/iterators.py``'s
:class:`~deeplearning4j_tpu_torch.data.iterators.BatchBundle`) and runs the
caller's own single step K times in order, step j on the j-th slice:

- on the CPU, as K eager steps (the model's half-steps, ``_value_and_grad``
  then ``_apply_step``, or the data-parallel wrapper's step), bit-identical
  to K single steps because they are the same steps;
- on the card, as one replay of a CUDA graph, captured once per (stacked
  batch layout, carried state layout, K) from those same K steps. A bundle
  is then one host call for the whole step's kernels, K times over.

The captured graph reads and writes fixed addresses, so the state that the
steps carry (params, updater slots, BN statistics; for the ZeRO-1 step the
rank's updater shards) lives in static buffers between replays, and so do
the stacked batch, the per-step updater scalars and the K scores:

- before a replay, each carried tensor the model holds that is not its
  static buffer (a single step ran in between, ``set_params_flat``, a
  restored checkpoint, the wrapper's re-shard) is copied in; the stacked
  batch and the K steps' scalars take one host-to-device copy each, through
  pinned staging; the replay runs the K steps and copies the last step's
  state back into the static buffers, and the model then points at them;
- an updater scalar that changes with the step (Adam's bias-corrected
  ``alpha``; any schedule but a fixed one) would be frozen at the step of
  the capture, so while capturing, ``updaters.Updater.step_scalar`` hands
  the graph a slot of a (K, n) device buffer, and before each replay the
  host fills it by the unchanged host pipeline (``Updater.scalar_value``),
  the same f32 bits an eager step uses;
- under a fault policy (``train/faults.py``) the fault state rides in the
  carry with the rest, and the verdict, the selects and the fault state's
  advance are device operations inside the graph: no host sync within a
  replay. The guarded step's updater clock is the carried ``good_count``,
  so its ``alpha`` is computed in the graph from it (no feed slot), and
  where fault injection is armed at capture, each step compares its
  iteration, which the host writes into a (K,) device buffer before each
  replay (``updaters.step_iteration``), with the armed set. The divergence
  tripwire runs once a bundle, after it (the model's ``fit``);
- the scores stay on the card: a :class:`BundleScores` holds a copy that no
  later replay writes, fetched to the host at most once;
- :meth:`BundledStep.release`, at the end of a fit, replaces every static
  buffer the model still holds by a copy, so tensors a caller keeps after
  ``fit`` never change under a later replay.

Capture runs a warm-up of eager steps on a side stream first (discarded),
which also records which scalars a step asks for. Python's garbage
collector is paused while the graph is captured (after one collection): an
earlier graph collected inside the capture (a dropped model's bundle, held
in a reference cycle) would tear it down. Anything that syncs the
host inside the step fails the capture, which raises
:class:`BundleCaptureError`: a bundle on the card never quietly runs eager
steps. The graph keeps the memory of one step's intermediates (its private
pool) for as long as it lives; a new layout recaptures.

Listeners (the reference's ``dispatch_bundle_listeners``, the prefetch
thread's ``bundle_size`` stage) come with ROADMAP § A8; the port's models
take no listeners yet, so nothing forces ``k = 1`` today.
"""

from __future__ import annotations

import gc
import json
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import updaters as _updaters
from deeplearning4j_tpu_torch.nn.ops import launch as _launch

#: eager steps run on a side stream before a capture (discarded)
WARMUP_STEPS = 2

#: host fetches of bundle scores in this process (tests count them)
_host_fetches = 0


class BundleCaptureError(RuntimeError):
    """A bundled step could not be captured into a CUDA graph (a host sync or
    an unsupported operation inside the step)."""


class BundleScores:
    """Per-step scores of one bundle, a (K,) f32 tensor on the model's
    device that no later bundle writes; :meth:`host` copies it to the host
    at most once."""

    def __init__(self, scores: torch.Tensor):
        self.dev = scores
        self._host: Optional[np.ndarray] = None
        self.fetch_count = 0

    def __len__(self) -> int:
        return int(self.dev.shape[0])

    def host(self) -> np.ndarray:
        if self._host is None:
            global _host_fetches
            self._host = self.dev.cpu().numpy()
            self.fetch_count += 1
            _host_fetches += 1
        return self._host


# --------------------------------------------------------------------------
# legality / resolution
# --------------------------------------------------------------------------
_PER_STEP_HOOKS = ("on_forward_pass", "on_gradient_calculation", "on_backward_pass")


def bundling_blockers(listeners: Sequence[Any]) -> List[str]:
    """Listener needs that require a host callback between steps, and so
    force ``steps_per_call = 1``, as ``Type.reason`` strings (the
    reference's rule). The port's models take no listeners yet (ROADMAP §
    A8), so this is empty today."""
    out = set()
    for lst in listeners:
        for h in _PER_STEP_HOOKS:
            if callable(getattr(lst, h, None)):
                out.add(f"{type(lst).__name__}.{h}")
        if getattr(lst, "requires_per_step_state", False):
            out.add(f"{type(lst).__name__}.requires_per_step_state")
    return sorted(out)


def resolve_steps_per_call(model, requested: Optional[int] = None) -> int:
    """The bundle size for a fit: ``requested`` (default the configuration's
    ``steps_per_call``), 1 where a listener needs per-step callbacks. A
    tBPTT configuration refuses ``k > 1`` with ``ValueError``, as the
    reference does: its chunk steps share one iteration and carry state
    between chunks outside the step."""
    if requested is None:
        requested = getattr(model.conf.global_conf, "steps_per_call", 1)
    k = int(requested or 1)
    if k <= 1:
        return 1
    if getattr(model.conf, "backprop_type", "standard") == "tbptt":
        raise ValueError(
            "steps_per_call > 1 cannot bundle tBPTT fits: chunk steps share one host "
            "iteration and carries cross chunk boundaries outside the step; use "
            "steps_per_call=1 for tBPTT configurations")
    if bundling_blockers(getattr(model, "listeners", [])):
        return 1
    return k


def dispatch_bundle_listeners(model, it0: int, epoch: int, scores: BundleScores) -> None:
    """The reference hands a bundle's scores to its listeners here; the port
    has no listeners yet."""
    raise NotImplementedError("bundle listeners are not ported yet (ROADMAP § A8)")


# --------------------------------------------------------------------------
# trees of tensors (dicts walked in sorted key order, lists/tuples, None)
# --------------------------------------------------------------------------
def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in _walk(tree)]


def _layout(tree) -> tuple:
    return tuple((path, tuple(t.shape), t.dtype) for path, t in _walk(tree))


def _updater_key(upd) -> str:
    return json.dumps(dict(upd), sort_keys=True, default=repr)


class _ScalarFeed:
    """The per-step updater scalars of a captured bundle. In the warm-up
    (no buffer yet) it records which scalars a step asks for, one slot per
    (updater config, kind, t and iteration relative to the step), and
    answers with the host value; while capturing, step j's request for a
    slot is answered with ``buf[j, slot]``; before each replay
    :meth:`host_values` computes every slot of every step on the host."""

    def __init__(self):
        self.slots = {}
        self.specs = []          # per slot: (updater, kind, dt, dit)
        self.buf: Optional[torch.Tensor] = None
        #: (K,) int64: step j's host iteration, filled before each replay
        self.ibuf: Optional[torch.Tensor] = None
        self.j = 0
        self.base = 0

    def begin(self, j: int, iteration: int) -> None:
        self.j, self.base = j, iteration

    def take(self, upd, kind, t, iteration, epoch):
        dt, dit = t - self.base, iteration - self.base
        key = (_updater_key(upd), kind, dt, dit)
        if self.buf is None:
            if key not in self.slots:
                value = upd.scalar_value(kind, t, iteration, epoch)
                if value.dtype != torch.float32 or value.dim() != 0:
                    raise BundleCaptureError(
                        f"updater scalar {kind!r} is {value.dtype} of shape "
                        f"{tuple(value.shape)}; a bundle feeds 0-dim f32 scalars")
                self.slots[key] = len(self.specs)
                self.specs.append((upd, kind, dt, dit))
            return upd.scalar_value(kind, t, iteration, epoch)
        slot = self.slots.get(key)
        if slot is None:
            raise BundleCaptureError(
                f"updater scalar {kind!r} of {dict(upd)} was not asked for in the warm-up")
        return self.buf[self.j, slot]

    def iteration(self, iteration: int):
        """Step j's host iteration: the int in the warm-up, ``ibuf[j]``
        while capturing."""
        if self.buf is None:
            return iteration
        if iteration != self.base:
            raise BundleCaptureError(
                f"a step asked for iteration {iteration} while running at {self.base}")
        return self.ibuf[self.j]

    def host_values(self, iteration: int, epoch: int, k: int) -> torch.Tensor:
        """(k, slots) f32 on the host: each slot of step j at iteration
        ``iteration + j``, by the updater's host pipeline."""
        out = torch.zeros((k, max(1, len(self.specs))), dtype=torch.float32)
        for j in range(k):
            it = iteration + j
            for slot, (upd, kind, dt, dit) in enumerate(self.specs):
                out[j, slot] = upd.scalar_value(kind, it + dt, it + dit, epoch)
        return out


def default_carry(model):
    """(get, put) of the state a model's own steps carry: ``params_``,
    ``opt_state_`` (made if missing), ``state_`` and ``fault_state_`` (None
    without a fault policy)."""
    def get():
        return (model.params_, model._ensure_opt_state(), model.state_, model.fault_state_)

    def put(tree):
        model.params_, model.opt_state_, model.state_, model.fault_state_ = tree

    return get, put


class BundledStep:
    """K steps of ``one_step`` per call over a stacked batch.

    ``one_step(batch)`` is one train step on the model's live state: it
    reads the state ``get()`` returns, leaves the new state where ``get()``
    finds it, sets ``model.score_`` and adds one to ``model.iteration``.
    ``batch`` has the structure of the stacked batch with the K axis taken
    off (what the model's ``_batch`` returns). ``get``/``put`` default to the
    model's params, updater state and layer state (:func:`default_carry`).

    Calling it with the stacked batch (the model's ``_batch_tensors`` of a
    bundle, host tensors) runs the K steps, leaves ``model.iteration``
    advanced by K and ``model.score_`` the last step's, and returns the
    :class:`BundleScores`. A model on the CPU runs them eagerly; a model on
    the card replays the captured graph (capturing it first where the
    layout is new)."""

    def __init__(self, model, k: int, one_step: Callable, get: Optional[Callable] = None,
                 put: Optional[Callable] = None):
        if int(k) < 2:
            raise ValueError(f"a bundle takes at least 2 steps, got {k}")
        self.model, self.k, self.one_step = model, int(k), one_step
        dget, dput = default_carry(model)
        self.get, self.put = get or dget, put or dput
        #: run the graph path's body eagerly on the CPU (tests only): the
        #: static buffers, the scalar feed and the write-back without a graph
        self.emulate = False
        self._key = None
        self._graph = None
        self._static = None
        #: the kernel launches the last captured graph holds (the wrappers
        #: count a launch when the capture records it): one replay's
        self.captured_launches = {}

    def __call__(self, stacked) -> BundleScores:
        if self.model.device.type == "cuda" or self.emulate:
            return self._replay(stacked)
        m, scores = self.model, []
        for j in range(self.k):
            self.one_step(tree_map(lambda t: t[j], stacked))
            scores.append(m.score_)
        return BundleScores(torch.stack(scores))

    # -- the graph path -----------------------------------------------------
    def _replay(self, stacked) -> BundleScores:
        m = self.model
        carry = self.get()
        key = (_layout(carry), _layout(stacked))
        if key != self._key:
            self._capture(carry, stacked, key)
        else:
            for cur, st in zip(tree_leaves(carry), tree_leaves(self._static)):
                if cur is not st:
                    st.copy_(cur)
            self.put(self._static)
        self._load(stacked, m.iteration, m.epoch)
        if self.emulate:
            it0 = m.iteration
            self._body()
            m.iteration = it0
        else:
            self._graph.replay()
        self.put(self._static)
        m.iteration += self.k
        scores = self._scores.clone()
        m.score_ = scores[-1]
        return BundleScores(scores)

    def _capture(self, carry, stacked, key) -> None:
        m, k = self.model, self.k
        dev = m.device
        self._graph = self._key = None
        floats = {t.dtype for t in tree_leaves(carry) if t.is_floating_point()}
        if floats - {torch.float32, torch.float64}:
            raise BundleCaptureError(
                f"carried state of dtypes {sorted(map(str, floats))}: a bundle feeds "
                "f32 updater scalars, which round otherwise against lower-precision "
                "params than an eager step's host scalars")
        with torch.no_grad():
            self._static = tree_map(lambda t: t.detach().clone(), carry)
        self._sbatch = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                                stacked)
        self._views = [tree_map(lambda t, j=j: t[j], self._sbatch) for j in range(k)]
        self._scores = torch.empty(k, dtype=torch.float32, device=dev)
        self._feed = _ScalarFeed()
        for st, src in zip(tree_leaves(self._sbatch), tree_leaves(stacked)):
            st.copy_(src)
        it0, score0 = m.iteration, m.score_
        try:
            self.put(self._static)
            if self.emulate:
                self._warm_up()
            else:
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._warm_up()
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
            self._feed.buf = torch.zeros((k, max(1, len(self._feed.specs))),
                                         dtype=torch.float32, device=dev)
            self._feed.ibuf = torch.zeros((k,), dtype=torch.int64, device=dev)
            self.put(self._static)
            m.iteration, m.score_ = it0, score0
            if not self.emulate:
                self._stage = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                             pin_memory=True), stacked)
                self._stage_scalars = torch.empty(tuple(self._feed.buf.shape),
                                                  dtype=torch.float32, pin_memory=True)
                self._stage_iters = torch.empty((k,), dtype=torch.int64, pin_memory=True)
                self._copied = torch.cuda.Event()
                self._copied.record()
                graph = torch.cuda.CUDAGraph()
                before = dict(_launch.launch_counts)
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph):
                        self._body()
                finally:
                    if collecting:
                        gc.enable()
                self.captured_launches = {
                    name: n - before.get(name, 0) for name, n in _launch.launch_counts.items()
                    if n != before.get(name, 0)}
                self._graph = graph
        except BundleCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 — every capture failure is typed here
            raise BundleCaptureError(
                f"capturing a bundle of {k} steps of {type(m).__name__} into a CUDA graph "
                f"failed: {type(e).__name__}: {e}") from e
        finally:
            self.put(self._static)
            m.iteration, m.score_ = it0, score0
        self._key = key

    def _warm_up(self) -> None:
        m = self.model
        with _updaters.scalar_feed(self._feed):
            for j in range(min(WARMUP_STEPS, self.k)):
                self._feed.begin(j, m.iteration)
                self.one_step(self._views[j])

    def _body(self) -> None:
        """The K steps over the static buffers, then the last step's state
        written back into them: what the graph holds."""
        m = self.model
        scores = []
        with _updaters.scalar_feed(self._feed):
            for j in range(self.k):
                self._feed.begin(j, m.iteration)
                self.one_step(self._views[j])
                scores.append(m.score_)
        with torch.no_grad():
            for st, new in zip(tree_leaves(self._static), tree_leaves(self.get())):
                if new is not st:
                    st.copy_(new)
            self._scores.copy_(torch.stack(scores))

    def _load(self, stacked, iteration: int, epoch: int) -> None:
        """The stacked batch and the K steps' updater scalars into their
        static buffers: one host-to-device copy each (on the card through
        pinned staging, which waits only for the copies of the bundle
        before)."""
        scalars = self._feed.host_values(iteration, epoch, self.k)
        iters = torch.arange(iteration, iteration + self.k, dtype=torch.int64)
        if self.emulate:
            for st, src in zip(tree_leaves(self._sbatch), tree_leaves(stacked)):
                st.copy_(src)
            self._feed.buf.copy_(scalars)
            self._feed.ibuf.copy_(iters)
            return
        self._copied.synchronize()
        for stage, st, src in zip(tree_leaves(self._stage), tree_leaves(self._sbatch),
                                  tree_leaves(stacked)):
            stage.copy_(src)
            st.copy_(stage, non_blocking=True)
        self._stage_scalars.copy_(scalars)
        self._feed.buf.copy_(self._stage_scalars, non_blocking=True)
        self._stage_iters.copy_(iters)
        self._feed.ibuf.copy_(self._stage_iters, non_blocking=True)
        self._copied.record()

    def release(self) -> None:
        """Give the model copies of the static buffers it holds, so that no
        later replay writes a tensor the caller has after a fit."""
        if self._static is None:
            return
        ids = {id(t) for t in tree_leaves(self._static)}
        carry = self.get()
        if any(id(t) in ids for t in tree_leaves(carry)):
            with torch.no_grad():
                self.put(tree_map(lambda t: t.clone() if id(t) in ids else t, carry))
