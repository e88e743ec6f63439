"""Cross-replica sharded weight update (ZeRO-1).

Counterpart of ``deeplearning4j_tpu/parallel/zero.py`` (arXiv 2004.13336):
instead of every rank applying the full optimizer update to a replicated
parameter set, the gradient is reduce-scattered over the ranks, each rank
updates only its 1/N flat shard (1/N of the updater state lives on it), and
the fresh shards are all-gathered back into the replicated parameters.
Reduce-scatter + all-gather move the bytes of the all-reduce they replace.

One flat-vector shard/unshard core, as in the reference:

- Trainable parameters are grouped by (updater config, dtype), in layer
  order and param-name order; a group's vector is zero-padded to a
  multiple of N and viewed as an (N, chunk) matrix whose row r is rank r's
  shard (:class:`ShardedUpdateLayout`).
- A rank's live updater state is its (1, chunk) row of each slot;
  ``shard_opt_state`` / ``unshard_opt_state`` convert exactly (reshape +
  slice, zero padding dropped) to and from the canonical per-layer slot
  dicts, so checkpoints keep the standard gathered format: gather on save,
  re-shard on load.
- :func:`apply_sharded_updates` keeps the reference's order: per-layer
  gradient normalization, l1/l2 terms, flatten, the rank's chunk of the
  mean gradient (``reduce_scatter``), the updater on that chunk (the fused
  one-pass Adam of ``nn/ops/fused_update.py`` for f32 Adam groups, else
  ``updater.apply``), ``all_gather`` of the new chunks, scatter back to the
  per-layer params.

Where the reference's program sees the global gradient, a rank here holds
the mean over its own rows. The l1/l2 terms are linear, so adding them
before the reduction gives the same mean; gradient normalization is not, so
with a normalizing layer and more than one rank the gradient is all-reduced
first and each rank takes its chunk of the global result. The per-leaf
variant of the TransformerLM trainer (``zero1_extend_spec``) comes with
``DistributedLMTrainer`` (ROADMAP § A7).

Under a fault policy the step is the guarded one (``train/faults.py``). The
reference takes its verdict on the global gradient before the scatter;
here each rank holds its chunk of the summed gradient after it, so each
rank checks its chunks (:func:`apply_sharded_updates` with ``verdict``) and
one collective on the flag (``TrainingMesh.all_true``) makes every rank
agree. (A verdict on the local, unsummed gradients would be wrong: finite
terms can sum to inf.) The updater runs on every step, one fused Adam a
group, and the select keeps the old params, updater shards and layer state
where the verdict is false.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.regularization import (
    as_regularization,
    normalize_layer_gradients,
)
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.updaters import Updater, as_updater

Tensors = Dict[str, torch.Tensor]

#: the step variant the port does not have yet
NOT_PORTED = "not ported yet (ROADMAP § A2.2: the telemetry sharded step)"


class _Entry:
    """One parameter's slice of a group's flat vector."""

    __slots__ = ("layer", "name", "shape", "size", "offset")

    def __init__(self, layer: int, name: str, shape, size: int, offset: int):
        self.layer = layer
        self.name = name
        self.shape = tuple(shape)
        self.size = int(size)
        self.offset = int(offset)


class _Group:
    """Parameters sharing one updater config + dtype -> one flat vector."""

    def __init__(self, updater: Updater, dtype: torch.dtype):
        self.updater = updater
        self.dtype = dtype
        self.entries: List[_Entry] = []
        self.total = 0  # unpadded element count

    def finalize(self, n_shards: int) -> None:
        self.padded = -(-self.total // n_shards) * n_shards
        self.chunk = self.padded // n_shards


def _updater_key(upd: Updater) -> str:
    return json.dumps(dict(upd), sort_keys=True, default=repr)


def _normalizes(layer) -> bool:
    mode = layer.gradient_normalization
    return bool(mode) and mode.lower() != "none"


class ShardedUpdateLayout:
    """Flat shard layout for one network's trainable parameters.

    ``layers`` is the layer list (MultiLayerNetwork order, or the
    ComputationGraph's topological layer order) and ``params`` the matching
    list of name -> tensor dicts. Parameter-less layers are skipped, as in
    ``apply_layer_updates``.
    """

    def __init__(self, layers: Sequence, params: Sequence[Tensors], n_shards: int):
        self.layers = list(layers)
        self.n_shards = int(n_shards)
        self.skip: List[bool] = []
        self.groups: List[_Group] = []
        by_key: Dict[Tuple[str, Any], _Group] = {}
        for i, (layer, p_i) in enumerate(zip(self.layers, params)):
            skip = not p_i
            self.skip.append(skip)
            if skip:
                continue
            upd = as_updater(layer.updater)
            for name in sorted(p_i):
                arr = p_i[name]
                key = (_updater_key(upd), arr.dtype)
                grp = by_key.get(key)
                if grp is None:
                    grp = _Group(upd, arr.dtype)
                    by_key[key] = grp
                    self.groups.append(grp)
                grp.entries.append(_Entry(i, name, arr.shape, arr.numel(), grp.total))
                grp.total += arr.numel()
        for grp in self.groups:
            grp.finalize(self.n_shards)

    # -- flat <-> per-layer ------------------------------------------------
    def _flatten_group(self, grp: _Group, trees: Sequence[Tensors]) -> torch.Tensor:
        """The group's tensors of ``trees`` as one zero-padded (N, chunk)
        matrix (a fresh tensor)."""
        chunks = [trees[e.layer][e.name].reshape(-1) for e in grp.entries]
        if grp.padded != grp.total:
            chunks.append(chunks[0].new_zeros(grp.padded - grp.total))
        return torch.cat(chunks).view(self.n_shards, grp.chunk)

    def _scatter_group(self, grp: _Group, flat2d: torch.Tensor,
                       out: List[Tensors]) -> None:
        flat = flat2d.reshape(-1)
        for e in grp.entries:
            out[e.layer][e.name] = flat[e.offset:e.offset + e.size].view(e.shape)

    # -- opt-state conversion (exact; used at fit/checkpoint boundaries) ---
    def shard_opt_state(self, opt_state: Sequence[Dict[str, Tensors]],
                        mesh=None) -> List[Tensors]:
        """Canonical per-layer slot dicts -> per group, its slots as (N,
        chunk) matrices; with a mesh, this rank's (1, chunk) row of each."""
        zopt: List[Tensors] = []
        for grp in self.groups:
            first = opt_state[grp.entries[0].layer][grp.entries[0].name]
            slots: Tensors = {}
            for slot in sorted(first):
                mat = self._flatten_group(grp, [{n: s[slot] for n, s in o.items() if slot in s}
                                                for o in opt_state])
                slots[slot] = mat if mesh is None else mat[mesh.rank:mesh.rank + 1].clone()
            zopt.append(slots)
        return zopt

    def unshard_opt_state(self, zopt: Sequence[Tensors],
                          template: Sequence[Dict[str, Tensors]],
                          mesh=None) -> List[Dict[str, Any]]:
        """Inverse of :meth:`shard_opt_state` (with a mesh, a collective:
        every rank calls it); ``template`` supplies skipped layers' state,
        which passes through untouched. The result owns its tensors."""
        out: List[Dict[str, Any]] = [dict(t) for t in template]
        for grp, slots in zip(self.groups, zopt):
            for slot, mat in slots.items():
                flat = (mat if mesh is None else mesh.all_gather(mat)).reshape(-1)
                for e in grp.entries:
                    cur = dict(out[e.layer].get(e.name, {}))
                    cur[slot] = flat[e.offset:e.offset + e.size].reshape(e.shape).clone()
                    out[e.layer][e.name] = cur
        return out

    def n_padding(self) -> int:
        """Total zero-padding elements (diagnostics/tests)."""
        return sum(g.padded - g.total for g in self.groups)


@torch.no_grad()
def apply_sharded_updates(layout: ShardedUpdateLayout, params: Sequence[Tensors],
                          grads: Sequence[Tensors], zopt: Sequence[Tensors],
                          t, iteration, epoch, mesh=None,
                          fused_impls: Optional[Sequence] = None, reduced: bool = False,
                          verdict: bool = False):
    """The sharded analog of ``apply_layer_updates``: per-layer gradient
    normalization -> l1/l2/weight-decay -> flat sharded updater.
    (Constraints, which the reference applies last, are refused at train
    time by ``check_trainable``.)

    Without a mesh, ``grads`` is the gradient and ``zopt`` holds (N, chunk)
    slots, as the reference's ``mesh=None`` leg. With a mesh, ``grads`` is
    this rank's gradient, reduced here (``reduce_scatter`` with mean), and
    ``zopt`` holds this rank's (1, chunk) rows; the updated rows are
    all-gathered, so every rank returns the same params. ``fused_impls``
    (from ``nn.ops.fused_update.resolve_group_impls``, one per group, None:
    the reference) replaces ``updater.apply`` and the subtraction with the
    one-pass fused update, bit-exact against it. ``reduced``: ``grads`` is
    already the global gradient, the same on every rank (the shared-training
    master's decoded update), so each rank takes its chunk of it without a
    reduction. Returns ``(new_params, new_zopt)``; with ``verdict``, also
    whether every element of this rank's chunks of the (reduced) gradient
    is finite, a 0-dim bool on the device: ``(new_params, new_zopt, ok)``.
    Inputs are not changed."""
    layers = layout.layers
    split = mesh is not None
    # gradient normalization is not linear: with several ranks it needs the
    # global gradient, so reduce first and take the chunk of the result
    reduce_first = split and not reduced and mesh.n_data > 1 and any(
        _normalizes(layer) for layer, skip in zip(layers, layout.skip) if not skip)
    if reduce_first:
        keys = [(i, k) for i, skip in enumerate(layout.skip) if not skip for k in grads[i]]
        means = mesh.all_reduce_mean([grads[i][k] for i, k in keys])
        grads = [dict(g) for g in grads]
        for (i, k), g in zip(keys, means):
            grads[i][k] = g
    adjusted: List[Optional[Tensors]] = []
    for i, layer in enumerate(layers):
        if layout.skip[i]:
            adjusted.append(None)
            continue
        g_i = normalize_layer_gradients(grads[i], layer.gradient_normalization,
                                        layer.gradient_normalization_threshold)
        reg = as_regularization(layer.regularization)
        if reg is not None:
            out = {}
            for k, g in g_i.items():
                term = reg.grad_term(k, params[i][k])
                out[k] = g if term is None else g + term
            g_i = out
        adjusted.append(g_i)

    new_params: List[Tensors] = [dict(p) for p in params]
    new_zopt: List[Tensors] = []
    oks = []
    for gi, (grp, state) in enumerate(zip(layout.groups, zopt)):
        g2d = layout._flatten_group(grp, adjusted)
        p2d = layout._flatten_group(grp, params)
        if split:
            r = mesh.rank
            p2d = p2d[r:r + 1]
            g2d = g2d[r:r + 1] if reduce_first or reduced else mesh.reduce_scatter_mean(g2d)
        if verdict:
            oks.append(torch.isfinite(g2d).all())
        impl = fused_impls[gi] if fused_impls is not None else None
        if impl is not None:
            np2d, new_state = impl(grp.updater, p2d, g2d, state, t, iteration, epoch)
        else:
            delta, new_state = grp.updater.apply(g2d, state, t, iteration, epoch)
            np2d = p2d - delta
        if split:
            np2d = mesh.all_gather(np2d)
        layout._scatter_group(grp, np2d, new_params)
        new_zopt.append(new_state)
    if verdict:
        ok = torch.stack(oks).all() if oks else torch.ones((), dtype=torch.bool)
        return new_params, new_zopt, ok
    return new_params, new_zopt


# --------------------------------------------------------------------------
# model-level helpers (MultiLayerNetwork and ComputationGraph)
# --------------------------------------------------------------------------
def _model_layer_view(model) -> Tuple[Optional[List[str]], List, List]:
    """(names, layers, params) in a stable order for either model type."""
    if hasattr(model.conf, "network_inputs"):  # ComputationGraph
        names = list(model.layer_names)
        return names, [model._layer(n) for n in names], [model.params_[n] for n in names]
    return None, model.layers, model.params_


def _model_opt_list(model, names) -> List[Dict[str, Tensors]]:
    opt = model._ensure_opt_state()
    return opt if names is None else [opt[n] for n in names]


def build_layout(model, n_shards: int) -> ShardedUpdateLayout:
    if model.params_ is None:
        raise ValueError("model must be init()ed before sharded training")
    _, layers, params = _model_layer_view(model)
    return ShardedUpdateLayout(layers, params, n_shards)


def shard_model_opt_state(model, layout: ShardedUpdateLayout, mesh=None) -> List[Tensors]:
    names, _, _ = _model_layer_view(model)
    return layout.shard_opt_state(_model_opt_list(model, names), mesh=mesh)


def unshard_model_opt_state(model, layout: ShardedUpdateLayout,
                            zopt: Sequence[Tensors], mesh=None) -> None:
    """Write the gathered canonical opt state back onto the model (with a
    mesh, a collective: every rank calls it)."""
    names, _, _ = _model_layer_view(model)
    merged = layout.unshard_opt_state(zopt, _model_opt_list(model, names), mesh=mesh)
    model.opt_state_ = merged if names is None else dict(zip(names, merged))


def make_sharded_train_step(model, mesh, policy=None, steps_per_call: int = 1,
                            telemetry=None):
    """The ZeRO-1 data-parallel train step over ``mesh`` (a TrainingMesh),
    guarded under ``policy`` (a ``FaultPolicy``). Returns ``(step,
    layout)``.

    ``step(zopt, batch)`` runs at the model's params, state, iteration and
    epoch on this rank's ``batch`` (the model's ``_batch`` of its rows) and
    returns ``(new_params, new_zopt, new_state, score)`` without changing
    the model: the gradients of the local rows, the global mean loss
    (``all_reduce``), :func:`apply_sharded_updates` with ``t = iteration +
    1``, the score being the loss plus the regularization score before the
    update. The loss and gradients take the batch statistics of the global
    batch (the mesh's ``batch_stats``). The fused Adam kernel takes the f32
    Adam groups (resolved once here).

    With ``steps_per_call`` k > 1 the step is the bundled variant
    (:class:`BundledShardedStep`): ``step(zopt, stacked)`` takes k such steps
    over a stacked batch (the rank's rows of k batches, a leading k axis)
    and returns ``(new_params, new_zopt, new_state, BundleScores)``, again
    without changing the model.

    With ``policy`` (normally the model's active one) the step is the
    guarded one, as the reference's: it reads the model's ``fault_state_``
    (made if missing) and returns ``(new_params, new_zopt, new_state,
    new_fault_state, score)`` (bundled: ``BundleScores`` last): the loss
    scaled (under loss scaling), the armed faults injected, the updater at
    ``t = good_count + 1``, the verdict over this rank's chunks of the
    summed gradient agreed by one collective, the selects, the fault state
    advanced. Telemetry raises."""
    if telemetry is not None:
        raise NotImplementedError(f"sharded step with telemetry: {NOT_PORTED}")
    from deeplearning4j_tpu_torch.nn.ops import fused_update as _fused_update

    mesh.refuse_host_staged("the sharded update", "reduce_scatter and all_gather")
    model._check_trainable()
    names, layers, params = _model_layer_view(model)
    layout = ShardedUpdateLayout(layers, params, mesh.n_data)
    fused_impls = _fused_update.resolve_group_impls(layout)

    def step(zopt, batch):
        fstate = None
        if policy is not None:
            fstate = model._ensure_fault_state(policy)
        scale = fstate.get("loss_scale") if fstate is not None else None
        with mesh.batch_stats():
            loss, new_state, grads = model._value_and_grad(*batch, scale=scale)
        (loss,) = mesh.all_reduce_mean([loss])
        _, _, p_list = _model_layer_view(model)
        if fstate is not None:
            grads = _faults.inject_gradient_faults(grads, model.iteration)
            it = fstate["good_count"]
            t = it + 1
        else:
            t, it = model.iteration + 1, model.iteration
        g_list = grads if names is None else [grads[n] for n in names]
        np_list, new_zopt, *ok = apply_sharded_updates(
            layout, p_list, g_list, zopt, t, it, model.epoch, mesh=mesh,
            fused_impls=fused_impls, verdict=fstate is not None)
        new_params = np_list if names is None else dict(zip(names, np_list))
        score = loss + model._reg_score(model.params_)
        if fstate is None:
            return new_params, new_zopt, new_state, score
        finite = mesh.all_true(ok[0])
        if policy.skips(model._compute_dtype):
            new_params, new_zopt, new_state = _faults.where_tree(
                finite, (new_params, new_zopt, new_state), (model.params_, zopt, model.state_))
        return (new_params, new_zopt, new_state,
                _faults.advance_fault_state(policy, fstate, finite), score)

    if int(steps_per_call) > 1:
        return BundledShardedStep(model, step, int(steps_per_call), policy is not None), layout
    return step, layout


class BundledShardedStep:
    """k ZeRO-1 steps per call (the reference's bundled sharded step, JAX
    ``parallel/zero.py:432-473``): the single step under
    ``train/pipeline.BundledStep``, carrying params, this rank's updater
    shards, the layer state and the fault state; on the card one replay of
    a captured CUDA graph, collectives included."""

    def __init__(self, model, step, k: int, guarded: bool = False):
        from deeplearning4j_tpu_torch.train.pipeline import BundledStep

        self.model, self.k, self.guarded = model, k, guarded
        self._zopt = None

        def one(batch):
            out = step(self._zopt, batch)
            if guarded:
                (model.params_, self._zopt, model.state_, model.fault_state_,
                 model.score_) = out
            else:
                model.params_, self._zopt, model.state_, model.score_ = out
            model.iteration += 1

        def get():
            return (model.params_, self._zopt, model.state_, model.fault_state_)

        def put(tree):
            model.params_, self._zopt, model.state_, model.fault_state_ = tree

        self._runner = BundledStep(model, k, one, get, put)

    def __call__(self, zopt, stacked):
        """``(new_params, new_zopt, new_state, BundleScores)`` of k steps
        from the model's params, state, fault state and iteration and
        ``zopt`` (guarded: ``new_fault_state`` before the scores); the model
        is left as it was (the results may be the runner's static buffers,
        which the next call reads, so the caller hands them back)."""
        m = self.model
        saved = (m.params_, m.state_, m.fault_state_, m.iteration, m.score_)
        self._zopt = zopt
        try:
            scores = self._runner(stacked)
            out = (m.params_, self._zopt, m.state_)
            return out + ((m.fault_state_, scores) if self.guarded else (scores,))
        finally:
            m.params_, m.state_, m.fault_state_, m.iteration, m.score_ = saved

    def release(self) -> None:
        """:meth:`BundledStep.release` for the model's tensors."""
        self._runner.release()
