"""SharedTrainingMaster: data-parallel training on threshold-encoded
gradients.

Counterpart of ``deeplearning4j_tpu/parallel/shared_training.py``
(reference ``SharedTrainingMaster.java:57``, ``SilentTrainingDriver.java:
112-185``): each rank computes the gradient of its own rows, adds it to its
residual, threshold-encodes the sum into a fixed-capacity message
(``parallel/compression.py``), the messages are gathered over the ranks and
every rank adds them all into the same dense update, which the updater
then applies. What a rank does not send stays in its residual and goes out
in a later step: updates are delayed, never lost. Each step's update is
sign-quantized (±threshold), so it differs from exact data parallelism by
design; the accumulated update tracks its direction.

As in the wrapper, one process drives one rank: every rank is handed the
same global batch and takes its contiguous block of rows (the block that
``P("data")`` gives device r in the reference's one program). A batch that
does not divide by the rank count raises ``ValueError``; nothing is padded.
A step: the local loss and gradient; the gradient flattened in
``params_flat`` order; ``work = residual + flat``; the encode; the gathered
decode divided by the rank count; the mean loss over the ranks (the score,
without the regularization score, as the reference's); then the per-layer
update, or under ``sharded_update`` (or the configuration's knob) the ZeRO-1
update of this rank's shard of the decoded gradient (the fused Adam kernel
for f32 Adam groups) and an ``all_gather``. ``steps_per_call`` k > 1 runs k
such steps a call (``train/pipeline.py``): eagerly on the CPU, one replay of
a captured CUDA graph on the card, the residual carried beside the params
and updater state.

Under the model's fault policy (``train/faults.py``) the master has the
skip guard only, as the reference's: no loss scaling (the residual carries
values across steps, which a changing scale would make inconsistent). Its
verdict covers the decoded summed update and every rank's new residual (a
NaN in a local gradient is never encoded, since NaN compares false, so it
can rot the residual while the update stays finite), agreed over the ranks
by one collective; a false verdict keeps the params, the updater state and
the residual, and the updater's clock is ``good_count``.

The master binds to its first model, refuses a model with layer state
(BatchNorm running statistics), whose state it would not carry, as the
reference does, and refuses what the model's own ``fit`` refuses (the
port's models take no listeners yet, ROADMAP § A8).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import BatchBundle, DataSetIterator, iter_bundled
from deeplearning4j_tpu_torch.parallel.compression import gather_and_decode, threshold_encode
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.parallel.wrapper import _block, _cutter
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline


class SharedTrainingMaster:
    """The reference's builder-style facade: ``threshold`` (its
    ``thresholdAlgorithm``), ``update_capacity`` (the message's slots),
    ``mesh``, ``sharded_update``, ``steps_per_call``."""

    class Builder:
        def __init__(self, threshold: float = 1e-3):
            self._threshold = float(threshold)
            self._capacity = 16384
            self._mesh: Optional[TrainingMesh] = None
            self._sharded = False
            self._steps: Optional[int] = None

        def threshold(self, t: float) -> "SharedTrainingMaster.Builder":
            self._threshold = float(t)
            return self

        def update_capacity(self, n: int) -> "SharedTrainingMaster.Builder":
            self._capacity = int(n)
            return self

        def mesh(self, m: TrainingMesh) -> "SharedTrainingMaster.Builder":
            self._mesh = m
            return self

        def sharded_update(self, b: bool) -> "SharedTrainingMaster.Builder":
            """ZeRO-1 update of the decoded gradient (``parallel/zero.py``);
            the message format is unchanged."""
            self._sharded = bool(b)
            return self

        def steps_per_call(self, k: int) -> "SharedTrainingMaster.Builder":
            """Bundled steps (``train/pipeline.py``); defaults to the
            configuration's knob."""
            self._steps = int(k)
            return self

        def build(self) -> "SharedTrainingMaster":
            return SharedTrainingMaster(self._threshold, self._capacity, self._mesh,
                                        sharded_update=self._sharded,
                                        steps_per_call=self._steps)

    @staticmethod
    def builder(threshold: float = 1e-3) -> "Builder":
        return SharedTrainingMaster.Builder(threshold)

    def __init__(self, threshold: float = 1e-3, capacity: int = 16384,
                 mesh: Optional[TrainingMesh] = None, sharded_update: bool = False,
                 steps_per_call: Optional[int] = None):
        self.threshold = float(threshold)
        self.capacity = int(capacity)
        #: made at the first fit on the model's device when not given
        self.mesh = mesh
        self.sharded_update = bool(sharded_update)
        self.steps_per_call = steps_per_call
        self.model = None
        self._layout = None
        self._fused_impls = None
        self._residual: Optional[torch.Tensor] = None
        self._zopt = None
        self._bstep = None
        self._bstep_policy = None

    # ------------------------------------------------------------------ bind
    def _bind(self, model) -> None:
        """Check ``model`` and set up the step's state at the first fit."""
        if self.model is not None:
            if model is not self.model:
                raise ValueError(
                    "This SharedTrainingMaster is bound to its first model "
                    "(cached step/residual); build a new master per model")
            return
        if hasattr(model.conf, "network_inputs"):
            raise TypeError("SharedTrainingMaster trains a MultiLayerNetwork, as the "
                            "reference's does")
        if model.params_ is None:
            raise ValueError("init() the model (or load params) first")
        if any(bool(s) for s in model.state_):
            raise ValueError(
                "SharedTrainingMaster does not propagate layer state "
                "(e.g. BatchNorm running statistics) — train stateful "
                "models with ParallelWrapper instead")
        model._check_trainable()
        if self.mesh is None:
            self.mesh = TrainingMesh(device=model.device)
        self.mesh.refuse_host_staged("SharedTrainingMaster", "all_gather")
        from deeplearning4j_tpu_torch.nn.ops import fused_update as _fused_update
        from deeplearning4j_tpu_torch.parallel import zero

        if self.sharded_update or getattr(model.conf.global_conf, "sharded_update", False):
            self._layout = zero.build_layout(model, self.mesh.n_data)
            self._fused_impls = _fused_update.resolve_group_impls(self._layout)
        n = model.num_params()
        self._capacity = min(self.capacity, n)
        self._thr = torch.full((), self.threshold, dtype=torch.float32, device=model.device)
        self._residual = torch.zeros(n, dtype=torch.float32, device=model.device)
        self.model = model

    # ------------------------------------------------------------------ step
    def _policy(self):
        """The model's fault policy as this master applies it: active as
        for an f32 model (it never scales the loss)."""
        return _faults.active_policy(
            getattr(self.model.conf.global_conf, "fault_policy", None), None)

    def _step(self, batch) -> None:
        """One step on this rank's rows ``batch`` (the model's ``_batch``):
        the model's params, updater state (or this rank's shards) and the
        residual move (guarded: where the verdict holds); ``score_`` is the
        mean loss; ``iteration + 1``."""
        m, mesh = self.model, self.mesh
        loss, _, grads = m._value_and_grad(*batch)
        flat = torch.cat([grads[i][k].reshape(-1) for i in range(len(grads))
                          for k in sorted(grads[i])])
        work = self._residual + flat
        msg, residual = threshold_encode(work, self._thr, self._capacity)
        summed = gather_and_decode(msg, flat, mesh) / mesh.n_data
        (mean_loss,) = mesh.all_reduce_mean([loss])
        synced = _unflatten(summed, grads)
        policy = self._policy()
        t, it = m.iteration + 1, m.iteration
        if policy is not None:
            fstate = m._ensure_fault_state(policy, scaling=False)
            synced = _faults.inject_gradient_faults(synced, m.iteration)
            finite = mesh.all_true(_faults.all_finite(synced)
                                   & _faults.all_finite(residual))
            it = fstate["good_count"]
            t = it + 1
        opt = self._zopt if self._layout is not None else m._ensure_opt_state()
        if self._layout is not None:
            from deeplearning4j_tpu_torch.parallel.zero import apply_sharded_updates

            new_params, new_opt = apply_sharded_updates(
                self._layout, m.params_, synced, opt, t, it, m.epoch, mesh=mesh,
                fused_impls=self._fused_impls, reduced=True)
        else:
            from deeplearning4j_tpu_torch.nn.multilayer import apply_layer_updates

            new_params, new_opt = apply_layer_updates(m.layers, m.params_, synced, opt, t,
                                                      it, m.epoch)
        if policy is not None:
            if policy.skip_nonfinite:
                new_params, new_opt, residual = _faults.where_tree(
                    finite, (new_params, new_opt, residual),
                    (m.params_, opt, self._residual))
            m.fault_state_ = _faults.advance_fault_state(policy, fstate, finite)
        m.params_, self._residual = new_params, residual
        if self._layout is not None:
            self._zopt = new_opt
        else:
            m.opt_state_ = new_opt
        m.score_ = mean_loss
        m.iteration += 1

    def _carry(self):
        """(get, put) of what a bundle carries: params, updater state (or
        this rank's shards), the residual and the fault state."""
        m = self.model

        def get():
            opt = self._zopt if self._layout is not None else m._ensure_opt_state()
            return (m.params_, opt, self._residual, m.fault_state_)

        def put(tree):
            m.params_, opt, self._residual, m.fault_state_ = tree
            if self._layout is not None:
                self._zopt = opt
            else:
                m.opt_state_ = opt

        return get, put

    def _rows(self, arrays, axis: int):
        """This rank's contiguous block of rows of each array (None stays)."""
        n, b = self.mesh.n_data, arrays[0].shape[axis]
        if b % n:
            raise ValueError(f"batch {b} not divisible by the {n} ranks of the data axis")
        cut = _cutter(*_block(b, n, self.mesh.rank), axis=axis)
        return [cut(a) for a in arrays]

    # ------------------------------------------------------------------- fit
    def fit(self, model, it: DataSetIterator, epochs: int = 1):
        """Train ``model`` over ``it`` (every rank iterates the same global
        batches). A collective throughout: every rank calls it."""
        self._bind(model)
        k = _pipeline.resolve_steps_per_call(model, requested=self.steps_per_call)
        policy = self._policy()
        if policy is not None:
            model._ensure_fault_state(policy, scaling=False)
        if k > 1 and (self._bstep is None or self._bstep.k != k
                      or self._bstep_policy != policy):
            get, put = self._carry()
            self._bstep = _pipeline.BundledStep(model, k, self._step, get, put)
            self._bstep_policy = policy
        sync = None
        if self._layout is not None:
            from deeplearning4j_tpu_torch.parallel.zero import (
                shard_model_opt_state,
                unshard_model_opt_state,
            )

            self._zopt = shard_model_opt_state(model, self._layout, mesh=self.mesh)
            layout = self._layout

            # mid-fit serializers read opt_state_, stale while the live state
            # is this rank's shards: they gather through this hook first
            def sync():
                unshard_model_opt_state(model, layout, self._zopt, self.mesh)

            model._opt_state_sync = sync
        finished = False
        try:
            for _ in range(epochs):
                for item in (iter_bundled(it, k) if k > 1 else it):
                    if isinstance(item, BatchBundle):
                        stacked = model._batch_tensors(BatchBundle(*self._rows(
                            [item.features, item.labels, item.features_mask,
                             item.labels_mask], 1), item.k))
                        model.bundle_scores_ = self._bstep(stacked)
                    else:
                        self._step(model._batch(DataSet(*self._rows(
                            [item.features, item.labels, item.features_mask,
                             item.labels_mask], 0))))
                    _faults.check_fault_state(policy, model.fault_state_, owner=model)
                it.reset()
                model.epoch += 1
            finished = True
        finally:
            if sync is not None:
                model._opt_state_sync = None
                # a collective: after a failure on several ranks the peers
                # may never join it
                if finished or self.mesh.n_data == 1:
                    sync()
            if k > 1:
                self._bstep.release()
        return model

    def residual_magnitude(self) -> float:
        """The mean |residual| over every rank's residual: the gradient mass
        not yet sent. A collective: every rank calls it."""
        if self._residual is None:
            return 0.0
        (mean,) = self.mesh.all_reduce_mean([self._residual.abs().mean()])
        return float(mean)


def _unflatten(flat: torch.Tensor, like: List[dict]) -> List[dict]:
    """``flat`` cut into tensors of the shapes and dtypes of ``like`` (a list
    of dicts walked in sorted key order)."""
    out, off = [], 0
    for d in like:
        o = {}
        for k in sorted(d):
            t = d[k]
            o[k] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
            off += t.numel()
        out.append(o)
    return out
