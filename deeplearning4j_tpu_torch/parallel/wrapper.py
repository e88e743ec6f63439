"""ParallelWrapper: data-parallel training over the ranks of a
``torch.distributed`` process group.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (reference
``parallelism/ParallelWrapper.java:58``: a builder with ``workers``,
``prefetch_buffer``, ``averaging_frequency``). The reference jits the
model's train step with the batch split over the mesh's "data" axis and
lets XLA all-reduce the gradient every step. Here one process drives one
rank: every rank is handed the same global batch and takes its contiguous
block of rows (the block that ``P("data")`` gives device r), runs the first
half of the model's train step on it, and the ranks meet in collectives:

- replicated update: ``all_reduce`` (mean) of the gradients and the loss,
  then every rank applies the same per-layer update
  (``nn/multilayer.apply_layer_updates``);
- ``sharded_update(True)`` (or the configuration's knob): the ZeRO-1 step
  of ``parallel/zero.py``: ``reduce_scatter`` of the gradient, each rank
  updates its 1/N flat shard (the fused Adam kernel for f32 Adam groups),
  ``all_gather`` of the new shards. The canonical per-layer ``opt_state_``
  is re-sharded when ``fit`` starts and gathered back when it returns, so
  checkpoints keep the standard format; a serializer called in the middle
  of a fit gathers first through ``model._opt_state_sync`` (a collective:
  every rank calls it).

Every rank reports the global mean score. A batch that does not divide by
the rank count is padded with repeated rows whose label-mask weight is 0
(:func:`_pad_batch`), so the gradient is exact. Every-step synchronous
reduction subsumes ``averaging_frequency``, which is accepted and warns, as
the reference's does.

``steps_per_call`` k > 1 (the builder's knob or the configuration's):
every k consecutive batches of one layout take one bundled call of k of the
steps above (``train/pipeline.py``; for ZeRO-1, ``make_sharded_train_step``'s
bundled variant): k eager steps on the CPU, one replay of a captured CUDA
graph on the card, collectives included. A bundle whose batch needs padding
takes single steps; an iterator whose every batch needs padding never
builds the bundled step. The reference bundles only a
``MultiLayerNetwork``; here a ``ComputationGraph`` bundles too.

Batch statistics: the reference's program takes a train-mode BN layer's
statistics over the global (padded) batch. Each step here runs its loss and
gradient half inside the mesh's ``batch_stats`` context, where
``BatchNormalization`` and the fused ResNet bottleneck sum their
per-channel sums over the ranks (``parallel/mesh.py``); the padded rows
enter them, as they enter the reference's. On one rank they take their own
rows, with no collective.

A mesh over gloo with CUDA tensors (two ranks sharing a card) takes the
replicated update only: the sharded update and bundled steps refuse it.

Dropout draws per rank (``model.step_noise(rank)``): the reference draws
its masks over the global batch, so no two rows share one, and here each
rank's rows take masks of their own; weight noise, which the reference
draws once a step for the replicated params, is the same on every rank.
Constraints follow the update on every rank alike (replicated) or after
the all-gather (ZeRO-1).

Under the model's fault policy (``train/faults.py``) every step is the
guarded one, as the reference's: replicated, the model's own guarded update
on the mean gradient, which every rank holds alike; ZeRO-1, the guarded
sharded step (``parallel/zero.py``, a verdict per rank agreed by one
collective). The divergence tripwire runs after each step or bundle when
``max_consecutive_bad_steps`` is set.

The model's listeners are called as by its own ``fit`` (epoch hooks,
``iteration_done`` a step, a bundle's ``bundle_done`` or replay,
``on_fit_end``), with the model's telemetry: replicated, the model's step
computes it on the mean gradient; ZeRO-1, the sharded step's (global norms).
Truncated BPTT (``backprop_type("tbptt")``, a MultiLayerNetwork, the
replicated update only, as the reference's): each rank runs the chunks of
its own rows of the (padded) batch from carries that stay on the rank, the
gradients of each chunk averaged over the ranks before its update.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    BatchBundle,
    DataSetIterator,
    iter_bundled,
    iter_grouped,
    multi_compat_key,
)
from deeplearning4j_tpu_torch.nn.multilayer import TBPTT_LABELS, step_key, tbptt_chunks
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.obs import telemetry as _telemetry
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline


class ParallelWrapper:
    class Builder:
        def __init__(self, model):
            self.model = model
            self._workers: Optional[int] = None
            self._prefetch = 4
            self._avg_freq = 1
            self._report = False
            self._sharded: Optional[bool] = None
            self._steps: Optional[int] = None

        def workers(self, n: int) -> "ParallelWrapper.Builder":
            self._workers = int(n)
            return self

        def steps_per_call(self, k: int) -> "ParallelWrapper.Builder":
            """Bundled steps (``train/pipeline.py``); defaults to the
            configuration's knob."""
            self._steps = int(k)
            return self

        def sharded_update(self, b: bool) -> "ParallelWrapper.Builder":
            """ZeRO-1 weight update (``parallel/zero.py``). Defaults to the
            configuration's ``sharded_update`` knob."""
            self._sharded = bool(b)
            return self

        def prefetch_buffer(self, n: int) -> "ParallelWrapper.Builder":
            """Accepted for the reference's API; the port's loop has no
            prefetch thread yet (ROADMAP § A8)."""
            self._prefetch = int(n)
            return self

        def averaging_frequency(self, n: int) -> "ParallelWrapper.Builder":
            # accepted for API parity; every step reduces synchronously, so
            # there is no staleness for a frequency to amortize
            self._avg_freq = int(n)
            if n != 1:
                warnings.warn(
                    "averaging_frequency is subsumed by every-step synchronous "
                    "reduction (gradients are always in sync); the value "
                    f"{n} has no effect", stacklevel=2)
            return self

        def report_score_after_averaging(self, b: bool) -> "ParallelWrapper.Builder":
            self._report = bool(b)
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self.model, self._workers, self._prefetch,
                                   sharded_update=self._sharded,
                                   steps_per_call=self._steps)

    @staticmethod
    def builder(model) -> "Builder":
        return ParallelWrapper.Builder(model)

    def __init__(self, model, workers: Optional[int] = None, prefetch: int = 4,
                 mesh: Optional[TrainingMesh] = None,
                 sharded_update: Optional[bool] = None,
                 steps_per_call: Optional[int] = None):
        if model.params_ is None:
            raise ValueError("init() the model (or load params) first")
        self.model = model
        self.mesh = mesh if mesh is not None else TrainingMesh(workers, device=model.device)
        self.prefetch = prefetch
        if sharded_update is None:
            sharded_update = bool(getattr(model.conf.global_conf, "sharded_update", False))
        self.sharded_update = bool(sharded_update)
        self.steps_per_call = steps_per_call
        self._zstep = None
        self._zstep_key = None
        self._zlayout = None
        self._ztelem = False
        #: the bundled step (k > 1), built at the first fit that bundles
        self._bstep = None
        self._bstep_key = None
        # ComputationGraph batches are per-input lists; MLN takes arrays
        self._is_graph = hasattr(model.conf, "network_inputs")

    def _check(self) -> int:
        """Refuse what the port cannot train; returns the bundle size."""
        m = self.model
        k = _pipeline.resolve_steps_per_call(m, requested=self.steps_per_call)
        m._check_trainable()
        if k > 1:
            self.mesh.refuse_host_staged("a bundled step", "a collective a CUDA graph captures")
        return k

    def _value_and_grad(self, batch):
        """The loss and gradient half of a step on this rank's rows, with
        the batch statistics of the global batch (and the loss scale of
        the model's fault policy) and this rank's noise: its rows' masks
        its own, the params' noise the same on every rank."""
        m = self.model
        with self.mesh.batch_stats():
            return m._value_and_grad(*batch, scale=m._step_scale(),
                                     noise=m.step_noise(self.mesh.rank))

    def fit(self, it: DataSetIterator, epochs: int = 1) -> None:
        """Data-parallel fit over ``it`` (every rank iterates the same
        global batches); final partial batches are padded with repeated
        rows whose loss weight is zero (gradient-exact). With
        ``steps_per_call`` k > 1, k consecutive batches of one layout that
        need no padding take one bundled call."""
        from deeplearning4j_tpu_torch.train.listeners import (
            dispatch_epoch_end,
            dispatch_epoch_start,
            dispatch_fit_end,
            dispatch_step_done,
        )

        m = self.model
        use_tbptt = m.conf.backprop_type == "tbptt"
        if use_tbptt and self._is_graph:
            raise NotImplementedError("ParallelWrapper tBPTT is supported for "
                                      "MultiLayerNetwork; fit the ComputationGraph directly")
        k = self._check()
        if self.sharded_update and use_tbptt:
            raise NotImplementedError("sharded_update does not support tBPTT configs; use "
                                      "the standard replicated update for tBPTT training")
        mesh = self.mesh
        policy = m._active_fault_policy()
        if policy is not None:
            m._ensure_fault_state(policy)
        if k > 1:
            b = getattr(it, "batch", lambda: 0)()
            if b and b % mesh.n_data:
                # every batch needs padding: no bundle could ever run
                k = 1
        zref = None
        if self.sharded_update:
            from deeplearning4j_tpu_torch.parallel.zero import (
                make_sharded_train_step,
                shard_model_opt_state,
                unshard_model_opt_state,
            )

            if self._zstep is None or self._zstep_key != step_key(m):
                self._zstep, self._zlayout = make_sharded_train_step(
                    m, mesh, policy=policy, telemetry=_telemetry.resolve(m))
                self._zstep_key = step_key(m)
            self._ztelem = _telemetry.resolve(m) is not None
            zlayout = self._zlayout
            zref = [shard_model_opt_state(m, zlayout, mesh=mesh)]
            # mid-fit serializers read m.opt_state_, which is stale while the
            # live state is the sharded zopt: they call this hook first
            m._opt_state_sync = lambda: unshard_model_opt_state(m, zlayout, zref[0], mesh)
        bstep = self._bundle_step(k) if k > 1 else None

        def run_single(ds):
            batch = self._pack_batch(ds)
            it0 = m.iteration
            if zref is not None:
                out = self._zstep(zref[0], batch)
                if self._ztelem:
                    *out, m.step_telemetry_ = out
                if policy is not None:
                    m.params_, zref[0], m.state_, m.fault_state_, m.score_ = out
                else:
                    m.params_, zref[0], m.state_, m.score_ = out
                m.iteration += 1
            else:
                m._apply_step(*_mean_over_ranks(mesh, *self._value_and_grad(batch)))
            m.last_batch_size = int(ds.num_examples())
            dispatch_step_done(m, it0, m.step_telemetry_)

        def run_bundle(stacked, n_rows):
            it0 = m.iteration
            if zref is not None:
                m.params_, zref[0], m.state_, *fs, scores = bstep(zref[0], stacked)
                if fs:
                    m.fault_state_ = fs[0]
                m.iteration += k
                m.score_, m.bundle_scores_ = scores.dev[-1], scores
            else:
                m.bundle_scores_ = scores = bstep(stacked)
            m.last_batch_size = n_rows
            _pipeline.dispatch_bundle_listeners(m, it0, m.epoch, scores, telem=bstep.telemetry)

        finished = False
        try:
            for _ in range(epochs):
                dispatch_epoch_start(m.listeners, m)
                for item in self._stream(it, k):
                    bundle = isinstance(item, (list, BatchBundle))
                    stacked = self._pack_bundle(item) if bundle else None
                    if not bundle:
                        if use_tbptt and np.ndim(item.features) == 3:
                            self._fit_tbptt(item)
                        else:
                            run_single(item)
                    elif stacked is None:
                        # needs padding, which a stacked bundle cannot take
                        for ds in (item if isinstance(item, list) else item.unstack()):
                            run_single(ds)
                    else:
                        run_bundle(stacked, int(item[0].num_examples()) if isinstance(item, list)
                                   else int(item.features.shape[1]))
                    _faults.check_fault_state(policy, m.fault_state_, owner=m)
                it.reset()
                m.epoch += 1
                dispatch_epoch_end(m.listeners, m)
            finished = True
        finally:
            dispatch_fit_end(m.listeners, m)
            if zref is not None:
                m._opt_state_sync = None
                # a collective: after a failure on several ranks the peers
                # may never join it, so only a finished fit (or one rank)
                # gathers; the canonical opt state is then the fit's start
                if finished or mesh.n_data == 1:
                    unshard_model_opt_state(m, self._zlayout, zref[0], mesh)
            if bstep is not None:
                bstep.release()

    def _bundle_step(self, k: int):
        """The bundled step at ``k`` (kept across fits; on the card it holds
        the captured graph, made anew when the model's ``step_key`` moves):
        ZeRO-1's bundled sharded step, or the
        replicated step under :class:`~deeplearning4j_tpu_torch.train.
        pipeline.BundledStep`."""
        policy = self.model._active_fault_policy()
        key = (k, self.sharded_update) + step_key(self.model)
        if self._bstep_key != key:
            m, mesh = self.model, self.mesh
            if self.sharded_update:
                from deeplearning4j_tpu_torch.parallel.zero import make_sharded_train_step

                self._bstep, _ = make_sharded_train_step(m, mesh, policy=policy,
                                                         steps_per_call=k,
                                                         telemetry=_telemetry.resolve(m))
            else:
                self._bstep = _pipeline.BundledStep(
                    m, k, lambda batch: m._apply_step(
                        *_mean_over_ranks(mesh, *self._value_and_grad(batch))))
            self._bstep_key = key
        return self._bstep

    def _stream(self, it, k: int):
        """One epoch of ``it``: single batches, or with k > 1 bundles of k
        same-layout batches (a ``BatchBundle``; for a graph, a list of
        MultiDataSets) and single ones."""
        if k <= 1:
            return iter(it)
        if self._is_graph:
            from deeplearning4j_tpu_torch.nn.graph import _as_multi

            return iter_grouped((_as_multi(ds) for ds in it), k, multi_compat_key)
        return iter_bundled(it, k)

    def _pack_bundle(self, item):
        """This rank's rows (axis 1) of a bundle's stacked batch, as the
        model's ``_batch_tensors`` gives them; None when the batch needs
        padding."""
        n, r = self.mesh.n_data, self.mesh.rank
        if self._is_graph:
            from deeplearning4j_tpu_torch.nn.graph import stack_multi

            if item[0].num_examples() % n:
                return None
            mds = stack_multi(item)
            cut = _cutter(*_block(item[0].num_examples(), n, r), axis=1)
            return self.model._batch_tensors(MultiDataSet(
                [cut(f) for f in mds.features], [cut(lab) for lab in mds.labels],
                [cut(x) for x in mds.features_masks], [cut(x) for x in mds.labels_masks]))
        if item.features.shape[1] % n:
            return None
        cut = _cutter(*_block(item.features.shape[1], n, r), axis=1)
        return self.model._batch_tensors(BatchBundle(
            cut(item.features), cut(item.labels), cut(item.features_mask),
            cut(item.labels_mask), item.k))

    def _pack_batch(self, ds):
        """This rank's block of rows of the (padded) global batch, as the
        model's ``_batch`` hands them to its train step."""
        n, r = self.mesh.n_data, self.mesh.rank
        if self._is_graph:
            from deeplearning4j_tpu_torch.nn.graph import _as_multi

            mds = _as_multi(ds)
            if mds.num_examples() % n:
                mds = _pad_multi(mds, n)
            lo, hi = _block(mds.num_examples(), n, r)
            cut = _cutter(lo, hi)
            return self.model._batch(MultiDataSet(
                [cut(f) for f in mds.features], [cut(lab) for lab in mds.labels],
                [cut(x) for x in mds.features_masks], [cut(x) for x in mds.labels_masks]))
        if ds.features.shape[0] % n:
            ds = _pad_batch(ds, n)
        cut = _cutter(*_block(ds.features.shape[0], n, r))
        return self.model._batch(DataSet(cut(ds.features), cut(ds.labels),
                                         cut(ds.features_mask), cut(ds.labels_mask)))

    def _fit_tbptt(self, ds) -> None:
        """One tBPTT batch under the mesh: this rank's rows of the (padded)
        batch in chunks from carries of its own, each chunk's loss and
        gradients averaged over the ranks before the model's (guarded)
        update; then ``iteration + 1``, the tripwire and ``iteration_done``."""
        m = self.model
        if ds.labels is not None and np.ndim(ds.labels) != 3:
            raise ValueError(TBPTT_LABELS.format(shape=tuple(np.shape(ds.labels))))
        batch = self._pack_batch(ds)
        carries = m._init_carries(batch[0].shape[0])
        for c, lo, hi in tbptt_chunks(batch[0].shape[1], m.conf.tbptt_fwd_length):
            chunk = tuple(None if a is None else a[:, lo:hi] for a in batch)
            with self.mesh.batch_stats():
                loss, new_states, grads, new_carries = m._value_and_grad(
                    *chunk, scale=m._step_scale(), noise=m.chunk_noise(c, self.mesh.rank),
                    carries=carries)
            carries = m._apply_step(*_mean_over_ranks(self.mesh, loss, new_states, grads),
                                    carries=(new_carries, carries))
        m.iteration += 1
        m.last_batch_size = int(ds.num_examples())
        for lst in m.listeners:
            lst.iteration_done(m, m.iteration, m.epoch)

    def shutdown(self):  # API parity; nothing to tear down
        pass



def _block(b: int, n: int, r: int):
    per = b // n
    return r * per, (r + 1) * per


def _cutter(lo: int, hi: int, axis: int = 0):
    def cut(a):
        return None if a is None else a[(slice(None),) * axis + (slice(lo, hi),)]
    return cut


def _mean_over_ranks(mesh, loss, new_state, grads):
    """(loss, new_state, grads) with the loss and every gradient replaced by
    its mean over the ranks (one ``all_reduce``)."""
    keys = list(grads) if isinstance(grads, dict) else range(len(grads))
    leaves = [(i, k) for i in keys for k in grads[i]]
    loss, *flat = mesh.all_reduce_mean([loss] + [grads[i][k] for i, k in leaves])
    out = {i: {} for i in keys} if isinstance(grads, dict) else [{} for _ in grads]
    for (i, k), g in zip(leaves, flat):
        out[i][k] = g
    return loss, new_state, out


def _pad_batch(ds: DataSet, multiple: int) -> DataSet:
    """Pad the final partial batch so it splits evenly over the ranks,
    without biasing the gradient: features and labels are padded by
    cycling real examples, and a weighted label mask zeroes the padded
    rows' loss while scaling the valid rows by B/valid, so the mean over B
    equals the mean over the valid rows."""
    b = ds.features.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return ds
    B = b + pad
    idx = np.arange(pad) % b  # cycle real examples

    def p(a):
        if a is None:
            return None
        a = np.asarray(a)
        return np.concatenate([a, a[idx]], axis=0)

    scale = B / b
    if ds.labels is not None and np.ndim(ds.labels) == 3:
        # time series: (B, T) mask; combine with any existing label mask
        base = (np.asarray(ds.labels_mask, np.float32) if ds.labels_mask is not None
                else np.ones(np.shape(ds.labels)[:2], np.float32))
    elif ds.labels_mask is not None:
        base = np.asarray(ds.labels_mask, np.float32).reshape(b, -1)
    else:
        base = np.ones((b, 1), np.float32)
    lmask = np.concatenate([base * scale, np.zeros((pad,) + base.shape[1:], np.float32)],
                           axis=0)
    return DataSet(p(ds.features), p(ds.labels), p(ds.features_mask), lmask)


def _pad_multi(mds: MultiDataSet, multiple: int) -> MultiDataSet:
    """MultiDataSet variant of :func:`_pad_batch`: cycled examples and a
    weighted label mask per output."""
    b = mds.num_examples()
    pad = (-b) % multiple
    if pad == 0:
        return mds
    B = b + pad
    idx = np.arange(pad) % b
    scale = B / b

    def p(a):
        if a is None:
            return None
        a = np.asarray(a)
        return np.concatenate([a, a[idx]], axis=0)

    lmasks = []
    for lab, m in zip(mds.labels, list(mds.labels_masks) + [None] * len(mds.labels)):
        if np.ndim(lab) == 3:
            base = (np.asarray(m, np.float32) if m is not None
                    else np.ones(np.shape(lab)[:2], np.float32))
        else:
            base = (np.asarray(m, np.float32).reshape(b, -1) if m is not None
                    else np.ones((b, 1), np.float32))
        lmasks.append(np.concatenate(
            [base * scale, np.zeros((pad,) + base.shape[1:], np.float32)], axis=0))
    return MultiDataSet([p(f) for f in mds.features], [p(lab) for lab in mds.labels],
                        [p(m) for m in mds.features_masks], lmasks)
