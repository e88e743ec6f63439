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

Batch statistics: the reference's program takes a train-mode BN layer's
statistics over the global batch; a rank here would take them over its own
rows. So a network with batch statistics (``BatchNormalization``, the fused
ResNet bottleneck) on more than one rank is refused
(:class:`CrossRankBatchStatsError`) until cross-rank statistics come (ROADMAP
§ A3). On one rank nothing changes.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import NOT_PORTED
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh


class CrossRankBatchStatsError(NotImplementedError):
    """A network with train-mode batch statistics on more than one rank."""


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
            """Bundled steps; defaults to the configuration's knob. Only 1
            is ported (a larger value raises at ``fit``)."""
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
        self._zlayout = None
        # ComputationGraph batches are per-input lists; MLN takes arrays
        self._is_graph = hasattr(model.conf, "network_inputs")

    def _check(self) -> None:
        m = self.model
        k = (self.steps_per_call if self.steps_per_call is not None
             else getattr(m.conf.global_conf, "steps_per_call", 1))
        if k > 1:
            raise NotImplementedError(f"steps_per_call > 1 (bundled steps): {NOT_PORTED}")
        m._check_trainable()
        if self.mesh.n_data > 1:
            stats = [type(layer).__name__ for layer in _layers(m) if _has_batch_stats(layer)]
            if stats:
                raise CrossRankBatchStatsError(
                    f"{sorted(set(stats))} take batch statistics in train mode; on "
                    f"{self.mesh.n_data} ranks each would see only its own rows, "
                    "where the reference takes the global batch's. Cross-rank "
                    "batch statistics are not ported yet (ROADMAP § A3)")

    def fit(self, it: DataSetIterator, epochs: int = 1) -> None:
        """Data-parallel fit over ``it`` (every rank iterates the same
        global batches); final partial batches are padded with repeated
        rows whose loss weight is zero (gradient-exact)."""
        m = self.model
        self._check()
        mesh = self.mesh
        zref = None
        if self.sharded_update:
            from deeplearning4j_tpu_torch.parallel.zero import (
                make_sharded_train_step,
                shard_model_opt_state,
                unshard_model_opt_state,
            )

            if self._zstep is None:
                self._zstep, self._zlayout = make_sharded_train_step(m, mesh)
            zlayout = self._zlayout
            zref = [shard_model_opt_state(m, zlayout, mesh=mesh)]
            # mid-fit serializers read m.opt_state_, which is stale while the
            # live state is the sharded zopt: they call this hook first
            m._opt_state_sync = lambda: unshard_model_opt_state(m, zlayout, zref[0], mesh)
        finished = False
        try:
            for _ in range(epochs):
                for ds in it:
                    batch = self._pack_batch(ds)
                    if zref is not None:
                        m.params_, zref[0], m.state_, m.score_ = self._zstep(zref[0], batch)
                        m.iteration += 1
                    else:
                        loss, new_state, grads = m._value_and_grad(*batch)
                        m._apply_step(*_mean_over_ranks(mesh, loss, new_state, grads))
                it.reset()
                m.epoch += 1
            finished = True
        finally:
            if zref is not None:
                m._opt_state_sync = None
                # a collective: after a failure on several ranks the peers
                # may never join it, so only a finished fit (or one rank)
                # gathers; the canonical opt state is then the fit's start
                if finished or mesh.n_data == 1:
                    unshard_model_opt_state(m, self._zlayout, zref[0], mesh)

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

    def shutdown(self):  # API parity; nothing to tear down
        pass


def _layers(model):
    if hasattr(model.conf, "network_inputs"):
        return [model._layer(n) for n in model.layer_names]
    return model.layers


def _has_batch_stats(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.conf.layers.fused_block import FusedResNetBottleneck
    from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization

    return isinstance(layer, (BatchNormalization, FusedResNetBottleneck))


def _block(b: int, n: int, r: int):
    per = b // n
    return r * per, (r + 1) * per


def _cutter(lo: int, hi: int):
    def cut(a):
        return None if a is None else a[lo:hi]
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
