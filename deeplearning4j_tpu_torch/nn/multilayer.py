"""MultiLayerNetwork: the sequential network runtime, and the per-layer
update pipeline shared by the train steps.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the
forward with feature masks and recurrent carries (eval and train mode),
``output``, the streaming ``rnn_time_step`` family, the train side
(``fit``, ``score``, ``compute_gradient_and_score``, the pure
``train_step_fn``, ``set_learning_rate``), evaluation (``evaluate``,
``evaluate_roc``, ``evaluate_roc_multi_class``, ``evaluate_regression``,
``f1_score``, ``predict``; ``evaluation/``), introspection
(``feed_forward``, ``score_examples``, ``layer_size``, ``summary``),
``to_computation_graph``, the flat parameter and updater-state vectors,
truncated BPTT (``backprop_type("tbptt")``), training listeners and the
in-graph telemetry. PyTorch runs the step eagerly;
there is no compiled program. The train step is the reference's unguarded
one, split in two halves that ``ParallelWrapper`` calls apart: loss (f32)
and new layer state from a train-mode forward, gradients by autograd
(:meth:`MultiLayerNetwork._value_and_grad`); then the per-layer update
pipeline (:func:`apply_layer_updates`) with ``t = iteration + 1``, the score
being the loss plus the regularization score of the params before the
update (:meth:`MultiLayerNetwork._apply_step`). State layout is the
reference's:

- ``params_``: list (per layer) of dicts param name -> tensor (``dtype``,
  f32 master weights)
- ``state_``:  list of dicts (BN running statistics)
- ``opt_state_``: list of dicts param name -> updater slots (f32), made at
  the first train step (or by ``interop.load_jax_params`` or a checkpoint's
  updater state)

Under ``compute_dtype`` the forward casts float params (except those of
normalization layers, the output layer and a layer's ``keep_fp32_params``)
and float inputs to the compute dtype, as the reference does; int8 serving
weights (``W_q8``) stay int8 and their ``W_scale`` is cast like any float
param. The cast happens inside the differentiated function, so the
gradients the updater sees are f32. ``steps_per_call > 1`` bundles
consecutive same-shaped batches into one call of K steps
(``train/pipeline.py``): K eager steps on the CPU, one replay of a captured
CUDA graph on the card, bit-identical to K single steps either way.

A fault policy (``GlobalConf.fault_policy``, ``set_fault_policy``) makes
the step the reference's guarded one (``train/faults.py``): the loss
scaled and the gradients unscaled, faults injected, one all-finite verdict
over the gradients, the updater at ``t = good_count + 1``, params, updater
state and layer state kept where the verdict is false, the fault state
advanced; all on the device, with the divergence tripwire after each step
(each bundle) only when ``max_consecutive_bad_steps`` is set.

``remat_policy`` (or the ``DL4J_TPU_REMAT`` environment variable) makes the
train-mode forward of every fit path rematerialize (``nn/remat.py``): each
layer a checkpointed region, what the policy does not keep recomputed in
the backward; the gradients are the same bits.

Listeners (``train/listeners.py``) are called as the reference calls them:
``on_epoch_start``/``on_epoch_end`` around each epoch, ``iteration_done``
after each step (a bundle: ``bundle_done``, or a replay step by step),
``on_fit_end`` when ``fit`` returns or raises; a listener with an
introspection hook gets the activations and gradients of one extra pass
before the step, with the step's own noise (:meth:`NetworkMethods.
_run_introspection`). With ``GlobalConf.telemetry`` each step computes its
telemetry dict on the device (``obs/telemetry.py``: the norms of the
gradients the update read, of the params, of the update), left in
``step_telemetry_`` and handed to ``telemetry_done``; it only reads, so
the step is the same bits with it on or off.

Truncated BPTT (the reference's ``doTruncatedBPTT``): a batch with 3-D
features is cut along time into chunks of ``tbptt_fwd_length`` steps (the
last one as it comes); each chunk is one update from the recurrent state the
previous chunk left (detached: no gradient crosses a boundary), its score
the chunk's loss plus the regularization score. Every chunk of a batch runs
at the batch's iteration (Adam's ``t`` is shared, guarded or not), which
advances once after the last chunk; under a fault policy each chunk is
guarded and the carries are kept with the params where its verdict is
false, the fault state advances a chunk and the tripwire runs a batch. Each
chunk draws its noise from a stream of its own
(:meth:`NetworkMethods.chunk_noise`).

Dropout, weight noise and constraints run as in the reference's
``_forward``: per layer, preprocessor -> input dropout -> (stop) -> weight
noise -> ``apply``, so the output layer's input is dropped too; the output
layer's weight noise is applied where its score is computed; constraints
last in each update. The dropout RNG is the model's, seeded from the
configuration's ``seed`` (``noise_seed``), as the reference's ``_rng``:
:meth:`MultiLayerNetwork.step_noise` gives the step's
``nn/conf/dropouts.NoiseSource``, whose draw position is the step's
iteration (each step takes one position) and whose streams are the layer
indices. A draw is a pure function of (seed, position, rank, stream,
element index), made where it is used: inside a captured bundle the
position is the iteration the host writes into the bundle's buffer before
each replay (``updaters.step_iteration``), so k bundled steps draw what k
eager steps draw, bit for bit. A rematerialized region that recomputes a
dropout redraws the same bits from the same source; it needs no generator
state saved or restored. ``feed_forward(train=True)`` draws from a stream
of its own (:meth:`MultiLayerNetwork.introspection_noise`), never the next
step's.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, param_dtype, resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    BatchBundle,
    DataSetIterator,
    ListDataSetIterator,
    iter_bundled,
)
from deeplearning4j_tpu_torch.nn import remat as _remat
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.dropouts import NoiseSource
from deeplearning4j_tpu_torch.nn.conf.layers.base import apply_input_dropout, apply_weight_noise
from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.layers.special import CenterLossOutputLayer, is_frozen
from deeplearning4j_tpu_torch.obs import telemetry as _telemetry
from deeplearning4j_tpu_torch.regularization import (
    apply_constraints,
    as_regularization,
    normalize_layer_gradients,
)
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline
from deeplearning4j_tpu_torch.updaters import _schedule_dict, as_updater, step_iteration

Tensors = Dict[str, torch.Tensor]

#: the first path element of the noise streams of :meth:`feed_forward` in
#: train mode (a layer's stream starts with its index, never this)
INTROSPECTION_STREAM = 0x7FFF0001
#: the first path element of a tBPTT chunk's noise stream
TBPTT_STREAM = 0x7FFF0002


#: ``GlobalConf.remat_policy`` (or the ``DL4J_TPU_REMAT`` environment
#: override) -> a ``RematPolicy`` or None (the reference's name)
_resolve_remat_policy = _remat.resolve


def remat_policy_of(model) -> Optional[_remat.RematPolicy]:
    """The remat policy ``model``'s train steps take now."""
    return _resolve_remat_policy(getattr(model.conf.global_conf, "remat_policy", None))


def step_key(model) -> tuple:
    """What a captured train step of ``model`` holds as constants besides
    its layout: the fault policy, the remat policy, the learning rates
    (a version that :meth:`set_learning_rate` moves on) and the telemetry
    configuration. A cached bundle whose key differs is made anew."""
    return (model._active_fault_policy(), remat_policy_of(model),
            getattr(model, "_lr_version", 0), _telemetry.telemetry_key(model))


def check_train_conf(conf) -> None:
    """Refuse, at train time, an unknown ``remat_policy`` (a ``ValueError``,
    as the reference's). (``sharded_update`` is for ``ParallelWrapper``: a
    plain ``fit`` ignores it, as the reference's does.) Shared by
    MultiLayerNetwork and ComputationGraph."""
    _resolve_remat_policy(getattr(conf.global_conf, "remat_policy", None))


def cast_layer_params_for_compute(layer, p: Tensors, cd: torch.dtype, *,
                                  is_output: bool) -> Tensors:
    """Mixed-precision cast of one layer's params: float params -> ``cd``,
    except normalization layers, output layers and ``keep_fp32_params``; a
    ``FrozenLayer`` as the layer it wraps. Shared by MultiLayerNetwork and
    ComputationGraph."""
    if is_frozen(layer):
        layer = layer.layer
    if isinstance(layer, BatchNormalization) or is_output:
        return p
    keep = getattr(layer, "keep_fp32_params", ())
    return {k: (map_tensors(lambda t: t.to(cd) if t.is_floating_point() else t, v)
                if k not in keep else v)
            for k, v in p.items()}


def map_tensors(fn, tree):
    """``fn`` over every tensor of a param dict, nested dicts included (a
    Bidirectional layer keeps its two copies under "fwd"/"bwd")."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def tensor_leaves(tree):
    """The tensors of a param dict in checkpoint order: names sorted,
    nested dicts walked in place."""
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            yield from tensor_leaves(v)
        else:
            yield v


@torch.no_grad()
def apply_layer_updates(layers, params: List[Tensors], grads: List[Tensors],
                        opt_state: List[Dict[str, Tensors]], t: int,
                        iteration: int, epoch: int
                        ) -> Tuple[List[Tensors], List[Dict[str, Tensors]]]:
    """One optimizer step over every layer, in the reference's order:
    gradient normalization -> l1/l2/weight-decay gradient term -> updater
    -> ``param - update`` -> the layer's constraints. A frozen layer, and
    one without params, keeps its params and updater state. Returns new
    params and new updater state; the inputs are not changed."""
    new_params, new_opt = [], []
    for layer, p_i, g_i, o_i in zip(layers, params, grads, opt_state):
        if not p_i or is_frozen(layer):
            new_params.append(p_i)
            new_opt.append(o_i)
            continue
        g_i = normalize_layer_gradients(g_i, layer.gradient_normalization,
                                        layer.gradient_normalization_threshold)
        reg = as_regularization(layer.regularization)
        if reg is not None:
            out = {}
            for k, g in g_i.items():
                term = reg.grad_term(k, p_i[k])
                out[k] = g if term is None else g + term
            g_i = out
        upd = as_updater(layer.updater)
        np_i, no_i = {}, {}
        for name, g in g_i.items():
            delta, new_slot = upd.apply(g, o_i[name], t, iteration, epoch)
            np_i[name] = p_i[name] - delta
            no_i[name] = new_slot
        new_params.append(apply_constraints(layer, np_i))
        new_opt.append(no_i)
    return new_params, new_opt


def differentiable(layers, params):
    """``params`` (a list of dicts, or a dict of dicts keyed like
    ``layers``) detached, each tensor of a trainable layer recording its
    gradient; a frozen layer's record none, so its part of the forward
    records no backward unless its input needs one."""
    if isinstance(params, dict):
        return {k: {n: t.detach().requires_grad_(not is_frozen(layers[k]))
                    for n, t in p.items()} for k, p in params.items()}
    return [{n: t.detach().requires_grad_(not is_frozen(layer)) for n, t in p.items()}
            for layer, p in zip(layers, params)]


def gradients_of(loss: torch.Tensor, diff):
    """The gradients of ``loss`` in the layout of ``diff``
    (:func:`differentiable`): zeros for a frozen layer's tensors and for
    tensors the loss does not reach."""
    keys = diff.keys() if isinstance(diff, dict) else range(len(diff))
    leaves = [(i, k) for i in keys for k in diff[i] if diff[i][k].requires_grad]
    flat = torch.autograd.grad(loss, [diff[i][k] for i, k in leaves],
                               allow_unused=True) if leaves else ()
    got = dict(zip(leaves, flat))
    out = {i: {} for i in keys} if isinstance(diff, dict) else [{} for _ in diff]
    for i in keys:
        for k, t in diff[i].items():
            g = got.get((i, k))
            out[i][k] = torch.zeros_like(t) if g is None else g
    return out


def pretrain_layer_steps(model, key, stream: int, it, epochs: int, layer_input,
                         noise=None) -> None:
    """Unsupervised pretraining of the layer at ``key`` (an index of
    ``params_`` or a vertex name), shared by both networks: per batch of
    ``it``, its input (``layer_input(ds)``, the inference-mode forward up to
    the layer) into the layer's ``pretrain_loss``, minimized over the
    layer's own params through :func:`apply_layer_updates` (normalization,
    regularization, updater, constraints); each step sets ``score_`` and
    advances ``iteration``. The draws of a step come from the layer's
    stream ``stream`` of :meth:`step_noise`, or all from ``noise`` where
    given (a ``FedNoise``: the draws of every step, in order)."""
    layer = model._updater_layers()[stream]
    opt = model._ensure_opt_state()
    for _ in range(epochs):
        for ds in it:
            p0 = model.params_[key]
            with torch.no_grad():
                x = layer_input(ds)
            p = {k: t.detach().requires_grad_() for k, t in p0.items()}
            if p and x.is_floating_point():
                # a compute-dtype input meets the f32 params in f32, as
                # JAX promotes the product
                x = x.to(torch.promote_types(x.dtype, next(iter(p.values())).dtype))
            r = model.step_noise().child(stream) if noise is None else noise
            loss = layer.pretrain_loss(p, x, r)
            grads = gradients_of(loss, [p])[0]
            (new_p,), (new_o,) = apply_layer_updates(
                [layer], [p0], [grads], [opt[key]], model.iteration + 1, model.iteration,
                model.epoch)
            model.params_ = _with(model.params_, key, new_p)
            model.opt_state_ = opt = _with(opt, key, new_o)
            model.score_ = loss.detach()
            model.iteration += 1
        it.reset()


def _with(tree, key, value):
    """A copy of the list or dict ``tree`` with ``value`` at ``key``."""
    if isinstance(tree, dict):
        return {**tree, key: value}
    return [value if j == key else v for j, v in enumerate(tree)]


def guarded_update(model, grads, update, old, clock_on_iteration: bool = False):
    """One optimizer step of ``model`` under its fault policy, or unguarded
    without one. ``update(grads, t, iteration)`` returns the new state tree
    (params first, then updater state, layer state and what else the step
    carries) and ``old`` is the current one. Unguarded: ``update`` at ``t =
    iteration + 1``. Guarded: the armed faults injected, the verdict over
    the gradients, ``update`` at ``t = good_count + 1`` and iteration
    ``good_count`` (device tensors), the old tree kept where the verdict is
    false, the fault state advanced. Under the model's telemetry the step's
    telemetry dict goes to ``model.step_telemetry_`` (else None).
    ``clock_on_iteration`` (a tBPTT chunk, as the reference's): the guarded
    update too runs at ``t = iteration + 1``, so that the policy without
    faults leaves the chunks' shared clock as it is. Shared by both model
    types and the wrapper's replicated step."""
    policy = model._active_fault_policy()
    tconf = _telemetry.resolve(model)
    if policy is None:
        new = update(grads, model.iteration + 1, model.iteration)
        model.step_telemetry_ = (None if tconf is None else
                                 _telemetry.step_telemetry(tconf, grads, old[0], new[0]))
        return new
    fstate = model._ensure_fault_state(policy)
    scale = fstate.get("loss_scale") if policy.scaling_active(model._compute_dtype) else None
    grads = _faults.inject_gradient_faults(grads, model.iteration)
    finite = _faults.all_finite(grads)
    good = model.iteration if clock_on_iteration else fstate["good_count"]
    new = update(grads, good + 1, good)
    if policy.skips(model._compute_dtype):
        new = _faults.where_tree(finite, new, old)
    model.fault_state_ = _faults.advance_fault_state(policy, fstate, finite)
    model.step_telemetry_ = (None if tconf is None else _telemetry.step_telemetry(
        tconf, grads, old[0], new[0], fstate=model.fault_state_, scale=scale))
    return new


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (f32 for a bf16 or f16 one)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def detach_carries(carries):
    """Recurrent carries cut from the graph that made them: the next tBPTT
    chunk starts from their values, and no gradient crosses the boundary."""
    return _pipeline.tree_map(lambda t: t.detach(), carries)


def tbptt_chunks(T: int, length: int):
    """``(chunk index, lo, hi)`` of a tBPTT batch of ``T`` steps cut into
    chunks of ``length`` (the last one shorter where ``length`` does not
    divide ``T``)."""
    return [(c, lo, min(lo + length, T)) for c, lo in enumerate(range(0, T, length))]


TBPTT_LABELS = ("tBPTT requires per-timestep labels (batch, time, nOut); got labels shape "
                "{shape}. For per-sequence labels use standard backprop (the reference has "
                "the same requirement).")


def bundle_step_of(model, k: int, one_step, variant=None) -> "_pipeline.BundledStep":
    """The model's bundled step at ``k`` for batches of kind ``variant`` (a
    graph's mask presence), kept across fits (on the card it holds the
    captured graph) and made anew when ``k`` or :func:`step_key` changes
    (the graph holds the fault policy's constants, the remat policy's
    regions and fixed learning rates). ``model._bundled`` is the one handed
    out last; the other variants' wait in ``model._parked_bundles`` (a model
    with one variant parks none, so clearing ``_bundled`` frees its
    graph)."""
    key = (k,) + step_key(model)
    cur = model._bundled
    parked = getattr(model, "_parked_bundles", None) or {}
    if cur is None or model._bundled_key != key:
        cur, parked = None, {}
    if cur is not None and cur.variant == variant:
        return cur
    if cur is not None:
        parked[cur.variant] = cur
    bstep = parked.pop(variant, None) or _pipeline.BundledStep(model, k, one_step)
    bstep.variant = variant
    model._bundled, model._bundled_key, model._parked_bundles = bstep, key, parked
    return bstep


def mask_after(layer, y: torch.Tensor, mask):
    """The feature mask of a layer's output ``y`` given the mask its input
    had: a recurrent layer keeps the (b, T) mask, a 2-D output (pooling, a
    last-step layer) consumes it, else it passes."""
    if mask is not None and not layer.is_recurrent and y.dim() == 2 and mask.dim() > 1:
        return None
    return mask


def init_generator(rng, seed: int) -> torch.Generator:
    """The CPU generator of a network's ``init(rng=)``: ``rng`` itself (a
    ``torch.Generator``), one seeded with ``rng`` (an int), or with the
    configuration's ``seed`` for None."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(seed if rng is None else rng))


class NetworkMethods(_faults.GuardedModel):
    """What ``MultiLayerNetwork`` and ``ComputationGraph`` share besides the
    fault policy (:class:`~deeplearning4j_tpu_torch.train.faults.
    GuardedModel`): the evaluate family, ``set_learning_rate``, the pure
    ``train_step_fn``, the noise of a train-mode ``feed_forward`` and of a
    tBPTT chunk, the listeners and the fit loop's epoch. The model provides
    ``_eval_output(ds)`` (the network's output for a DataSet's features,
    numpy), ``_updater_layers()``, ``_layer_updates``, ``_pure_grads``,
    ``_introspect(batch)`` and the epoch's parts (``_epoch_stream``,
    ``_fit_item``, ``_release_bundles``)."""

    # ------------------------------------------------------------- listeners
    def set_listeners(self, *listeners) -> None:
        """The training listeners (``train/listeners.py``), in call order."""
        self.listeners = list(listeners)

    def add_listeners(self, *listeners) -> None:
        self.listeners.extend(listeners)

    def _run_introspection(self, batch) -> None:
        """The introspection hooks of the coming step, where a listener wants
        them: one extra forward and gradient pass on ``batch`` (the
        ``_batch`` tensors) at the model's state with the step's own noise,
        the activations to ``on_forward_pass`` and the gradients (the
        layout of ``params_``, numpy) to ``on_gradient_calculation``. The
        model is not changed."""
        from deeplearning4j_tpu_torch.train.listeners import _hook_recipients

        it_next = self.iteration + 1
        fwd_to = _hook_recipients(self.listeners, "on_forward_pass", it_next)
        grad_to = _hook_recipients(self.listeners, "on_gradient_calculation", it_next)
        if not (fwd_to or grad_to):
            return
        acts, grads = self._introspect(batch)
        for lst in fwd_to:
            lst.on_forward_pass(self, acts)
        if grad_to:
            host = _pipeline.tree_map(_host_array, grads)
            for lst in grad_to:
                lst.on_gradient_calculation(self, host)

    def chunk_noise(self, chunk: int, rank: int = 0) -> NoiseSource:
        """The noise of tBPTT chunk ``chunk`` of the step at the model's
        iteration, on ``rank``: a stream of its own a chunk
        (:data:`TBPTT_STREAM`, then the chunk's index), so that the chunks
        of one batch, which share the iteration, draw different masks."""
        return NoiseSource(self.noise_seed, step_iteration(self.iteration), rank,
                           (TBPTT_STREAM, int(chunk)))

    # -------------------------------------------------------------------- fit
    def _fit_one_epoch(self, it) -> None:
        """One pass over ``it`` (the reference's ``_fit_one_epoch``, which
        the early-stopping trainer calls): ``on_epoch_start``, each batch a
        step, a bundle of them or a tBPTT batch, the fault tripwire after
        each, ``it.reset()``, ``epoch + 1``, ``on_epoch_end``."""
        from deeplearning4j_tpu_torch.train.listeners import (
            dispatch_epoch_end,
            dispatch_epoch_start,
        )

        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        dispatch_epoch_start(self.listeners, self)
        k = _pipeline.resolve_steps_per_call(self)
        self._check_trainable()
        policy = self._active_fault_policy()
        if policy is not None:
            self._ensure_fault_state(policy)
        try:
            for item in self._epoch_stream(it, k):
                self._fit_item(item, k)
                _faults.check_fault_state(policy, self.fault_state_, owner=self)
        finally:
            if k > 1:
                self._release_bundles()
        it.reset()
        self.epoch += 1
        dispatch_epoch_end(self.listeners, self)

    def _fit_epochs(self, it, epochs: int) -> None:
        """``epochs`` passes of :meth:`_fit_one_epoch`, then ``on_fit_end``
        (also when one raised)."""
        from deeplearning4j_tpu_torch.train.listeners import dispatch_fit_end

        try:
            for _ in range(epochs):
                self._fit_one_epoch(it)
        finally:
            dispatch_fit_end(self.listeners, self)

    def _fit_bundle(self, bstep, stacked) -> None:
        """One bundled call on ``stacked`` (host tensors with a leading K
        axis), then its listener calls (telemetry first)."""
        it0 = self.iteration
        self.bundle_scores_ = scores = bstep(stacked)
        self.last_batch_size = int(_pipeline.tree_leaves(stacked)[0].shape[1])
        _pipeline.dispatch_bundle_listeners(self, it0, self.epoch, scores,
                                            telem=bstep.telemetry)

    def _fit_single(self, batch) -> None:
        """One step on ``batch`` (the ``_batch`` tensors) with its listener
        calls: introspection before, then telemetry, ``on_backward_pass``,
        ``iteration_done``."""
        from deeplearning4j_tpu_torch.train.listeners import dispatch_step_done

        self._run_introspection(batch)
        it0 = self.iteration
        self._train_step(batch)
        self.last_batch_size = int(_pipeline.tree_leaves(batch[0])[0].shape[0])
        dispatch_step_done(self, it0, self.step_telemetry_)

    # ------------------------------------------------------------ evaluation
    def _evaluate_with(self, it, ev):
        """The evaluate family's loop: each DataSet of ``it`` (a DataSet is
        cut into batches of 256) through the network, its labels, output and
        label mask into ``ev``; ``it`` is reset afterwards."""
        if isinstance(it, DataSet):
            it = ListDataSetIterator(it, 256)
        for ds in it:
            ev.eval(ds.labels, self._eval_output(ds), mask=ds.labels_mask)
        it.reset()
        return ev

    def evaluate(self, it: Union[DataSetIterator, DataSet], top_n: int = 1):
        """Classification metrics over ``it`` (an ``Evaluation``, top-N
        accuracy with ``top_n``)."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        return self._evaluate_with(it, Evaluation(top_n=top_n))

    def evaluate_roc(self, it, threshold_steps: int = 0):
        """Binary ROC over ``it`` (exact with ``threshold_steps`` 0)."""
        from deeplearning4j_tpu_torch.evaluation import ROC

        return self._evaluate_with(it, ROC(threshold_steps))

    def evaluate_roc_multi_class(self, it, threshold_steps: int = 0):
        """One-vs-all ROC per class over ``it``."""
        from deeplearning4j_tpu_torch.evaluation import ROCMultiClass

        return self._evaluate_with(it, ROCMultiClass(threshold_steps))

    def evaluate_regression(self, it: Union[DataSetIterator, DataSet]):
        """Regression metrics over ``it``."""
        from deeplearning4j_tpu_torch.evaluation import RegressionEvaluation

        return self._evaluate_with(it, RegressionEvaluation())

    # --------------------------------------------------------------- control
    def set_learning_rate(self, lr: float) -> None:
        """A fixed learning rate ``lr`` for every layer's updater that has
        one (the reference's ``setLearningRate``). It takes effect at the
        next step: a bundled step captured at the old rate (which holds a
        fixed rate as a constant) is dropped, the model's and any wrapper's
        (:func:`step_key`)."""
        for layer in self._updater_layers():
            upd = as_updater(layer.updater)
            if upd.get("learning_rate") is not None:
                upd["learning_rate"] = _schedule_dict(float(lr))
                layer.updater = upd
        self._bundled = None
        self._lr_version = getattr(self, "_lr_version", 0) + 1

    setLearningRate = set_learning_rate

    def introspection_noise(self) -> NoiseSource:
        """The noise of one ``feed_forward(train=True)``: the model's seed at
        its iteration on a stream of its own (:data:`INTROSPECTION_STREAM`,
        then a count of such calls), so that it never draws what a fit step
        draws and no two calls draw alike."""
        self._introspections = getattr(self, "_introspections", 0) + 1
        return NoiseSource(self.noise_seed, self.iteration, 0,
                           (INTROSPECTION_STREAM, self._introspections))

    def train_step_fn(self, telemetry=None):
        """The pure train step (the reference's ``train_step_fn``)::

            step(params, opt_state, state, features, labels, fmask, lmask,
                 noise, iteration, epoch) -> (new_params, new_opt, new_states, score)

        one ``fit`` step's computation (the remat policy included) on the
        trees given, which it does not change (a graph's ``features``,
        ``labels``, ``fmask`` and ``lmask`` are lists, one entry a slot). ``noise`` None
        draws the model's stream at ``iteration``. Under an active fault
        policy it is the guarded step, as the reference's: ``step(params,
        opt_state, state, fstate, features, ...)`` -> ``(new_params, new_opt,
        new_states, new_fstate, score)``. ``telemetry`` (a ``TelemetryConf``,
        or True for its defaults) appends the step's telemetry dict to the
        outputs."""
        if telemetry is True:
            telemetry = _telemetry.TelemetryConf()
        self._check_trainable()
        policy = self._active_fault_policy()

        def grads_of(params, state, features, labels, fmask, lmask, noise, iteration, scale):
            noise = NoiseSource(self.noise_seed, iteration) if noise is None else noise
            return self._pure_grads(params, state, features, labels, fmask, lmask, scale, noise)

        if policy is None:
            def step(params, opt_state, state, features, labels, fmask, lmask, noise,
                     iteration, epoch):
                loss, new_states, grads = grads_of(params, state, features, labels, fmask,
                                                   lmask, noise, iteration, None)
                new_params, new_opt = self._layer_updates(params, grads, opt_state,
                                                          iteration + 1, iteration, epoch)
                out = (new_params, new_opt, new_states, loss + self._reg_score(params))
                if telemetry is not None:
                    out += (_telemetry.step_telemetry(telemetry, grads, params, new_params),)
                return out

            return step
        scaling = policy.scaling_active(self._compute_dtype)

        def gstep(params, opt_state, state, fstate, features, labels, fmask, lmask, noise,
                  iteration, epoch):
            loss, new_states, grads = grads_of(params, state, features, labels, fmask, lmask,
                                               noise, iteration,
                                               fstate["loss_scale"] if scaling else None)
            grads = _faults.inject_gradient_faults(grads, iteration)
            finite = _faults.all_finite(grads)
            good = fstate["good_count"]
            new = self._layer_updates(params, grads, opt_state, good + 1, good, epoch) \
                + (new_states,)
            if policy.skips(self._compute_dtype):
                new = _faults.where_tree(finite, new, (params, opt_state, state))
            new_fstate = _faults.advance_fault_state(policy, fstate, finite)
            out = (*new, new_fstate, loss + self._reg_score(params))
            if telemetry is not None:
                out += (_telemetry.step_telemetry(
                    telemetry, grads, params, new[0], fstate=new_fstate,
                    scale=fstate["loss_scale"] if scaling else None),)
            return out

        return gstep


class MultiLayerNetwork(NetworkMethods):
    def __init__(self, conf: MultiLayerConfiguration, *, copy_conf: bool = True):
        # a private copy: layers of the caller's conf are never shared;
        # copy_conf=False for a conf nothing else holds
        self.conf = conf = copy.deepcopy(conf) if copy_conf else conf
        self.layers = conf.layers
        self.params_: Optional[List[Tensors]] = None
        self.state_: Optional[List[Tensors]] = None
        self.opt_state_: Optional[List[Dict[str, Tensors]]] = None
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self.epoch = 0
        self.score_: Optional[torch.Tensor] = None
        #: the bundled step of ``fit`` (``steps_per_call > 1``), and the
        #: per-step scores of the last bundle it ran (on the device)
        self._bundled: Optional[_pipeline.BundledStep] = None
        self._bundled_key = None
        self.bundle_scores_: Optional[_pipeline.BundleScores] = None
        #: the fault policy's state (``train/faults.py``), 0-dim tensors on
        #: the device; None without a policy or before the first step
        self.fault_state_: Optional[Dict[str, torch.Tensor]] = None
        #: the streaming state of :meth:`rnn_time_step`
        self._rnn_carries: Optional[List[Any]] = None
        self._compute_dtype = _dtype_of(getattr(conf.global_conf, "compute_dtype", None))
        #: the dropout RNG's seed (its position is the step's iteration)
        self.noise_seed = int(conf.global_conf.seed)
        #: the dtype float inputs take in the forward when set (the gradient
        #: checker's float64); None: the compute or params dtype
        self._input_dtype: Optional[torch.dtype] = None
        #: the training listeners (``train/listeners.py``)
        self.listeners: List[Any] = []
        #: the rows of the last batch a fit step took (``PerformanceListener``)
        self.last_batch_size: Optional[int] = None
        #: the last train step's telemetry dict (device tensors), or None
        self.step_telemetry_: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------ init
    def init(self, rng=None, device=None) -> "MultiLayerNetwork":
        """Draw the params on the CPU from ``rng`` (a seed or a CPU
        ``torch.Generator``; default one seeded with the configuration's
        ``seed``), and place params and state on ``device`` (default the
        CUDA card)."""
        if self.conf.input_type is None:
            raise ValueError("Configuration needs set_input_type(...) before init()")
        device = resolve_device(device)
        gen = init_generator(rng, self.conf.global_conf.seed)
        dtype = param_dtype(self.conf.global_conf.dtype)
        types = self.conf.layer_types()
        params, state = [], []
        for i, layer in enumerate(self.layers):
            params.append(map_tensors(lambda t: t.to(device),
                                      layer.init_params(gen, types[i], dtype)))
            state.append(map_tensors(lambda t: t.to(device),
                                     layer.init_layer_state(types[i], dtype)))
        self.params_, self.state_, self.device = params, state, device
        self.opt_state_ = self.fault_state_ = None
        self.iteration = self.epoch = 0
        return self

    def clone(self) -> "MultiLayerNetwork":
        """A deep copy (the reference's ``clone()``): the configuration
        through its JSON, params, layer state and updater state copied on
        the model's device, ``iteration`` and ``epoch`` carried over."""
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(self.conf.to_json()),
                                copy_conf=False)
        if self.params_ is not None:
            net.params_, net.state_, net.opt_state_ = _pipeline.tree_map(
                lambda t: t.detach().clone(), (self.params_, self.state_, self.opt_state_))
            net.device = self.device
            net.iteration, net.epoch = self.iteration, self.epoch
        net.noise_seed = self.noise_seed
        return net

    def step_noise(self, rank: int = 0, ranked_params: bool = False) -> NoiseSource:
        """The noise source of the next train step on ``rank``: the model's
        seed at the step's draw position, its iteration (inside a captured
        bundle the device scalar the host fills before each replay).
        ``ranked_params``: the params' noise differs by rank too."""
        return NoiseSource(self.noise_seed, step_iteration(self.iteration), rank,
                           ranked_params=ranked_params)

    def _is_output(self, i: int) -> bool:
        return i == len(self.layers) - 1 and self.layers[i].is_output_layer

    # -------------------------------------------------------------- forward
    def compute_params(self, params: Optional[List[Tensors]] = None
                       ) -> List[Tensors]:
        """``params`` (default ``params_``) cast for the compute dtype."""
        params = self.params_ if params is None else params
        cd = self._compute_dtype
        if cd is None:
            return params
        return [cast_layer_params_for_compute(layer, p, cd, is_output=self._is_output(i))
                for i, (layer, p) in enumerate(zip(self.layers, params))]

    def _forward(self, params, state, x: torch.Tensor, *, train: bool = False,
                 stop_before: Optional[int] = None, cast_params: bool = True,
                 fmask: Optional[torch.Tensor] = None,
                 carries: Optional[List[Any]] = None, noise=None, remat=None
                 ) -> Tuple[torch.Tensor, List[Tensors], List[Any]]:
        """The forward. Returns ``(x, new_states, new_carries)``: ``x`` is
        the activation into layer ``stop_before`` (after its preprocessor),
        or the network's output when ``stop_before`` is None. ``train``
        takes batch statistics where a layer has them (BN), and the new
        running statistics come back in ``new_states``. ``fmask``: the (b,
        T) feature mask of recurrent input (preprocessors map it, pooling
        and last-step layers consume it). ``carries``: per layer, the
        recurrent state to start from (None entries start from zeros, as
        :meth:`_init_carries` gives); ``new_carries`` holds each recurrent
        layer's final state where a carry was given, else None.
        ``cast_params=False`` when ``params`` is already the output of
        :meth:`compute_params`. ``noise``: the step's noise source in
        training (layer i draws from its stream ``i``); a layer with dropout
        or weight noise needs one when ``train``. ``remat``: a train-mode
        forward's :class:`~deeplearning4j_tpu_torch.nn.remat.RematPolicy`
        (each layer one checkpointed region), or None."""
        x, _, new_states, new_carries, _ = self._walk(
            params, state, x, train=train, stop_before=stop_before,
            cast_params=cast_params, fmask=fmask, carries=carries, noise=noise,
            remat=remat)
        return x, new_states, new_carries

    def _walk(self, params, state, x, *, train, stop_before, cast_params, fmask,
              carries, noise=None, remat=None, collect: bool = False):
        """:meth:`_forward`'s walk; also returns the feature mask as it
        stands at ``x`` (the label mask of a time-series head) and, with
        ``collect``, every layer's activation. Per layer, as the reference:
        preprocessor, input dropout, the stop, weight noise, ``apply``: the
        input into layer ``stop_before`` is dropped too. Under ``remat`` a
        layer's whole step is one region."""
        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = (self._input_dtype or self._compute_dtype
                 or param_dtype(self.conf.global_conf.dtype))
        if x.is_floating_point():
            x = x.to(in_dt)
        n = len(self.layers)
        stop = n if stop_before is None else stop_before
        mask = fmask
        new_states: List[Tensors] = []
        new_carries: List[Any] = [None] * n
        acts: List[torch.Tensor] = []
        for i in range(n):
            r = None if noise is None else noise.child(i)
            if i >= stop:
                x, mask = self._layer_input(i, x, mask, train, r)
                break
            carry = None if carries is None else carries[i]
            step = functools.partial(self._layer_step, i, params[i], state[i], train, r, carry)
            if remat is not None and train:
                x, mask, st, new_carries[i] = remat.region(self.layers[i], step, x, mask)
            else:
                x, mask, st, new_carries[i] = step(x, mask)
            new_states.append(st)
            if collect:
                acts.append(x)
        return x, mask, new_states, new_carries, acts

    def _layer_input(self, i: int, x, mask, train: bool, r):
        """Layer ``i``'s input: its preprocessor, then its input dropout."""
        if i in self.conf.preprocessors:
            prep = self.conf.preprocessors[i]
            x = prep.pre_process(x, mask)
            mask = prep.feed_forward_mask(mask)
        return apply_input_dropout(self.layers[i], x, train, r), mask

    def _layer_step(self, i: int, p_i, st_i, train: bool, r, carry, x, mask):
        """One layer of the walk: ``(x, mask, new_state, new_carry)`` after
        layer ``i`` (its input, weight noise and ``apply``; from ``carry``
        where it is a recurrent layer's)."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        layer = self.layers[i]
        x, mask = self._layer_input(i, x, mask, train, r)
        p_i = apply_weight_noise(layer, p_i, train, r)
        new_carry = None
        if carry is not None and isinstance(layer, BaseRecurrentLayer):
            x, new_carry = layer.apply_with_carry(p_i, x, carry, mask=mask, train=train, rng=r)
            st = st_i
        else:
            x, st = layer.apply(p_i, x, state=st_i, train=train, rng=r, mask=mask)
        return x, mask_after(layer, x, mask), st if st is not None else {}, new_carry

    def _init_carries(self, batch: int, dtype=torch.float32) -> List[Any]:
        """Zero recurrent state for ``batch`` rows on the model's device: a
        carry per recurrent layer, None for the others."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        return [layer.init_carry(batch, dtype, self.device)
                if isinstance(layer, BaseRecurrentLayer) else None
                for layer in self.layers]

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    @staticmethod
    def _host(y: torch.Tensor) -> np.ndarray:
        if y.dtype in (torch.bfloat16, torch.float16):
            y = y.float()
        return y.cpu().numpy()

    def output(self, x, mask=None) -> np.ndarray:
        """Inference: the network's output for ``x`` as a numpy array (f32
        for a bf16 compute dtype). ``mask``: the (b, T) feature mask of
        recurrent input."""
        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        with torch.inference_mode():
            m = None if mask is None else self._as_input(mask).float()
            y, _, _ = self._forward(self.params_, self.state_, self._as_input(x), fmask=m)
        return self._host(y)

    # ---------------------------------------------------------- rnn state
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_get_previous_state(self):
        """Per-layer streaming state as numpy (a tuple ``(h, c)`` for an
        LSTM layer, None for a non-recurrent one); None before any
        :meth:`rnn_time_step`."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import tree_map

        if self._rnn_carries is None:
            return None
        return [None if c is None else tree_map(self._host, c)
                for c in self._rnn_carries]

    def rnn_set_previous_state(self, carries) -> None:
        """Restore state taken by :meth:`rnn_get_previous_state` (e.g. to
        resume streaming after a restart)."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import tree_map

        self._rnn_carries = None if carries is None else [
            None if c is None else tree_map(
                lambda a: torch.as_tensor(np.asarray(a)).to(self.device), c)
            for c in carries]

    def rnn_time_step(self, x) -> np.ndarray:
        """Stateful streaming inference: ``x`` (b, T, size) or one step (b,
        size), continuing from the state the last call left."""
        x = self._as_input(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None:
            # the input's dtype, as the reference (which has no float64)
            dt = torch.float32 if x.dtype == torch.float64 else x.dtype
            self._rnn_carries = self._init_carries(x.shape[0], dt)
        with torch.inference_mode():
            y, _, self._rnn_carries = self._forward(self.params_, self.state_, x,
                                                    carries=self._rnn_carries)
        y = self._host(y)
        return y[:, -1, :] if squeeze else y

    # ------------------------------------------------------- params utilities
    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params_ for t in tensor_leaves(p)))

    def summary(self) -> str:
        """Layer table: index, layer, input -> output type, #params."""
        types = self.conf.layer_types()
        rows = [("idx", "layer", "input", "output", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            n = (int(sum(t.numel() for t in tensor_leaves(self.params_[i])))
                 if self.params_ is not None else 0)
            total += n
            rows.append((str(i), type(layer).__name__, str(types[i]),
                         str(layer.get_output_type(types[i])), f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(5)]
        lines = ["  ".join(r[c].ljust(widths[c]) for c in range(5)) for r in rows]
        lines.insert(1, "-" * (sum(widths) + 8))
        lines.append(f"Total parameters: {total:,}")
        return "\n".join(lines)

    def params_flat(self) -> np.ndarray:
        """One flat f32 parameter vector: layer index ascending, param name
        sorted ascending (the checkpoint's ``coefficients.bin`` order)."""
        return flatten_tensors(self.params_)

    def set_params_flat(self, vec: np.ndarray) -> None:
        self.params_ = unflatten_tensors(self.params_, vec)

    def opt_state_flat(self) -> np.ndarray:
        """One flat f32 updater-state vector: layer, param name, slot name,
        each ascending (the checkpoint's ``updaterState.bin`` order); zeros
        before the first train step."""
        return flatten_tensors(self._ensure_opt_state())

    def set_opt_state_flat(self, vec: np.ndarray) -> None:
        self.opt_state_ = unflatten_tensors(self._ensure_opt_state(), vec)

    # ----------------------------------------------------------------- scoring
    def _output_layer(self):
        last = self.layers[-1]
        if not last.is_output_layer:
            raise ValueError(f"Last layer {last} is not an output layer")
        return last

    def _per_example(self, params, state, features, labels, fmask, lmask,
                     train: bool = True, noise=None, remat=None, carries=None):
        """The output layer's unreduced loss (f32: under a compute dtype its
        input is widened first), the layers' new state and the recurrent
        layers' final carries (None entries without ``carries``). The label
        mask defaults to the feature mask as it reaches the head. ``noise``:
        the step's noise source in training; the output layer's input
        dropout comes from the walk, its weight noise is applied here (the
        walk stops before the output layer, so nothing draws it twice).
        ``remat``: the train step's remat policy (the head is no region).
        ``carries``: the recurrent state to start from (a tBPTT chunk)."""
        n = len(self.layers)
        x, mask, new_states, new_carries, _ = self._walk(
            params, state, features, train=train, stop_before=n - 1, cast_params=True,
            fmask=fmask, carries=carries, noise=noise, remat=remat)
        if self._compute_dtype is not None:
            x = x.float()  # loss and softmax in full precision
        out_layer = self._output_layer()
        p_out = apply_weight_noise(out_layer, params[-1], train and noise is not None,
                                   None if noise is None else noise.child(n - 1))
        lmask = lmask if lmask is not None else mask
        if isinstance(out_layer, CenterLossOutputLayer):
            # the score reads the centers from before this step's update
            per_ex = out_layer.compute_score(p_out, x, labels, lmask, state=state[-1])
            new_states.append(out_layer.update_centers(state[-1], x, labels) if train
                              else state[-1])
        else:
            per_ex = out_layer.compute_score(p_out, x, labels, lmask)
            new_states.append(state[-1])
        return per_ex, new_states, new_carries

    def _loss_and_new_state(self, params, state, features, labels, fmask, lmask,
                            train: bool = True, noise=None, remat=None, carries=None):
        """The mean of :meth:`_per_example`'s loss, and the new state (and
        with ``carries``, the final carries third)."""
        per_ex, new_states, new_carries = self._per_example(
            params, state, features, labels, fmask, lmask, train=train, noise=noise,
            remat=remat, carries=carries)
        if carries is not None:
            return per_ex.mean(), new_states, new_carries
        return per_ex.mean(), new_states

    def _reg_score(self, params) -> torch.Tensor:
        """The regularization score of ``params`` (differentiable where they
        require gradients: the gradient checker's loss)."""
        s = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer, p in zip(self.layers, params):
            reg = as_regularization(layer.regularization)
            if reg is None:
                continue
            for name, arr in p.items():
                s = s + reg.score_term(name, arr)
        return s

    def _batch(self, ds: DataSet):
        """A DataSet's arrays as tensors on the model's device: float
        features as given (the forward casts them), float labels and masks
        in f32."""
        return tuple(None if t is None else t.to(self.device)
                     for t in self._batch_tensors(ds))

    @staticmethod
    def _batch_tensors(ds):
        """:meth:`_batch`'s tensors where the arrays lie (numpy: on the host).
        ``ds`` may be a :class:`BatchBundle`, whose arrays carry a leading K
        axis: the stacked batch of a bundled step."""
        def tensor(a, f32=False):
            if a is None:
                return None
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(torch.float32) if f32 and t.is_floating_point() else t

        return (tensor(ds.features), tensor(ds.labels, True), tensor(ds.features_mask, True),
                tensor(ds.labels_mask, True))

    def score(self, ds: Optional[DataSet] = None) -> float:
        """The last train step's score, or the eval-mode loss plus the
        regularization score on ``ds``."""
        if ds is None:
            if self.score_ is None:
                raise ValueError("No score available; fit() first or pass a DataSet")
            return float(self.score_)
        with torch.no_grad():
            loss, _ = self._loss_and_new_state(self.params_, self.state_,
                                               *self._batch(ds), train=False)
            return float(loss + self._reg_score(self.params_))

    def compute_gradient_and_score(self, ds: DataSet):
        """(gradients in the layout of ``params_``, score) of one train-mode
        forward on ``ds``; nothing is updated."""
        self._check_trainable()
        loss, _, grads = self._value_and_grad(*self._batch(ds))
        return grads, float(loss + self._reg_score(self.params_))

    # ------------------------------------------------------------------- fit
    def _check_trainable(self) -> None:
        check_train_conf(self.conf)

    def _ensure_opt_state(self) -> List[Dict[str, Tensors]]:
        if self.opt_state_ is None:
            self.opt_state_ = [
                {name: as_updater(layer.updater).init_state(t) for name, t in p.items()}
                for layer, p in zip(self.layers, self.params_)]
        return self.opt_state_

    def _value_and_grad(self, features, labels, fmask, lmask, scale=None, noise=None,
                        params=None, state=None, carries=None):
        """The first half of a train step: ``(loss, new_states, grads)`` of a
        train-mode forward at ``params`` and ``state`` (default ``params_``,
        ``state_``), under the configuration's remat policy; grads has the
        layout of ``params_``. ``scale`` (the fault policy's loss scale, a
        0-dim tensor): the gradients are taken of ``loss * scale`` and the
        loss and gradients come back multiplied by ``1 / scale``. ``noise``:
        the step's noise source (default :meth:`step_noise` on rank 0).
        ``carries`` (a tBPTT chunk): the forward starts from them, and the
        final carries, detached, come back fourth."""
        params = self.params_ if params is None else params
        diff = differentiable(self.layers, params)
        out = self._loss_and_new_state(
            diff, self.state_ if state is None else state, features, labels, fmask, lmask,
            noise=self.step_noise() if noise is None else noise,
            remat=remat_policy_of(self), carries=carries)
        loss, new_states = out[0], out[1]
        if scale is not None:
            loss = loss * scale
        grads = gradients_of(loss, diff)
        loss, grads = _faults.unscale(loss.detach(), grads, scale)
        if carries is not None:
            return loss, new_states, grads, detach_carries(out[2])
        return loss, new_states, grads

    def _apply_step(self, loss, new_states, grads, carries=None) -> Any:
        """The second half: the per-layer updates from ``grads`` (guarded
        under a fault policy, :func:`guarded_update`), the score (``loss``
        plus the regularization score before the update), the new state,
        ``iteration + 1``. A tBPTT chunk passes ``carries`` = (the chunk's
        final carries, the ones it started from): the guard keeps the old
        ones where it skips, the carries to go on from are returned, and
        the iteration stays (it advances once a batch)."""
        opt_state = self._ensure_opt_state()

        def update(grads, t, it):
            out = self._layer_updates(self.params_, grads, opt_state, t, it,
                                      self.epoch) + (new_states,)
            return out if carries is None else out + (carries[0],)

        old = (self.params_, opt_state, self.state_)
        self.score_ = loss + self._reg_score(self.params_)
        new = guarded_update(self, grads, update,
                             old if carries is None else old + (carries[1],),
                             clock_on_iteration=carries is not None)
        self.params_, self.opt_state_, self.state_ = new[:3]
        if carries is not None:
            return new[3]
        self.iteration += 1
        return None

    def _train_step(self, batch) -> None:
        """One train step on a batch of ``_batch`` tensors."""
        self._apply_step(*self._value_and_grad(*batch, scale=self._step_scale()))

    def fit(self, data: Union[DataSet, DataSetIterator, np.ndarray],
            labels: Optional[np.ndarray] = None, epochs: int = 1,
            batch_size: int = 32) -> "MultiLayerNetwork":
        """Train: one step per minibatch, ``epochs`` passes. ``data`` is a
        DataSet (cut into ``batch_size`` minibatches), an iterator of
        DataSets, or a features array with ``labels``. With
        ``steps_per_call`` k > 1, every k consecutive batches of one layout
        take one bundled call (``train/pipeline.py``); the ragged tail of an
        epoch and a change of shape take single steps. Under
        ``backprop_type("tbptt")`` a batch of 3-D features is trained in
        chunks (:meth:`_fit_tbptt_batch`). The listeners'
        ``on_fit_end`` runs when it returns or raises."""
        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        if isinstance(data, np.ndarray):
            data = DataSet(data, labels)
        it = ListDataSetIterator(data, batch_size) if isinstance(data, DataSet) else data
        self._fit_epochs(it, epochs)
        return self

    def _epoch_stream(self, it, k: int):
        return iter_bundled(it, k) if k > 1 else it

    def _fit_item(self, item, k: int) -> None:
        if isinstance(item, BatchBundle):
            self._fit_bundle(self._bundle_step(k), self._batch_tensors(item))
        elif self.conf.backprop_type == "tbptt" and np.ndim(item.features) == 3:
            self._fit_tbptt_batch(item)
        else:
            self._fit_batch(item)

    def _release_bundles(self) -> None:
        if self._bundled is not None:
            self._bundled.release()

    def _fit_batch(self, ds: DataSet) -> None:
        self._fit_single(self._batch(ds))

    # ----------------------------------------------------------------- tBPTT
    def tbptt_step_fn(self):
        """The pure tBPTT chunk step (the reference's ``tbptt_step_fn``)::

            step(params, opt_state, state, carries, features, labels, fmask,
                 lmask, noise, iteration, epoch)
              -> (new_params, new_opt, new_states, new_carries, score)

        one chunk's computation on the trees given, which it does not
        change: the forward from ``carries``, the update at ``t = iteration
        + 1``, the score the loss plus the regularization score before the
        update; ``new_carries`` detached. ``noise`` None draws chunk 0's
        stream at ``iteration``. Under an active fault policy it is the
        guarded chunk: ``step(params, opt_state, state, fstate, carries,
        ...)`` -> ``(new_params, new_opt, new_states, new_fstate,
        new_carries, score)``, the carries kept with the rest where the
        verdict is false, the update still at ``t = iteration + 1``."""
        self._check_trainable()
        policy = self._active_fault_policy()

        def chunk(params, opt_state, state, fstate, carries, features, labels, fmask, lmask,
                  noise, iteration, epoch):
            if noise is None:
                noise = NoiseSource(self.noise_seed, iteration, 0, (TBPTT_STREAM, 0))
            scale = (fstate["loss_scale"] if policy is not None
                     and policy.scaling_active(self._compute_dtype) else None)
            loss, new_states, grads, new_carries = self._value_and_grad(
                features, labels, fmask, lmask, scale=scale, noise=noise, params=params,
                state=state, carries=carries)
            score = loss + self._reg_score(params)
            if policy is None:
                new_params, new_opt = self._layer_updates(params, grads, opt_state,
                                                          iteration + 1, iteration, epoch)
                return new_params, new_opt, new_states, new_carries, score
            grads = _faults.inject_gradient_faults(grads, iteration)
            finite = _faults.all_finite(grads)
            # the chunks' shared clock, guarded or not (the reference's)
            new = self._layer_updates(params, grads, opt_state, iteration + 1, iteration,
                                      epoch) + (new_states, new_carries)
            if policy.skips(self._compute_dtype):
                new = _faults.where_tree(finite, new, (params, opt_state, state, carries))
            new_params, new_opt, new_states, new_carries = new
            return (new_params, new_opt, new_states,
                    _faults.advance_fault_state(policy, fstate, finite), new_carries, score)

        if policy is None:
            def step(params, opt_state, state, carries, features, labels, fmask, lmask,
                     noise, iteration, epoch):
                return chunk(params, opt_state, state, None, carries, features, labels,
                             fmask, lmask, noise, iteration, epoch)

            return step
        return chunk

    def _fit_tbptt_batch(self, ds: DataSet) -> None:
        """One batch of truncated BPTT (the reference's ``doTruncatedBPTT``):
        the chunks of ``tbptt_fwd_length`` steps in order, each one update
        from the carries the previous one left, then ``iteration + 1`` and
        ``iteration_done``. Labels that are not 3-D raise ``ValueError``."""
        if ds.labels is not None and np.ndim(ds.labels) != 3:
            raise ValueError(TBPTT_LABELS.format(shape=tuple(np.shape(ds.labels))))
        batch = self._batch(ds)
        carries = self._init_carries(batch[0].shape[0])
        for c, lo, hi in tbptt_chunks(batch[0].shape[1], self.conf.tbptt_fwd_length):
            chunk = tuple(None if a is None else a[:, lo:hi] for a in batch)
            carries = self._tbptt_chunk(chunk, carries, c)
        self.iteration += 1
        self.last_batch_size = int(batch[0].shape[0])
        # the reference's tBPTT path calls iteration_done alone
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    def _tbptt_chunk(self, chunk, carries, c: int):
        """One chunk's update on the model's state (guarded under its fault
        policy); returns the carries the next chunk starts from."""
        loss, new_states, grads, new_carries = self._value_and_grad(
            *chunk, scale=self._step_scale(), noise=self.chunk_noise(c), carries=carries)
        return self._apply_step(loss, new_states, grads, carries=(new_carries, carries))

    def _introspect(self, batch):
        """The activations (every layer's, numpy) and the gradients of the
        step on ``batch`` that comes next, with its noise."""
        features, labels, fmask, lmask = batch
        noise = self.step_noise()
        n = len(self.layers)
        with torch.no_grad():
            x, mask, _, _, acts = self._walk(
                self.params_, self.state_, features, train=True, stop_before=n - 1,
                cast_params=True, fmask=fmask, carries=None, noise=noise, collect=True)
            if self._compute_dtype is not None:
                x = x.float()
            out = self._output_layer()
            r = noise.child(n - 1)
            y, _ = out.apply(apply_weight_noise(out, self.params_[-1], True, r), x,
                             state=self.state_[-1], train=True, rng=r, mask=mask)
        _, _, grads = self._value_and_grad(features, labels, fmask, lmask,
                                           scale=self._step_scale(), noise=noise)
        return [_host_array(a) for a in acts] + [_host_array(y)], grads

    def _bundle_step(self, k: int) -> "_pipeline.BundledStep":
        return bundle_step_of(self, k, self._train_step)

    def _layer_updates(self, params, grads, opt_state, t, iteration, epoch):
        return apply_layer_updates(self.layers, params, grads, opt_state, t, iteration, epoch)

    def _pure_grads(self, params, state, features, labels, fmask, lmask, scale, noise):
        return self._value_and_grad(features, labels, fmask, lmask, scale=scale, noise=noise,
                                    params=params, state=state)

    def _updater_layers(self):
        return self.layers

    # --------------------------------------------------------------- pretrain
    def pretrain(self, it: DataSetIterator, epochs: int = 1, noise=None
                 ) -> "MultiLayerNetwork":
        """Greedy layer-wise unsupervised pretraining of every layer that can
        be pretrained (``is_pretrain_layer``), in order (``noise``: as
        :meth:`pretrain_layer`'s, the draws of all of them)."""
        for i, layer in enumerate(self.layers):
            if layer.is_pretrain_layer:
                self.pretrain_layer(i, it, epochs=epochs, noise=noise)
        return self

    def pretrain_layer(self, layer_idx: int, it: DataSetIterator, epochs: int = 1,
                       noise=None) -> "MultiLayerNetwork":
        """Unsupervised pretraining of layer ``layer_idx``: each batch's
        features through layers ``[0, layer_idx)`` in inference mode, then
        the layer's ``pretrain_loss`` minimized over its params alone, one
        step a batch (:func:`pretrain_layer_steps`; ``noise``: the draws of
        every step, for tests). A layer that cannot be pretrained raises
        ``ValueError``."""
        layer = self.layers[layer_idx]
        if not layer.is_pretrain_layer:
            raise ValueError(f"Layer {layer_idx} ({layer}) is not pretrainable")

        def layer_input(ds):
            x, _, _ = self._forward(self.params_, self.state_, self._as_input(ds.features),
                                    stop_before=layer_idx)
            return x

        pretrain_layer_steps(self, layer_idx, layer_idx, it, epochs, layer_input, noise)
        return self

    # ------------------------------------------------- evaluation, introspection
    def _eval_output(self, ds: DataSet) -> np.ndarray:
        return self.output(ds.features, mask=ds.features_mask)

    def predict(self, x) -> np.ndarray:
        """The predicted class index of each example (time-distributed
        outputs: (b, T) indices)."""
        return np.argmax(self.output(x), axis=-1)

    def f1_score(self, ds: Union[DataSet, DataSetIterator]) -> float:
        """F1 of :meth:`evaluate` (the reference's ``f1Score``)."""
        return float(self.evaluate(ds).f1())

    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """Every layer's activation for ``x`` (the reference's
        ``feedForward``), as numpy; ``train``: layers in train mode (BN
        batch statistics, dropout from :meth:`introspection_noise`), the
        model unchanged."""
        with torch.no_grad():
            _, _, _, _, acts = self._walk(
                self.params_, self.state_, self._as_input(x), train=train, stop_before=None,
                cast_params=True, fmask=None, carries=None,
                noise=self.introspection_noise() if train else None, collect=True)
        return [self._host(a) for a in acts]

    def score_examples(self, ds: DataSet, add_regularization_terms: bool = True) -> np.ndarray:
        """Each example's loss (the reference's ``scoreExamples``): the
        output layer's unreduced eval-mode loss, plus the regularization
        score where ``add_regularization_terms``."""
        with torch.no_grad():
            per_ex, _, _ = self._per_example(self.params_, self.state_, *self._batch(ds),
                                             train=False)
            if add_regularization_terms:
                per_ex = per_ex + self._reg_score(self.params_)
        return self._host(per_ex)

    def layer_size(self, layer_idx: int) -> int:
        """Layer ``layer_idx``'s output size: n_out of a dense or recurrent
        layer, the channels of a convolutional one, 0 where undefined."""
        types = self.conf.layer_types()
        out = self.layers[layer_idx].get_output_type(types[layer_idx])
        if out.kind in ("feedforward", "recurrent"):
            return int(out.size)
        if out.kind == "convolutional":
            return int(out.channels)
        return 0

    def to_computation_graph(self):
        """The same network as a ``ComputationGraph`` (the reference's
        ``toComputationGraph``): the chain "input" -> "layer_0" -> ... ->
        "layer_{n-1}", each preprocessor on its layer's vertex; params,
        layer state and updater state copied, ``iteration`` and ``epoch``
        carried over, so outputs and steps match."""
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import GraphBuilder
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        gb = GraphBuilder(copy.deepcopy(self.conf.global_conf))
        gb.add_inputs("input")
        prev = "input"
        for i, layer in enumerate(self.layers):
            gb.add_layer(f"layer_{i}", copy.deepcopy(layer), prev,
                         preprocessor=copy.deepcopy(self.conf.preprocessors.get(i)))
            prev = f"layer_{i}"
        gb.set_outputs(prev)
        if self.conf.input_type is not None:
            gb.set_input_types(self.conf.input_type)
        cg = ComputationGraph(gb.build())
        cg.noise_seed = self.noise_seed
        if self.params_ is not None:
            def copied(trees):
                return None if trees is None else {
                    f"layer_{i}": _pipeline.tree_map(lambda t: t.detach().clone(), tree)
                    for i, tree in enumerate(trees)}

            cg.params_, cg.state_ = copied(self.params_), copied(self.state_)
            cg.opt_state_ = copied(self.opt_state_)
            cg.device = self.device
            cg.iteration, cg.epoch = self.iteration, self.epoch
        return cg



def flatten_tensors(groups) -> np.ndarray:
    """Tensors of a list of dicts (or a dict of dicts, walked in the caller's
    order) as one f32 vector: group by group, names sorted (nested dicts
    in place, :func:`tensor_leaves`)."""
    groups = groups.values() if isinstance(groups, dict) else groups
    chunks = [t.detach().float().cpu().numpy().reshape(-1)
              for g in groups for t in tensor_leaves(g)]
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def unflatten_tensors(groups, vec: np.ndarray):
    """The inverse of :func:`flatten_tensors`: new tensors of each tensor's
    shape, dtype and device, read from ``vec`` in the same order."""
    vec = np.asarray(vec, np.float32)
    off = 0

    def take(t: torch.Tensor) -> torch.Tensor:
        nonlocal off
        n = t.numel()
        if off + n > vec.size:
            raise ValueError(f"Param vector length {vec.size} is shorter than "
                             "the model")
        out = torch.tensor(vec[off:off + n].reshape(tuple(t.shape)),
                           dtype=t.dtype, device=t.device)
        off += n
        return out

    def rebuild(g):
        return {name: rebuild(g[name]) if isinstance(g[name], dict) else take(g[name])
                for name in sorted(g)}

    if isinstance(groups, dict):
        out = {key: rebuild(g) for key, g in groups.items()}
    else:
        out = [rebuild(g) for g in groups]
    if off != vec.size:
        raise ValueError(f"Param vector length {vec.size} != model size {off}")
    return out
