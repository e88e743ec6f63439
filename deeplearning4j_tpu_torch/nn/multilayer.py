"""MultiLayerNetwork: the sequential network runtime, and the per-layer
update pipeline shared by the train steps.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the
forward with feature masks and recurrent carries (eval and train mode),
``output``, the streaming ``rnn_time_step`` family, the train side
(``fit``, ``score``, ``compute_gradient_and_score``), the flat parameter
and updater-state vectors and ``summary``. PyTorch runs the step eagerly;
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
Rematerialization, telemetry, listeners and tBPTT are not ported yet and
raise (:func:`check_train_conf`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    BatchBundle,
    DataSetIterator,
    ListDataSetIterator,
    iter_bundled,
)
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers.base import check_trainable
from deeplearning4j_tpu_torch.nn.conf.layers.norm import BatchNormalization
from deeplearning4j_tpu_torch.regularization import (
    as_regularization,
    normalize_layer_gradients,
)
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline
from deeplearning4j_tpu_torch.updaters import as_updater

Tensors = Dict[str, torch.Tensor]

NOT_PORTED = "not ported yet (ROADMAP § A, slice 4: the rest of the training core)"


def check_train_conf(conf, not_ported: str) -> None:
    """Refuse, at train time, the global training options the port does not
    have yet: remat, telemetry and tBPTT.
    (``sharded_update`` is for ``ParallelWrapper``: a plain ``fit`` ignores
    it, as the reference's does.) Shared by MultiLayerNetwork and
    ComputationGraph."""
    g = conf.global_conf

    def knob(name, default=None):  # configurations older than a knob lack it
        return getattr(g, name, default)

    refused = [
        (knob("remat_policy") not in (None, "none"), "remat_policy"),
        (knob("telemetry") not in (None, False), "telemetry"),
        (conf.backprop_type == "tbptt", "tbptt"),
    ]
    names = [what for bad, what in refused if bad]
    if names:
        raise NotImplementedError(f"{', '.join(names)}: {not_ported}")


def cast_layer_params_for_compute(layer, p: Tensors, cd: torch.dtype, *,
                                  is_output: bool) -> Tensors:
    """Mixed-precision cast of one layer's params: float params -> ``cd``,
    except normalization layers, output layers and ``keep_fp32_params``.
    Shared by MultiLayerNetwork and ComputationGraph."""
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
    -> ``param - update``. (Parameter constraints, which the reference
    applies last, are refused at train time by ``check_trainable``.)
    Returns new params and new updater state; the inputs are not changed."""
    new_params, new_opt = [], []
    for layer, p_i, g_i, o_i in zip(layers, params, grads, opt_state):
        if not p_i:
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
        new_params.append(np_i)
        new_opt.append(no_i)
    return new_params, new_opt


def guarded_update(model, grads, update, old):
    """One optimizer step of ``model`` under its fault policy, or unguarded
    without one. ``update(grads, t, iteration)`` returns the new state tree
    (params, updater state, layer state) and ``old`` is the current one.
    Unguarded: ``update`` at ``t = iteration + 1``. Guarded: the armed
    faults injected, the verdict over the gradients, ``update`` at ``t =
    good_count + 1`` and iteration ``good_count`` (device tensors), the old
    tree kept where the verdict is false, the fault state advanced. Shared
    by both model types and the wrapper's replicated step."""
    policy = model._active_fault_policy()
    if policy is None:
        return update(grads, model.iteration + 1, model.iteration)
    fstate = model._ensure_fault_state(policy)
    grads = _faults.inject_gradient_faults(grads, model.iteration)
    finite = _faults.all_finite(grads)
    good = fstate["good_count"]
    new = update(grads, good + 1, good)
    if policy.skips(model._compute_dtype):
        new = _faults.where_tree(finite, new, old)
    model.fault_state_ = _faults.advance_fault_state(policy, fstate, finite)
    return new


def bundle_step_of(model, k: int, one_step) -> "_pipeline.BundledStep":
    """The model's bundled step at ``k``, kept across fits (on the card it
    holds the captured graph) and made anew when ``k`` or the fault policy
    changes (the graph holds the policy's constants)."""
    key = (k, model._active_fault_policy())
    if model._bundled is None or model._bundled_key != key:
        model._bundled = _pipeline.BundledStep(model, k, one_step)
        model._bundled_key = key
    return model._bundled


class MultiLayerNetwork(_faults.GuardedModel):
    def __init__(self, conf: MultiLayerConfiguration):
        # a private copy: layers of the caller's conf are never shared
        self.conf = conf = copy.deepcopy(conf)
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

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "MultiLayerNetwork":
        """Draw the params on the CPU from a ``torch.Generator`` seeded with
        the configuration's ``seed``, and place params and state on
        ``device`` (default the CUDA card)."""
        if self.conf.input_type is None:
            raise ValueError("Configuration needs set_input_type(...) before init()")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.global_conf.seed)
        dtype = _dtype_of(self.conf.global_conf.dtype)
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
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(self.conf.to_json()))
        if self.params_ is not None:
            net.params_, net.state_, net.opt_state_ = _pipeline.tree_map(
                lambda t: t.detach().clone(), (self.params_, self.state_, self.opt_state_))
            net.device = self.device
            net.iteration, net.epoch = self.iteration, self.epoch
        return net

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
                 carries: Optional[List[Any]] = None
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
        :meth:`compute_params`."""
        x, _, new_states, new_carries = self._walk(
            params, state, x, train=train, stop_before=stop_before,
            cast_params=cast_params, fmask=fmask, carries=carries)
        return x, new_states, new_carries

    def _walk(self, params, state, x, *, train, stop_before, cast_params, fmask,
              carries):
        """:meth:`_forward`'s walk; also returns the feature mask as it
        stands at ``x`` (the label mask of a time-series head)."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = self._compute_dtype or _dtype_of(self.conf.global_conf.dtype)
        if x.is_floating_point():
            x = x.to(in_dt)
        n = len(self.layers)
        stop = n if stop_before is None else stop_before
        mask = fmask
        new_states: List[Tensors] = []
        new_carries: List[Any] = [None] * n
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.preprocessors:
                prep = self.conf.preprocessors[i]
                x = prep.pre_process(x, mask)
                mask = prep.feed_forward_mask(mask)
            if i >= stop:
                break
            if (carries is not None and isinstance(layer, BaseRecurrentLayer)
                    and carries[i] is not None):
                x, new_carries[i] = layer.apply_with_carry(params[i], x, carries[i],
                                                           mask=mask, train=train)
                st = state[i]
            else:
                x, st = layer.apply(params[i], x, state=state[i], train=train, mask=mask)
            new_states.append(st if st is not None else {})
            if layer.is_recurrent and mask is not None:
                pass  # recurrent layers keep the (b, T) mask
            elif x.dim() == 2 and mask is not None and mask.dim() > 1:
                mask = None  # consumed by a pooling or last-step layer
        return x, mask, new_states, new_carries

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

    def _loss_and_new_state(self, params, state, features, labels, fmask, lmask,
                            train: bool = True):
        """Mean per-example loss of the output layer (f32: under a compute
        dtype its input is widened first) and the layers' new state. The
        label mask defaults to the feature mask as it reaches the head."""
        n = len(self.layers)
        x, mask, new_states, _ = self._walk(params, state, features, train=train,
                                            stop_before=n - 1, cast_params=True,
                                            fmask=fmask, carries=None)
        if self._compute_dtype is not None:
            x = x.float()  # loss and softmax in full precision
        out_layer = self._output_layer()
        per_ex = out_layer.compute_score(params[-1], x, labels,
                                         lmask if lmask is not None else mask)
        new_states.append(state[-1])
        return per_ex.mean(), new_states

    @torch.no_grad()
    def _reg_score(self, params) -> torch.Tensor:
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
    def set_listeners(self, *listeners) -> None:
        raise NotImplementedError(f"training listeners are {NOT_PORTED}")

    def _check_trainable(self) -> None:
        check_train_conf(self.conf, NOT_PORTED)
        for layer in self.layers:
            check_trainable(layer)

    def _ensure_opt_state(self) -> List[Dict[str, Tensors]]:
        if self.opt_state_ is None:
            self.opt_state_ = [
                {name: as_updater(layer.updater).init_state(t) for name, t in p.items()}
                for layer, p in zip(self.layers, self.params_)]
        return self.opt_state_

    def _value_and_grad(self, features, labels, fmask, lmask, scale=None):
        """The first half of a train step: ``(loss, new_states, grads)`` of a
        train-mode forward at ``params_``; grads has the layout of
        ``params_``. ``scale`` (the fault policy's loss scale, a 0-dim
        tensor): the gradients are taken of ``loss * scale`` and the loss
        and gradients come back multiplied by ``1 / scale``."""
        diff = [{k: t.detach().requires_grad_() for k, t in p.items()}
                for p in self.params_]
        loss, new_states = self._loss_and_new_state(diff, self.state_, features,
                                                    labels, fmask, lmask)
        if scale is not None:
            loss = loss * scale
        leaves = [(i, k) for i, p in enumerate(diff) for k in p]
        flat = torch.autograd.grad(loss, [diff[i][k] for i, k in leaves],
                                   allow_unused=True) if leaves else ()
        grads: List[Tensors] = [{} for _ in diff]
        for (i, k), g in zip(leaves, flat):
            grads[i][k] = torch.zeros_like(diff[i][k]) if g is None else g
        loss, grads = _faults.unscale(loss.detach(), grads, scale)
        return loss, new_states, grads

    def _apply_step(self, loss, new_states, grads) -> None:
        """The second half: the per-layer updates from ``grads`` (guarded
        under a fault policy, :func:`guarded_update`), the score (``loss``
        plus the regularization score before the update), the new state,
        ``iteration + 1``."""
        opt_state = self._ensure_opt_state()

        def update(grads, t, it):
            new_params, new_opt = apply_layer_updates(self.layers, self.params_, grads,
                                                      opt_state, t, it, self.epoch)
            return new_params, new_opt, new_states

        self.score_ = loss + self._reg_score(self.params_)
        self.params_, self.opt_state_, self.state_ = guarded_update(
            self, grads, update, (self.params_, opt_state, self.state_))
        self.iteration += 1

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
        epoch and a change of shape take single steps."""
        if self.params_ is None:
            raise ValueError("init() the network (or load params) first")
        if isinstance(data, np.ndarray):
            data = DataSet(data, labels)
        it = ListDataSetIterator(data, batch_size) if isinstance(data, DataSet) else data
        k = _pipeline.resolve_steps_per_call(self)
        self._check_trainable()
        policy = self._active_fault_policy()
        if policy is not None:
            self._ensure_fault_state(policy)
        bstep = self._bundle_step(k) if k > 1 else None
        try:
            for _ in range(epochs):
                for item in (iter_bundled(it, k) if bstep is not None else it):
                    if isinstance(item, BatchBundle):
                        self.bundle_scores_ = bstep(self._batch_tensors(item))
                    else:
                        self._fit_batch(item)
                    _faults.check_fault_state(policy, self.fault_state_, owner=self)
                it.reset()
                self.epoch += 1
        finally:
            if bstep is not None:
                bstep.release()
        return self

    def _fit_batch(self, ds: DataSet) -> None:
        self._train_step(self._batch(ds))

    def _bundle_step(self, k: int) -> "_pipeline.BundledStep":
        return bundle_step_of(self, k, self._train_step)



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
