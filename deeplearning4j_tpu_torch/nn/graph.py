"""ComputationGraph: DAG network runtime, inference and training.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the forward
walk over the topological order, ``output``/``output_single``, and the
train side: ``fit``, ``score``, ``compute_gradient_and_score``. PyTorch
runs the walk eagerly; there is no compiled program. The train step is the
reference's unguarded one: loss (f32) and new layer state from a train-mode
forward, gradients by autograd, then the per-layer update pipeline
(``nn/multilayer.apply_layer_updates``) with ``t = iteration + 1``; the
score is the loss plus the regularization score of the params before the
update. State layout is the reference's:

- ``params_``: dict vertex name -> dict param name -> tensor (``dtype``,
  f32 master weights)
- ``state_``:  dict vertex name -> dict (BN running statistics)
- ``opt_state_``: dict vertex name -> dict param name -> updater slots (f32),
  made at the first train step (or by ``interop.load_jax_params``)

Under ``compute_dtype`` the forward casts float params (except those of
normalization and output layers and a layer's ``keep_fp32_params``) and
float inputs to the compute dtype, as the reference does. The cast happens
inside the differentiated function, so the gradients the updater sees are
f32. ``_value_and_grad`` and ``_apply_step`` are the two halves of the step,
which ``ParallelWrapper`` calls apart; ``sharded_update`` is the wrapper's
knob and a plain ``fit`` ignores it, as the reference's does.
``steps_per_call > 1`` bundles consecutive same-layout batches into one call
of K steps (``train/pipeline.py``): K eager steps on the CPU, one replay of a
captured CUDA graph on the card. A fault policy makes the step the
reference's guarded one (``nn/multilayer.guarded_update``,
``train/faults.py``), eager and bundled. Rematerialization, telemetry,
listeners and tBPTT are not ported yet and raise.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DataSetIterator,
    ListDataSetIterator,
    MultiDataSetIterator,
    iter_grouped,
    multi_compat_key,
)
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers.base import check_trainable
from deeplearning4j_tpu_torch.nn.multilayer import (
    apply_layer_updates,
    bundle_step_of,
    cast_layer_params_for_compute,
    check_train_conf,
    flatten_tensors,
    guarded_update,
    unflatten_tensors,
)
from deeplearning4j_tpu_torch.regularization import as_regularization
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline
from deeplearning4j_tpu_torch.updaters import as_updater

NOT_PORTED = "not ported yet (ROADMAP § A, training slices)"

Tensors = Dict[str, torch.Tensor]


class ComputationGraph(_faults.GuardedModel):
    def __init__(self, conf: ComputationGraphConfiguration):
        # a private copy: layers of the caller's conf are never shared
        self.conf = conf = copy.deepcopy(conf)
        self.topo = conf.topological_order
        self.layer_names: List[str] = [
            n for n in self.topo if isinstance(conf.vertices[n], LayerVertex)]
        self.params_: Optional[Dict[str, Tensors]] = None
        self.state_: Optional[Dict[str, Tensors]] = None
        self.opt_state_: Optional[Dict[str, Dict[str, Tensors]]] = None
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
        self._compute_dtype = _dtype_of(getattr(conf.global_conf, "compute_dtype", None))
        self._output_layers()

    def _layer(self, name: str):
        return self.conf.vertices[name].layer

    def _output_layers(self) -> List[str]:
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            if not (isinstance(v, LayerVertex) and v.layer.is_output_layer):
                raise ValueError(f"Network output '{name}' is not an output layer")
        return list(self.conf.network_outputs)

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "ComputationGraph":
        """Draw the params on the CPU from a ``torch.Generator`` seeded with
        the configuration's ``seed``, and place params and state on
        ``device`` (default the CUDA card)."""
        if self.conf.input_types is None:
            raise ValueError("Configuration needs set_input_types(...) before init()")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.global_conf.seed)
        dtype = _dtype_of(self.conf.global_conf.dtype)
        lt = self.conf.layer_input_types()
        params: Dict[str, Tensors] = {}
        state: Dict[str, Tensors] = {}
        for name in self.layer_names:
            layer = self._layer(name)
            params[name] = {k: v.to(device) for k, v in
                            layer.init_params(gen, lt[name], dtype).items()}
            state[name] = {k: v.to(device) for k, v in
                           layer.init_layer_state(lt[name], dtype).items()}
        self.params_, self.state_, self.device = params, state, device
        self.opt_state_ = self.fault_state_ = None
        self.iteration = self.epoch = 0
        return self

    def clone(self) -> "ComputationGraph":
        """A deep copy (the reference's ``clone()``): the configuration
        through its JSON, params, layer state and updater state copied on
        the model's device, ``iteration`` and ``epoch`` carried over."""
        net = ComputationGraph(ComputationGraphConfiguration.from_json(self.conf.to_json()))
        if self.params_ is not None:
            net.params_, net.state_, net.opt_state_ = _pipeline.tree_map(
                lambda t: t.detach().clone(), (self.params_, self.state_, self.opt_state_))
            net.device = self.device
            net.iteration, net.epoch = self.iteration, self.epoch
        return net

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params_.values() for t in p.values()))

    def params_flat(self) -> np.ndarray:
        """One flat f32 parameter vector: layers in topological order, param
        names sorted (the checkpoint's ``coefficients.bin`` order)."""
        return flatten_tensors([self.params_[n] for n in self.layer_names])

    def set_params_flat(self, vec: np.ndarray) -> None:
        new = unflatten_tensors({n: self.params_[n] for n in self.layer_names}, vec)
        self.params_ = {**self.params_, **new}

    def opt_state_flat(self) -> np.ndarray:
        """One flat f32 updater-state vector: layers in topological order,
        param names, slot names sorted (the checkpoint's
        ``updaterState.bin`` order); zeros before the first train step."""
        opt = self._ensure_opt_state()
        return flatten_tensors([opt[n] for n in self.layer_names])

    def set_opt_state_flat(self, vec: np.ndarray) -> None:
        opt = self._ensure_opt_state()
        new = unflatten_tensors({n: opt[n] for n in self.layer_names}, vec)
        self.opt_state_ = {**opt, **new}

    # -------------------------------------------------------------- forward
    def compute_params(self, params: Optional[Dict[str, Tensors]] = None
                       ) -> Dict[str, Tensors]:
        """``params`` (default ``params_``) cast for the compute dtype."""
        params = self.params_ if params is None else params
        cd = self._compute_dtype
        if cd is None:
            return params
        out = dict(params)
        for name in self.layer_names:
            layer = self._layer(name)
            out[name] = cast_layer_params_for_compute(
                layer, params[name], cd, is_output=layer.is_output_layer)
        return out

    def _forward(self, params, state, inputs, *, train: bool = False,
                 cast_params: bool = True):
        """Forward walk over the topological order. Returns ``(acts,
        out_inputs, new_state)``: every vertex's activation, the input of
        each output layer (what its score is computed from), and each
        layer's new state. ``cast_params=False`` when ``params`` is already
        the output of :meth:`compute_params`."""
        conf = self.conf
        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = self._compute_dtype or _dtype_of(conf.global_conf.dtype)
        inputs = [x.to(in_dt) if x.is_floating_point() else x for x in inputs]
        acts: Dict[str, torch.Tensor] = dict(zip(conf.network_inputs, inputs))
        out_inputs: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Tensors] = {}
        for name in self.topo:
            v = conf.vertices[name]
            in_acts = [acts[s] for s in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                x = in_acts[0]
                if v.preprocessor is not None:
                    x = v.preprocessor.pre_process(x)
                if v.layer.is_output_layer:
                    out_inputs[name] = x
                y, st = v.layer.apply(params.get(name, {}), x,
                                      state=state.get(name, {}), train=train)
                acts[name] = y
                new_state[name] = st if st is not None else {}
            else:
                acts[name] = v.apply(in_acts)
        return acts, out_inputs, new_state

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    # -------------------------------------------------------------- inference
    def output(self, *inputs) -> List[np.ndarray]:
        """Multi-output inference: one numpy array per network output."""
        if self.params_ is None:
            raise ValueError("init() the graph (or load params) first")
        with torch.inference_mode():
            acts, _, _ = self._forward(self.params_, self.state_,
                                       [self._as_input(x) for x in inputs])
        out = []
        for name in self.conf.network_outputs:
            y = acts[name]
            if y.dtype in (torch.bfloat16, torch.float16):
                y = y.float()
            out.append(y.cpu().numpy())
        return out

    def output_single(self, *inputs) -> np.ndarray:
        ys = self.output(*inputs)
        if len(ys) != 1:
            raise ValueError(f"Graph has {len(ys)} outputs; use output()")
        return ys[0]

    # ----------------------------------------------------------------- scoring
    def _loss_and_new_state(self, params, state, features, labels, lmasks,
                            train: bool = True):
        """Mean per-example loss summed over the outputs (f32: under a
        compute dtype the output layer's input is widened first), and the
        layers' new state."""
        _, out_inputs, new_state = self._forward(params, state, features, train=train)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, name in enumerate(self.conf.network_outputs):
            x = out_inputs[name]
            if self._compute_dtype is not None:
                x = x.float()
            lmask = lmasks[i] if i < len(lmasks) else None
            per_ex = self._layer(name).compute_score(params[name], x, labels[i], lmask)
            loss = loss + per_ex.mean()
        return loss, new_state

    @torch.no_grad()
    def _reg_score(self, params) -> torch.Tensor:
        s = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in self.layer_names:
            reg = as_regularization(self._layer(name).regularization)
            if reg is None:
                continue
            for pn, arr in params[name].items():
                s = s + reg.score_term(pn, arr)
        return s

    def _batch(self, mds: MultiDataSet):
        """A MultiDataSet's arrays as tensors on the model's device: float
        features as given (the forward casts them), float labels in f32."""
        feats, labels, lmasks = self._batch_tensors(mds)
        dev = self.device
        return ([f.to(dev) for f in feats], [lab.to(dev) for lab in labels],
                [None if m is None else m.to(dev) for m in lmasks])

    @staticmethod
    def _batch_tensors(mds: MultiDataSet):
        """:meth:`_batch`'s tensors on the host; the arrays of ``mds`` may
        carry a leading K axis (:func:`stack_multi`: a bundled step's
        stacked batch)."""
        if any(m is not None for m in mds.features_masks):
            raise NotImplementedError(f"feature masks are {NOT_PORTED}")

        def tensor(a, label=False):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(torch.float32) if label and t.is_floating_point() else t

        return ([tensor(f) for f in mds.features], [tensor(lab, True) for lab in mds.labels],
                [None if m is None else tensor(m, True) for m in mds.labels_masks])

    def _value_and_grad(self, feats, labels, lmasks, scale=None):
        """(loss, new_state, grads) of a train-mode forward at ``params_``;
        grads has the layout of ``params_``. ``scale``: the fault policy's
        loss scale (the gradients of ``loss * scale``, loss and gradients
        multiplied back by ``1 / scale``)."""
        diff = {v: {k: t.detach().requires_grad_() for k, t in p.items()}
                for v, p in self.params_.items()}
        loss, new_state = self._loss_and_new_state(diff, self.state_, feats,
                                                   labels, lmasks)
        if scale is not None:
            loss = loss * scale
        leaves = [(v, k) for v, p in diff.items() for k in p]
        flat = torch.autograd.grad(loss, [diff[v][k] for v, k in leaves],
                                   allow_unused=True) if leaves else ()
        grads: Dict[str, Tensors] = {v: {} for v in diff}
        for (v, k), g in zip(leaves, flat):
            grads[v][k] = torch.zeros_like(diff[v][k]) if g is None else g
        loss, grads = _faults.unscale(loss.detach(), grads, scale)
        return loss, new_state, grads

    def score(self, ds: Optional[Union[DataSet, MultiDataSet]] = None) -> float:
        """The last train step's score, or the eval-mode loss plus the
        regularization score on ``ds``."""
        if ds is None:
            if self.score_ is None:
                raise ValueError("No score available; fit() first or pass a DataSet")
            return float(self.score_)
        feats, labels, lmasks = self._batch(_as_multi(ds))
        with torch.no_grad():
            loss, _ = self._loss_and_new_state(self.params_, self.state_, feats,
                                               labels, lmasks, train=False)
            return float(loss + self._reg_score(self.params_))

    def compute_gradient_and_score(self, ds: Union[DataSet, MultiDataSet]):
        """(gradients in the layout of ``params_``, score) of one train-mode
        forward on ``ds``; nothing is updated."""
        self._check_trainable()
        feats, labels, lmasks = self._batch(_as_multi(ds))
        loss, _, grads = self._value_and_grad(feats, labels, lmasks)
        return grads, float(loss + self._reg_score(self.params_))

    # ------------------------------------------------------------------- fit
    def set_listeners(self, *listeners) -> None:
        raise NotImplementedError(f"training listeners are {NOT_PORTED}")

    def _check_trainable(self) -> None:
        check_train_conf(self.conf, NOT_PORTED)
        for name in self.layer_names:
            check_trainable(self._layer(name))

    def _ensure_opt_state(self) -> Dict[str, Dict[str, Tensors]]:
        if self.opt_state_ is None:
            self.opt_state_ = {
                name: {pn: as_updater(self._layer(name).updater).init_state(t)
                       for pn, t in self.params_[name].items()}
                for name in self.layer_names}
        return self.opt_state_

    def fit(self, data: Union[DataSet, MultiDataSet, DataSetIterator,
                              MultiDataSetIterator],
            epochs: int = 1, batch_size: int = 32) -> "ComputationGraph":
        """Train: one step per minibatch, ``epochs`` passes. With
        ``steps_per_call`` k > 1, every k consecutive batches of one layout
        take one bundled call (``train/pipeline.py``); the ragged tail of an
        epoch and a change of shape take single steps."""
        if self.params_ is None:
            raise ValueError("init() the graph (or load params) first")
        if isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size)
        if isinstance(data, MultiDataSet):
            data = MultiDataSetIterator.from_list([data])
        k = _pipeline.resolve_steps_per_call(self)
        self._check_trainable()
        policy = self._active_fault_policy()
        if policy is not None:
            self._ensure_fault_state(policy)
        bstep = self._bundle_step(k) if k > 1 else None
        try:
            for _ in range(epochs):
                stream = (_as_multi(ds) for ds in data)
                if bstep is not None:
                    stream = iter_grouped(stream, k, multi_compat_key)
                for item in stream:
                    if isinstance(item, list):
                        self.bundle_scores_ = bstep(self._batch_tensors(stack_multi(item)))
                    else:
                        self._fit_batch(item)
                    _faults.check_fault_state(policy, self.fault_state_, owner=self)
                data.reset()
                self.epoch += 1
        finally:
            if bstep is not None:
                bstep.release()
        return self

    def _fit_batch(self, mds: MultiDataSet) -> None:
        self._train_step(self._batch(mds))

    def _train_step(self, batch) -> None:
        """One train step on a batch of ``_batch`` tensors."""
        self._apply_step(*self._value_and_grad(*batch, scale=self._step_scale()))

    def _bundle_step(self, k: int) -> "_pipeline.BundledStep":
        return bundle_step_of(self, k, self._train_step)

    def _apply_step(self, loss, new_state, grads) -> None:
        """The second half of a train step (``_value_and_grad`` is the
        first): the per-layer updates from ``grads`` (guarded under a fault
        policy, ``nn/multilayer.guarded_update``), the score (``loss`` plus
        the regularization score before the update), the new state,
        ``iteration + 1``."""
        opt_state = self._ensure_opt_state()
        names = self.layer_names

        def update(grads, t, it):
            new_params, new_opt = apply_layer_updates(
                [self._layer(n) for n in names], [self.params_[n] for n in names],
                [grads[n] for n in names], [opt_state[n] for n in names], t, it, self.epoch)
            return dict(zip(names, new_params)), dict(zip(names, new_opt)), new_state

        self.score_ = loss + self._reg_score(self.params_)
        self.params_, self.opt_state_, self.state_ = guarded_update(
            self, grads, update, (self.params_, opt_state, self.state_))
        self.iteration += 1


def stack_multi(group: List[MultiDataSet]) -> MultiDataSet:
    """K same-layout MultiDataSets as one whose arrays carry a leading K
    axis (the stacked batch of a bundled step)."""
    def st(arrays):
        return None if arrays[0] is None else np.stack([np.asarray(a) for a in arrays])

    first = group[0]
    return MultiDataSet(
        [st([m.features[i] for m in group]) for i in range(len(first.features))],
        [st([m.labels[i] for m in group]) for i in range(len(first.labels))],
        [st([m.features_masks[i] for m in group]) for i in range(len(first.features_masks))],
        [st([m.labels_masks[i] for m in group]) for i in range(len(first.labels_masks))])


def _as_multi(ds: Union[DataSet, MultiDataSet]) -> MultiDataSet:
    if isinstance(ds, MultiDataSet):
        return ds
    return MultiDataSet([ds.features], [] if ds.labels is None else [ds.labels],
                        [ds.features_mask], [ds.labels_mask])
