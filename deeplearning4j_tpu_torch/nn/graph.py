"""ComputationGraph: DAG network runtime, inference and training.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the forward
walk over the topological order, ``output``/``output_single``,
``feed_forward``, the streaming ``rnn_time_step``, the train side: ``fit``,
``score``, ``compute_gradient_and_score``, the pure ``train_step_fn``,
``set_learning_rate``; the evaluate family and ``summary``. PyTorch
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
``train/faults.py``), eager and bundled. ``remat_policy`` makes each layer
vertex's train-mode step a checkpointed region (``nn/remat.py``).
A ``CenterLossOutputLayer``'s score reads its centers and its train step
moves them (``nn/conf/layers/special.py``). Listeners and telemetry as in
``nn/multilayer.py``.

Truncated BPTT (``GraphBuilder.backprop_type("tbptt")``, the reference's
graph ``doTruncatedBPTT``): the batch's time-series arrays (3-D features and
labels, 2-D masks of the batch's length) are cut into chunks of
``tbptt_fwd_length`` steps and each chunk is one update from the recurrent
state the previous one left, detached; the other inputs go whole into every
chunk. As the reference's, this path takes no fault policy: it warns that
the policy is not applied and runs the chunks unguarded.

Feature masks flow as in the reference's walk: one (b, T) mask a network
input (``output(*inputs, masks=)``, a MultiDataSet's ``features_masks``),
through each layer vertex's preprocessor (``feed_forward_mask``) into its
layer's ``mask=``; a recurrent layer keeps it, a layer whose output is 2-D
(pooling) consumes it; a vertex is called as the reference calls it,
``apply(inputs, masks, train=, rng=None)``, and ``feed_forward_mask`` gives
its output's mask; LastTimeStep and ReverseTimeSeries read the mask of the
vertex or input their ``mask_input`` names. An output layer's label mask
defaults to the feature mask that reaches it. A bundled step is kept per
mask presence of the batch's slots (:func:`mask_presence`), so a masked and
an unmasked batch never share a captured graph.

Dropout, weight noise and constraints as in the reference's graph, per
layer vertex: preprocessor -> input dropout -> weight noise -> ``apply``,
the input of an output layer taken after its dropout; an output layer's
weight noise is applied in the score path only (a second draw in the
forward would noise the same step twice); constraints follow the shared
update. The dropout RNG is the model's, as ``nn/multilayer.py`` describes:
:meth:`ComputationGraph.step_noise` at the step's iteration, one stream a
layer vertex (its index in ``layer_names``).
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import _dtype_of, param_dtype, resolve_device
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
from deeplearning4j_tpu_torch.nn.conf.dropouts import NoiseSource
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    LastTimeStepVertex,
    ReverseTimeSeriesVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers.base import apply_input_dropout, apply_weight_noise
from deeplearning4j_tpu_torch.nn.conf.layers.special import CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    NetworkMethods,
    _host_array,
    apply_layer_updates,
    bundle_step_of,
    cast_layer_params_for_compute,
    TBPTT_LABELS,
    check_train_conf,
    detach_carries,
    differentiable,
    flatten_tensors,
    gradients_of,
    guarded_update,
    init_generator,
    mask_after,
    pretrain_layer_steps,
    remat_policy_of,
    tbptt_chunks,
    unflatten_tensors,
)
from deeplearning4j_tpu_torch.regularization import as_regularization
from deeplearning4j_tpu_torch.train import faults as _faults
from deeplearning4j_tpu_torch.train import pipeline as _pipeline
from deeplearning4j_tpu_torch.updaters import as_updater, step_iteration

Tensors = Dict[str, torch.Tensor]


class ComputationGraph(NetworkMethods):
    def __init__(self, conf: ComputationGraphConfiguration, *, copy_conf: bool = True):
        # a private copy: layers of the caller's conf are never shared;
        # copy_conf=False for a conf nothing else holds
        self.conf = conf = copy.deepcopy(conf) if copy_conf else conf
        self.topo = conf.topological_order
        self.layer_names: List[str] = [
            n for n in self.topo if isinstance(conf.vertices[n], LayerVertex)]
        self._layer_index = {n: i for i, n in enumerate(self.layer_names)}
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
        #: the dropout RNG's seed (its position is the step's iteration)
        self.noise_seed = int(conf.global_conf.seed)
        #: the dtype float inputs take in the forward when set (the gradient
        #: checker's float64); None: the compute or params dtype
        self._input_dtype: Optional[torch.dtype] = None
        #: the streaming state of :meth:`rnn_time_step`
        self._rnn_carries: Optional[Dict[str, Any]] = None
        #: the training listeners (``train/listeners.py``)
        self.listeners: List[Any] = []
        #: the rows of the last batch a fit step took (``PerformanceListener``)
        self.last_batch_size: Optional[int] = None
        #: the last train step's telemetry dict (device tensors), or None
        self.step_telemetry_: Optional[Dict[str, torch.Tensor]] = None
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
    def init(self, rng=None, device=None) -> "ComputationGraph":
        """Draw the params on the CPU from ``rng`` (a seed or a CPU
        ``torch.Generator``; default one seeded with the configuration's
        ``seed``), and place params and state on ``device`` (default the
        CUDA card)."""
        if self.conf.input_types is None:
            raise ValueError("Configuration needs set_input_types(...) before init()")
        device = resolve_device(device)
        gen = init_generator(rng, self.conf.global_conf.seed)
        dtype = param_dtype(self.conf.global_conf.dtype)
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
        net = ComputationGraph(ComputationGraphConfiguration.from_json(self.conf.to_json()),
                               copy_conf=False)
        if self.params_ is not None:
            net.params_, net.state_, net.opt_state_ = _pipeline.tree_map(
                lambda t: t.detach().clone(), (self.params_, self.state_, self.opt_state_))
            net.device = self.device
            net.iteration, net.epoch = self.iteration, self.epoch
        net.noise_seed = self.noise_seed
        return net

    def step_noise(self, rank: int = 0, ranked_params: bool = False) -> NoiseSource:
        """The noise source of the next train step on ``rank`` (as
        ``MultiLayerNetwork.step_noise``)."""
        return NoiseSource(self.noise_seed, step_iteration(self.iteration), rank,
                           ranked_params=ranked_params)

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
                 cast_params: bool = True, noise=None, remat=None, carries=None,
                 fmasks=None, stop_before_vertex: Optional[str] = None):
        """Forward walk over the topological order. Returns ``(acts,
        out_inputs, new_state)``: every vertex's activation, ``(x, mask)``
        of each output layer (the input its score is computed from, after
        its input dropout, and the feature mask that reaches it), and each
        layer's new state. ``cast_params=False`` when ``params`` is already
        the output of :meth:`compute_params`. ``noise``: the step's noise
        source in training. ``remat``: a train-mode forward's remat policy
        (each layer vertex but the output layers one checkpointed region),
        or None. ``carries``: recurrent layer vertex name -> the state to
        start from (:meth:`_init_carries`); then ``new_carries``, their
        final states, is returned fourth. ``fmasks``: one feature mask (or
        None) a network input. ``stop_before_vertex``: the walk ends before
        that vertex (its inputs' activations are in ``acts``)."""
        conf = self.conf
        if self._compute_dtype is not None and cast_params:
            params = self.compute_params(params)
        # float inputs take the compute dtype, else the params dtype (the
        # reference runs with x64 off: a float64 array computes in f32)
        in_dt = self._input_dtype or self._compute_dtype or param_dtype(conf.global_conf.dtype)
        inputs = [x.to(in_dt) if x.is_floating_point() else x for x in inputs]
        acts: Dict[str, torch.Tensor] = dict(zip(conf.network_inputs, inputs))
        masks: Dict[str, Optional[torch.Tensor]] = {n: None for n in conf.network_inputs}
        for n, m in zip(conf.network_inputs, fmasks or ()):
            masks[n] = m
        out_inputs: Dict[str, tuple] = {}
        new_state: Dict[str, Tensors] = {}
        new_carries: Dict[str, Any] = {}
        for name in self.topo:
            if name == stop_before_vertex:
                break
            v = conf.vertices[name]
            srcs = conf.vertex_inputs[name]
            in_acts = [acts[s] for s in srcs]
            in_masks = [masks[s] for s in srcs]
            if not isinstance(v, LayerVertex):
                # a time-series vertex reads the mask its mask_input names
                if isinstance(v, (LastTimeStepVertex, ReverseTimeSeriesVertex)) \
                        and v.mask_input:
                    in_masks = [masks.get(v.mask_input)] + in_masks[1:]
                acts[name] = v.apply(in_acts, in_masks, train=train, rng=None)
                masks[name] = v.feed_forward_mask(in_masks)
                continue
            r = self._stream(noise, name)
            p_n, st_n = params.get(name, {}), state.get(name, {})
            if v.layer.is_output_layer:
                # the score reads the input after its dropout; the head is
                # no region
                x, m = self._vertex_input(v, in_acts[0], in_masks[0], train, r)
                out_inputs[name] = (x, m)
                y, st = v.layer.apply(p_n, x, state=st_n, train=train, rng=r, mask=m)
                c = None
            else:
                step = functools.partial(self._vertex_step, v, p_n, st_n, train, r,
                                         None if carries is None else carries.get(name))
                if remat is not None and train:
                    y, m, st, c = remat.region(v.layer, step, in_acts[0], in_masks[0])
                else:
                    y, m, st, c = step(in_acts[0], in_masks[0])
            acts[name] = y
            masks[name] = mask_after(v.layer, y, m)
            new_state[name] = st if st is not None else {}
            if c is not None:
                new_carries[name] = c
        if carries is not None:
            return acts, out_inputs, new_state, new_carries
        return acts, out_inputs, new_state

    @staticmethod
    def _vertex_input(v, x, m, train: bool, r):
        """A layer vertex's input and mask: its preprocessor (which maps the
        mask too), then its input dropout."""
        if v.preprocessor is not None:
            x = v.preprocessor.pre_process(x, m)
            m = v.preprocessor.feed_forward_mask(m)
        return apply_input_dropout(v.layer, x, train, r), m

    def _vertex_step(self, v, p_n, st_n, train: bool, r, carry, x, m):
        """One layer vertex (not an output layer): ``(y, mask, new_state,
        new_carry)`` from its input ``x`` and mask ``m`` (its preprocessor,
        input dropout, weight noise and ``apply``; from ``carry`` where it is
        a recurrent layer's); ``mask`` is the one its layer saw."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        x, m = self._vertex_input(v, x, m, train, r)
        p_n = apply_weight_noise(v.layer, p_n, train, r)
        if carry is not None and isinstance(v.layer, BaseRecurrentLayer):
            y, c = v.layer.apply_with_carry(p_n, x, carry, mask=m, train=train, rng=r)
            return y, m, st_n, c
        y, st = v.layer.apply(p_n, x, state=st_n, train=train, rng=r, mask=m)
        return y, m, st, None

    def _stream(self, noise, name: str):
        """Layer vertex ``name``'s noise stream (None without noise)."""
        return None if noise is None else noise.child(self._layer_index[name])

    def _as_input(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device)

    def _as_masks(self, masks) -> Optional[List[Optional[torch.Tensor]]]:
        """Feature masks as f32 tensors on the model's device (None stays)."""
        if masks is None:
            return None
        return [None if m is None else self._as_input(m).float() for m in masks]

    # -------------------------------------------------------------- inference
    def output(self, *inputs, masks: Optional[Sequence] = None) -> List[np.ndarray]:
        """Multi-output inference: one numpy array per network output.
        ``masks``: one (b, T) feature mask (or None) a network input."""
        if self.params_ is None:
            raise ValueError("init() the graph (or load params) first")
        with torch.inference_mode():
            acts, _, _ = self._forward(self.params_, self.state_,
                                       [self._as_input(x) for x in inputs],
                                       fmasks=self._as_masks(masks))
        return [_host(acts[name]) for name in self.conf.network_outputs]

    def output_single(self, *inputs, masks: Optional[Sequence] = None) -> np.ndarray:
        ys = self.output(*inputs, masks=masks)
        if len(ys) != 1:
            raise ValueError(f"Graph has {len(ys)} outputs; use output()")
        return ys[0]

    # ----------------------------------------------------------------- scoring
    def _loss_and_new_state(self, params, state, features, labels, fmasks, lmasks,
                            train: bool = True, noise=None, remat=None, carries=None):
        """Mean per-example loss summed over the outputs (f32: under a
        compute dtype the output layer's input is widened first), and the
        layers' new state. An output layer's label mask defaults to the
        feature mask that reaches it. An output layer's weight noise is drawn
        here. ``remat``: the train step's remat policy. ``carries`` (a tBPTT
        chunk): the walk starts from them, and their final values come back
        third."""
        walked = self._forward(params, state, features, train=train, noise=noise,
                               remat=remat, fmasks=fmasks, carries=carries)
        out_inputs, new_state = walked[1], walked[2]
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, name in enumerate(self.conf.network_outputs):
            x, m = out_inputs[name]
            if self._compute_dtype is not None:
                x = x.float()
            lmask = lmasks[i] if lmasks is not None and i < len(lmasks) else None
            if lmask is None:
                lmask = m
            layer = self._layer(name)
            p_out = apply_weight_noise(layer, params[name],
                                       train and noise is not None, self._stream(noise, name))
            if isinstance(layer, CenterLossOutputLayer):
                # the score reads the centers from before this step's update
                per_ex = layer.compute_score(p_out, x, labels[i], lmask, state=state[name])
                if train:
                    new_state[name] = layer.update_centers(new_state[name], x, labels[i])
            else:
                per_ex = layer.compute_score(p_out, x, labels[i], lmask)
            loss = loss + per_ex.mean()
        if carries is not None:
            return loss, new_state, walked[3]
        return loss, new_state

    def _reg_score(self, params) -> torch.Tensor:
        """The regularization score of ``params`` (differentiable where they
        require gradients: the gradient checker's loss)."""
        s = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in self.layer_names:
            reg = as_regularization(self._layer(name).regularization)
            if reg is None:
                continue
            for pn, arr in params[name].items():
                s = s + reg.score_term(pn, arr)
        return s

    def _batch(self, mds: MultiDataSet):
        """A MultiDataSet's arrays as tensors on the model's device,
        ``(features, labels, feature masks, label masks)``: float features
        as given (the forward casts them), float labels and masks in f32."""
        return _pipeline.tree_map(lambda t: t.to(self.device), self._batch_tensors(mds))

    @staticmethod
    def _batch_tensors(mds: MultiDataSet):
        """:meth:`_batch`'s tensors on the host; the arrays of ``mds`` may
        carry a leading K axis (:func:`stack_multi`: a bundled step's
        stacked batch)."""
        def tensor(a, f32=False):
            if a is None:
                return None
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(torch.float32) if f32 and t.is_floating_point() else t

        return ([tensor(f) for f in mds.features], [tensor(lab, True) for lab in mds.labels],
                [tensor(m, True) for m in mds.features_masks],
                [tensor(m, True) for m in mds.labels_masks])

    def _value_and_grad(self, feats, labels, fmasks=None, lmasks=None, scale=None,
                        noise=None, params=None, state=None, carries=None):
        """(loss, new_state, grads) of a train-mode forward at ``params`` and
        ``state`` (default ``params_``, ``state_``), under the configuration's
        remat policy; grads has the layout of ``params_``. ``scale``: the
        fault policy's loss scale (the gradients of ``loss * scale``, loss
        and gradients multiplied back by ``1 / scale``). ``noise``: the
        step's noise source (default :meth:`step_noise` on rank 0).
        ``carries`` (a tBPTT chunk): the walk starts from them, and the
        final carries, detached, come back fourth."""
        params = self.params_ if params is None else params
        diff = differentiable({v: self._layer(v) for v in params}, params)
        out = self._loss_and_new_state(
            diff, self.state_ if state is None else state, feats, labels, fmasks, lmasks,
            noise=self.step_noise() if noise is None else noise,
            remat=remat_policy_of(self), carries=carries)
        loss, new_state = out[0], out[1]
        if scale is not None:
            loss = loss * scale
        grads = gradients_of(loss, diff)
        loss, grads = _faults.unscale(loss.detach(), grads, scale)
        if carries is not None:
            return loss, new_state, grads, detach_carries(out[2])
        return loss, new_state, grads

    def score(self, ds: Optional[Union[DataSet, MultiDataSet]] = None) -> float:
        """The last train step's score, or the eval-mode loss plus the
        regularization score on ``ds``."""
        if ds is None:
            if self.score_ is None:
                raise ValueError("No score available; fit() first or pass a DataSet")
            return float(self.score_)
        with torch.no_grad():
            loss, _ = self._loss_and_new_state(self.params_, self.state_,
                                               *self._batch(_as_multi(ds)), train=False)
            return float(loss + self._reg_score(self.params_))

    def compute_gradient_and_score(self, ds: Union[DataSet, MultiDataSet]):
        """(gradients in the layout of ``params_``, score) of one train-mode
        forward on ``ds``; nothing is updated."""
        self._check_trainable()
        loss, _, grads = self._value_and_grad(*self._batch(_as_multi(ds)))
        return grads, float(loss + self._reg_score(self.params_))

    # ------------------------------------------------------------------- fit
    def _check_trainable(self) -> None:
        check_train_conf(self.conf)

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
        epoch and a change of shape take single steps. Under
        ``backprop_type("tbptt")`` a batch whose first input is 3-D is
        trained in chunks (:meth:`_fit_tbptt_batch`)."""
        if self.params_ is None:
            raise ValueError("init() the graph (or load params) first")
        if isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size)
        if isinstance(data, MultiDataSet):
            data = MultiDataSetIterator.from_list([data])
        self._fit_epochs(data, epochs)
        return self

    def _epoch_stream(self, it, k: int):
        stream = (_as_multi(ds) for ds in it)
        return iter_grouped(stream, k, multi_compat_key) if k > 1 else stream

    def _fit_item(self, item, k: int) -> None:
        if isinstance(item, list):
            bstep = self._bundle_step(k, mask_presence(item[0]))
            self._fit_bundle(bstep, self._batch_tensors(stack_multi(item)))
        elif (getattr(self.conf, "backprop_type", "standard") == "tbptt"
              and np.ndim(item.features[0]) == 3):
            self._fit_tbptt_batch(item)
        else:
            self._fit_batch(item)

    def _release_bundles(self) -> None:
        # the model's state lies in the buffers of the bundle that ran last
        if self._bundled is not None:
            self._bundled.release()

    def _fit_batch(self, mds: MultiDataSet) -> None:
        self._fit_single(self._batch(mds))

    # ----------------------------------------------------------------- tBPTT
    def _fit_tbptt_batch(self, mds: MultiDataSet) -> None:
        """One batch of truncated BPTT over the graph: each time-series array
        (3-D data, a 2-D mask, of the first input's length) cut by chunk,
        the others whole; one unguarded update a chunk from the carries the
        last one left; then ``iteration + 1`` and ``iteration_done``."""
        if self._active_fault_policy() is not None:
            import warnings

            warnings.warn(
                "fault_policy is not applied on the ComputationGraph tBPTT path: "
                "non-finite gradient chunks are NOT skipped and loss scaling is off "
                "(use MultiLayerNetwork tBPTT or standard backprop for guarded training)",
                stacklevel=4)
        for lab in mds.labels:
            if lab is not None and np.ndim(lab) != 3:
                raise ValueError("tBPTT requires per-timestep labels (batch, time, nOut); "
                                 f"got shape {tuple(np.shape(lab))}")
        feats, labels, fmasks, lmasks = self._batch(mds)
        T = feats[0].shape[1]

        def cut(a, lo, hi, is_mask=False):
            if a is None:
                return None
            seq = (a.dim() == 3 or (is_mask and a.dim() == 2)) and a.shape[1] == T
            return a[:, lo:hi] if seq else a

        carries = self._init_carries(feats[0].shape[0])
        opt_state = self._ensure_opt_state()
        for c, lo, hi in tbptt_chunks(T, self.conf.tbptt_fwd_length):
            loss, new_state, grads, carries = self._value_and_grad(
                [cut(f, lo, hi) for f in feats], [cut(lab, lo, hi) for lab in labels],
                [cut(m, lo, hi, True) for m in fmasks], [cut(m, lo, hi, True) for m in lmasks],
                noise=self.chunk_noise(c), carries=carries)
            self.score_ = loss + self._reg_score(self.params_)
            self.params_, opt_state = self._layer_updates(
                self.params_, grads, opt_state, self.iteration + 1, self.iteration, self.epoch)
            self.opt_state_ = opt_state
            self.state_ = new_state
        self.iteration += 1
        self.last_batch_size = int(feats[0].shape[0])
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    def _introspect(self, batch):
        """Every vertex's activation (numpy, by name; an output layer's from
        its weight-noised params) and the gradients of the step on ``batch``
        that comes next, with its noise."""
        feats, labels, fmasks, lmasks = batch
        noise = self.step_noise()
        with torch.no_grad():
            acts, out_inputs, _ = self._forward(self.params_, self.state_, feats, train=True,
                                                noise=noise, fmasks=fmasks)
            for name in self.conf.network_outputs:
                layer = self._layer(name)
                x, m = out_inputs[name]
                if self._compute_dtype is not None:
                    x = x.float()
                r = self._stream(noise, name)
                acts[name], _ = layer.apply(apply_weight_noise(layer, self.params_[name], True, r),
                                            x, state=self.state_[name], train=True, rng=r, mask=m)
        _, _, grads = self._value_and_grad(feats, labels, fmasks, lmasks,
                                           scale=self._step_scale(), noise=noise)
        return {k: _host_array(v) for k, v in acts.items()}, grads

    def _train_step(self, batch) -> None:
        """One train step on a batch of ``_batch`` tensors."""
        self._apply_step(*self._value_and_grad(*batch, scale=self._step_scale()))

    def _bundle_step(self, k: int, masks=None) -> "_pipeline.BundledStep":
        """The bundled step at ``k`` for batches of the mask presence
        ``masks`` (:func:`mask_presence`)."""
        return bundle_step_of(self, k, self._train_step, variant=masks)

    def _apply_step(self, loss, new_state, grads) -> None:
        """The second half of a train step (``_value_and_grad`` is the
        first): the per-layer updates from ``grads`` (guarded under a fault
        policy, ``nn/multilayer.guarded_update``), the score (``loss`` plus
        the regularization score before the update), the new state,
        ``iteration + 1``."""
        opt_state = self._ensure_opt_state()

        def update(grads, t, it):
            return self._layer_updates(self.params_, grads, opt_state, t, it,
                                       self.epoch) + (new_state,)

        self.score_ = loss + self._reg_score(self.params_)
        self.params_, self.opt_state_, self.state_ = guarded_update(
            self, grads, update, (self.params_, opt_state, self.state_))
        self.iteration += 1

    def _layer_updates(self, params, grads, opt_state, t, iteration, epoch):
        """:func:`apply_layer_updates` over the layer vertices' dicts."""
        names = self.layer_names
        new_params, new_opt = apply_layer_updates(
            [self._layer(n) for n in names], [params[n] for n in names],
            [grads[n] for n in names], [opt_state[n] for n in names], t, iteration, epoch)
        return dict(zip(names, new_params)), dict(zip(names, new_opt))

    def _pure_grads(self, params, state, features, labels, fmasks, lmasks, scale, noise):
        return self._value_and_grad(list(features), list(labels),
                                    None if fmasks is None else list(fmasks),
                                    list(lmasks or []), scale=scale, noise=noise,
                                    params=params, state=state)

    def _updater_layers(self):
        return [self._layer(n) for n in self.layer_names]

    # --------------------------------------------------------------- pretrain
    def pretrain(self, it, epochs: int = 1, noise=None) -> "ComputationGraph":
        """Greedy unsupervised pretraining of every layer vertex whose layer
        can be pretrained, in topological order (``noise``: as
        :meth:`pretrain_layer`'s, the draws of all of them)."""
        for name in self.layer_names:
            if self._layer(name).is_pretrain_layer:
                self.pretrain_layer(name, it, epochs=epochs, noise=noise)
        return self

    def pretrain_layer(self, name: str, it, epochs: int = 1, noise=None) -> "ComputationGraph":
        """Unsupervised pretraining of layer vertex ``name``: the walk in
        inference mode up to the vertex, its input through its preprocessor,
        then the layer's ``pretrain_loss`` minimized over its params alone
        (``nn/multilayer.pretrain_layer_steps``; ``noise``: the draws of every
        step, for tests). A layer that cannot be pretrained raises
        ``ValueError``."""
        if not self._layer(name).is_pretrain_layer:
            raise ValueError(f"Layer vertex '{name}' is not pretrainable")
        v = self.conf.vertices[name]
        src = self.conf.vertex_inputs[name][0]

        def layer_input(ds):
            feats = [self._as_input(f) for f in _as_multi(ds).features]
            acts, _, _ = self._forward(self.params_, self.state_, feats,
                                       stop_before_vertex=name)
            x = acts[src]
            # no feature masks reach the walk here, so the mask is None
            return x if v.preprocessor is None else v.preprocessor.pre_process(x, None)

        pretrain_layer_steps(self, name, self._layer_index[name], it, epochs, layer_input,
                             noise)
        return self

    # -------------------------------------------------- evaluation, streaming
    def _eval_output(self, ds: DataSet) -> np.ndarray:
        return self.output_single(ds.features, masks=[ds.features_mask])

    def feed_forward(self, *inputs, train: bool = False,
                     masks: Optional[Sequence] = None) -> Dict[str, np.ndarray]:
        """Every vertex's activation, the network inputs included, by name
        (the reference's ``feedForward``), as numpy; ``train``: layers in
        train mode (BN batch statistics, dropout from
        :meth:`introspection_noise`), the model unchanged; ``masks``: one
        feature mask (or None) a network input."""
        with torch.no_grad():
            acts, _, _ = self._forward(self.params_, self.state_,
                                       [self._as_input(x) for x in inputs], train=train,
                                       noise=self.introspection_noise() if train else None,
                                       fmasks=self._as_masks(masks))
        return {k: _host(v) for k, v in acts.items()}

    def _init_carries(self, batch: int, dtype=torch.float32) -> Dict[str, Any]:
        """Zero recurrent state for ``batch`` rows on the model's device, by
        recurrent layer vertex."""
        from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import BaseRecurrentLayer

        return {n: self._layer(n).init_carry(batch, dtype, self.device)
                for n in self.layer_names if isinstance(self._layer(n), BaseRecurrentLayer)}

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, *inputs) -> List[np.ndarray]:
        """Stateful streaming inference (the reference's ``rnnTimeStep``):
        the recurrent state carries over from the last call. A 2-D input is
        one time step, and a 3-D output then comes back as its last step."""
        feats, squeeze = [], False
        for x in inputs:
            x = self._as_input(x)
            if x.dim() == 2:
                x, squeeze = x[:, None, :], True
            feats.append(x)
        if self._rnn_carries is None:
            # the input's dtype, as the reference (which has no float64)
            dt = torch.float32 if feats[0].dtype == torch.float64 else feats[0].dtype
            self._rnn_carries = self._init_carries(feats[0].shape[0], dt)
        with torch.inference_mode():
            acts, _, _, self._rnn_carries = self._forward(self.params_, self.state_, feats,
                                                          carries=self._rnn_carries)
        out = []
        for name in self.conf.network_outputs:
            y = _host(acts[name])
            out.append(y[:, -1, :] if squeeze and y.ndim == 3 else y)
        return out

    def summary(self) -> str:
        """Vertex table: name, kind, inputs, #params (the reference's)."""
        rows = [("vertex", "kind", "inputs", "params")]
        total = 0
        for name in self.topo:
            v = self.conf.vertices[name]
            kind = type(v.layer).__name__ if isinstance(v, LayerVertex) else type(v).__name__
            n = 0
            if self.params_ is not None and name in self.params_ and isinstance(v, LayerVertex):
                n = int(sum(t.numel() for t in self.params_[name].values()))
            total += n
            rows.append((name, kind, ", ".join(self.conf.vertex_inputs.get(name, ())),
                         f"{n:,}"))
        for name in self.conf.network_inputs:
            rows.insert(1, (name, "NetworkInput", "", "0"))
        widths = [max(len(r[c]) for r in rows) for c in range(4)]
        lines = ["  ".join(r[c].ljust(widths[c]) for c in range(4)) for r in rows]
        lines.insert(1, "-" * (sum(widths) + 6))
        lines.append(f"Total parameters: {total:,}")
        return "\n".join(lines)


def mask_presence(mds: MultiDataSet) -> Optional[tuple]:
    """Which slots of a batch carry a feature mask and a label mask (None
    where none does): the key of a graph's bundled steps beside their
    layout."""
    key = (tuple(m is not None for m in mds.features_masks),
           tuple(m is not None for m in mds.labels_masks))
    return key if any(key[0] + key[1]) else None


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


def _host(y: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host (f32 for a bf16 or f16 one)."""
    if y.dtype in (torch.bfloat16, torch.float16):
        y = y.float()
    return y.cpu().numpy()


def _as_multi(ds: Union[DataSet, MultiDataSet]) -> MultiDataSet:
    if isinstance(ds, MultiDataSet):
        return ds
    return MultiDataSet([ds.features], [] if ds.labels is None else [ds.labels],
                        [ds.features_mask], [ds.labels_mask])
