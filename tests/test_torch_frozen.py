"""FrozenLayer against the JAX package on the CPU.

A frozen layer runs in inference mode inside a train step (BN's running
statistics, never moved; no dropout, its wrapped layer's included) and no
update touches its params or updater state, while gradients still flow
through it to the trainable layers before it; its l2 term counts in the
score. Each network holds trainable layers before and after frozen ones.

- A list network and a graph: 3 ``fit`` steps against JAX's from the same
  params (carried as numpy), eager, bundled (``steps_per_call`` 3) and
  guarded (a fault policy): the frozen tensors ``torch.equal`` to their
  values before, the trainable params, updater slots, layer state and
  scores within FIT_TOL (1e-5) of JAX's.
- No gradient is recorded for a frozen prefix (its forward records no
  backward); a frozen fused bottleneck launches no backward op, and the
  first trainable block after it only the dx ops its inputs need.
- Under a compute dtype the wrapped layer's f32 params stay f32.
- JAX's JSON of a FrozenLayer decodes in the port and re-encodes equal.
ZeRO-1 and the shared-training master over 2 and 4 gloo ranks are in
``tests/test_torch_parallel.py`` (``frozen/*``).
"""

import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train.faults import FaultPolicy as JFaultPolicy
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train.faults import FaultPolicy as TFaultPolicy

FIT_TOL = 1e-5
JAX = (jconf, jlayers, jupd, JFaultPolicy)
PORT = (tconf, tlayers, tupd, TFaultPolicy)
STEPS = 3


def _builder(pkg, k=1, guarded=False):
    conf, _, upd, policy = pkg
    b = conf.NeuralNetConfiguration.builder().seed(5).updater(upd.Nesterovs(0.05, 0.9)).l2(1e-3)
    if k > 1:
        b = b.steps_per_call(k)
    if guarded:
        b = b.fault_policy(policy())
    return b


def mln(pkg, **kw):
    """conv -> frozen BN -> frozen conv (dropout on the wrapped layer) ->
    max pool -> dense -> output."""
    conf, layers = pkg[:2]
    F = layers.FrozenLayer
    return (_builder(pkg, **kw).list()
            .layer(layers.ConvolutionLayer(n_out=4, kernel_size=3, activation="tanh"))
            .layer(F(layer=layers.BatchNormalization()))
            .layer(F(layer=layers.ConvolutionLayer(n_out=5, kernel_size=2, activation="relu",
                                                   dropout=0.5)))
            .layer(layers.SubsamplingLayer(kernel_size=2, stride=2))
            .layer(layers.DenseLayer(n_out=6, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.convolutional(8, 8, 2)).build())


def graph(pkg, **kw):
    """in -> dense "a" -> frozen dense "f1" and frozen BN "f2" (both on a),
    merged -> dense "b" -> output; a frozen dense "f0" on the input feeds
    the merge too (a frozen prefix)."""
    conf, layers = pkg[:2]
    F = layers.FrozenLayer
    return (_builder(pkg, **kw).graph_builder().add_inputs("in")
            .add_layer("a", layers.DenseLayer(n_out=6, activation="tanh"), "in")
            .add_layer("f0", F(layer=layers.DenseLayer(n_out=3, activation="relu")), "in")
            .add_layer("f1", F(layer=layers.DenseLayer(n_out=4, activation="tanh")), "a")
            .add_layer("f2", F(layer=layers.BatchNormalization()), "a")
            .add_layer("b", layers.DenseLayer(n_out=5, activation="tanh"), "f0", "f1", "f2")
            .add_layer("out", layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "b")
            .set_outputs("out").set_input_types(conf.InputType.feed_forward(5)).build())


NETS = {"mln": (mln, JNet, TNet, (8, 8, 2), ("layer1", "layer2")),
        "graph": (graph, JGraph, TGraph, (5,), ("f0", "f1", "f2"))}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_state(jnet):
    """Running statistics away from (0, 1), so a frozen BN is no identity."""
    rng = np.random.default_rng(7)

    def fix(d):
        out = dict(d)
        for k, v in d.items():
            if k.startswith("mean"):
                out[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.3
            elif k.startswith("var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return out

    s = jnet.state_
    jnet.state_ = ({n: fix(d) for n, d in s.items()} if isinstance(s, dict)
                   else [fix(d) for d in s])


def pair(name, **kw):
    build, jcls, tcls = NETS[name][:3]
    jnet = jcls(build(JAX, **kw)).init()
    randomize_state(jnet)
    tnet = tcls(build(PORT, **kw)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return jnet, tnet


def data(name, seed):
    shape = NETS[name][3]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    return x, y


def _frozen(net, name):
    keys = NETS[name][4]
    if isinstance(net.params_, dict):
        return {k: (net.params_[k], net.state_[k], net.opt_state_[k]) for k in keys}
    return {k: (net.params_[int(k[5:])], net.state_[int(k[5:])], net.opt_state_[int(k[5:])])
            for k in keys}


def _clone(tree):
    return jax.tree_util.tree_map(lambda t: t.clone(), tree)


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("mode", ["eager", "bundled", "guarded"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_fit_tracks_jax_and_keeps_frozen_tensors(name, mode):
    kw = {"k": STEPS} if mode == "bundled" else {"guarded": True} if mode == "guarded" else {}
    jnet, tnet = pair(name, **kw)
    tnet._ensure_opt_state()
    before = _clone(_frozen(tnet, name))
    batches = [data(name, 10 + i) for i in range(STEPS)]
    scores = []
    if mode == "bundled":
        jnet.fit(jax_iter(batches))
        tnet.fit(ExistingDataSetIterator([TDataSet(x, y) for x, y in batches]))
        assert tnet.bundle_scores_ is not None  # one bundle of 3
        scores = [(float(jnet.score()), tnet.score())]
    else:
        for x, y in batches:
            jnet.fit(JDataSet(x, y), batch_size=6)
            tnet.fit(TDataSet(x, y), batch_size=6)
            scores.append((float(jnet.score()), tnet.score()))
    assert tnet.iteration == jnet.iteration == STEPS
    assert _equal(_frozen(tnet, name), before)
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)
    for mine, theirs in zip(jax.tree_util.tree_leaves(interop.export_state(tnet)),
                            jax.tree_util.tree_leaves(numpy_tree(jnet.state_))):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=FIT_TOL)
    for sj, st in scores:
        assert abs(sj - st) <= FIT_TOL, scores


def jax_iter(batches):
    from deeplearning4j_tpu.data.iterators import ExistingDataSetIterator as JExisting

    return JExisting([JDataSet(x, y) for x, y in batches])


@pytest.mark.parametrize("name", sorted(NETS))
def test_score_counts_the_frozen_l2(name):
    """The score's l2 term counts the frozen layers' params, as JAX's
    ``_reg_score`` does."""
    jnet, tnet = pair(name)
    x, y = data(name, 3)
    assert abs(tnet.score(TDataSet(x, y)) - float(jnet.score(JDataSet(x, y)))) <= FIT_TOL
    reg = float(tnet._reg_score(tnet.params_))
    keys = NETS[name][4]
    frozen = sum(float((t.double() ** 2).sum()) for k in keys
                 for t in _frozen(tnet, name)[k][0].values())
    assert frozen > 0 and reg >= 0.5 * 1e-3 * frozen - 1e-6


def test_no_gradient_is_recorded_for_a_frozen_prefix():
    """A frozen layer records no backward unless its input needs one; its
    gradients come back as zeros."""
    _, tnet = pair("graph")
    seen = {}
    for name in ("f0", "f1"):
        layer = tnet.conf.vertices[name].layer
        apply = layer.apply

        def spy(params, x, _n=name, _apply=apply, **kw):
            y, st = _apply(params, x, **kw)
            seen[_n] = y.requires_grad
            return y, st

        layer.apply = spy
    x, y = data("graph", 4)
    grads, _ = tnet.compute_gradient_and_score(TDataSet(x, y))
    assert seen == {"f0": False, "f1": True}
    assert all(torch.count_nonzero(g) == 0 for g in grads["f0"].values())
    assert all(torch.count_nonzero(g) > 0 for g in grads["a"].values())


def test_frozen_fused_blocks_run_no_backward_op(monkeypatch):
    """Two frozen fused bottlenecks then a trainable one (projection,
    stride 2) and another, the differentiable ops on the CPU (their plain
    versions behind the autograd function): the frozen blocks launch no
    backward op; the first trainable block's conv a and projection read the
    frozen output, so they launch a dW op and no dx op."""
    from deeplearning4j_tpu_torch.nn.conf.layers.fused_block import FusedResNetBottleneck
    from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

    monkeypatch.setattr(FusedResNetBottleneck, "uses_kernels", lambda self, x: True)
    calls = {}

    def counted(op, i, fn):
        def run(*a):
            key = f"{op}_{['fwd', 'dx', 'dw'][i]}"
            calls[key] = calls.get(key, 0) + 1
            return fn(*a)
        return run

    monkeypatch.setattr(fc, "_OPS", {op: tuple(counted(op, i, f) for i, f in enumerate(fns))
                                     for op, fns in fc._OPS.items()})
    F, B = tlayers.FrozenLayer, FusedResNetBottleneck
    conf = (tconf.NeuralNetConfiguration.builder().seed(2).updater(tupd.Sgd(0.1)).list()
            .layer(F(layer=B(width=4, project=True)))
            .layer(F(layer=B(width=4)))
            .layer(B(width=8, stride=2, project=True))
            .layer(B(width=8))
            .layer(tlayers.GlobalPoolingLayer(pooling_type="avg"))
            .layer(tlayers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(tconf.InputType.convolutional(8, 8, 3)).build())
    net = TNet(conf).init(device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    before = _clone(net.params_[:2])
    net.fit(TDataSet(x, y))
    # forward: 4 blocks x (2 pw + 1 c3) + 2 projections; backward: block 3
    # dW for a, c, p and dx for c; block 4 dx and dW for a and c; one 3x3
    # dx and dW in each trainable block
    assert calls == {"pw_fwd": 10, "c3_fwd": 4, "pw_dx": 3, "pw_dw": 5, "c3_dx": 2, "c3_dw": 2}
    assert _equal(net.params_[:2], before)


def test_compute_dtype_keeps_the_wrapped_layers_f32_params():
    from deeplearning4j_tpu_torch.nn.conf.layers.fused_block import FusedResNetBottleneck
    from deeplearning4j_tpu_torch.nn.multilayer import cast_layer_params_for_compute

    block = FusedResNetBottleneck(width=4, project=True)
    p = {"W_a": torch.ones(3, 4), "gamma_a": torch.ones(4)}
    for layer in (block, tlayers.FrozenLayer(layer=block)):
        out = cast_layer_params_for_compute(layer, p, torch.bfloat16, is_output=False)
        assert out["W_a"].dtype == torch.bfloat16 and out["gamma_a"].dtype == torch.float32
    bn = {"gamma": torch.ones(4)}
    out = cast_layer_params_for_compute(tlayers.FrozenLayer(layer=tlayers.BatchNormalization()),
                                        bn, torch.bfloat16, is_output=False)
    assert out["gamma"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(NETS))
def test_json_both_ways(name):
    build = NETS[name][0]
    jc, tc = build(JAX), build(PORT)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    back = type(tc).from_json(jc.to_json())
    assert json.loads(back.to_json()) == json.loads(jc.to_json())
    layer = back.layers[1] if name == "mln" else back.vertices["f2"].layer
    assert isinstance(layer, tlayers.FrozenLayer)
    assert isinstance(layer.layer, tlayers.BatchNormalization)


def test_inference_output_equals_jax():
    for name in sorted(NETS):
        jnet, tnet = pair(name)
        x, _ = data(name, 5)
        if name == "mln":
            np.testing.assert_allclose(tnet.output(x), np.asarray(jnet.output(x)), atol=1e-5)
        else:
            np.testing.assert_allclose(tnet.output_single(x),
                                       np.asarray(jnet.output_single(x)), atol=1e-5)
