"""The port's model zoo against the JAX package's, on the CPU.

- The registry: all 13 reference names build through ``ModelSelector``;
  each new configuration (and ResNet-50's space-to-depth stem) writes the
  JAX configuration's JSON; at full width each model's parameter count,
  summed from its configuration, equals JAX's.
- Forward: each of the eight new models at a reduced size (JAX's
  ``tests/test_zoo.py`` small sizes) from the port's seeded weights,
  carried into the JAX network (BN statistics and affine params
  randomized first, YOLO heads' last conv scaled so ``exp`` stays
  moderate), eval mode, within ``FWD_TOL`` (1e-5) of the largest output.
- One ``fit`` step at ``Nesterovs(1e-3, 0.9)`` of YOLO2 (the YOLO loss),
  FaceNetNN4Small2 (the center loss, with its centers) and Darknet19
  (``LossLayer``), and ResNet-50 with the space-to-depth stem (32x32),
  against JAX from carried params and state: the score and the new layer
  state (the centers included) within ``FIT_TOL`` (1e-5, relative to the
  largest value; ResNet-50 ``RESNET_FIT_TOL``, 5e-4: its train-mode BN
  over 1x1 maps); the head's update within ``HEAD_TOL`` (1e-4: its input
  comes through the whole train-mode forward, which the two packages
  round apart by up to 5e-5 at depth); the whole update within
  ``UPDATE_TOL`` (5e-2, the norm of the difference over the norm of JAX's
  update): a ReLU or leaky-ReLU unit whose pre-activation lies within f32
  rounding of 0 takes another branch in either package and moves the
  gradients below it by the unit's whole share (seen from 5e-5 to 3.1e-2
  of the whole update, up to 0.15 of one tensor's).
- YOLO's rank-4 labels through ``score``, ``fit(DataSet)``'s batching and
  an emulated bundle.
- Center loss on every fit path: eager, emulated bundled (k 2), guarded
  (a ``FaultPolicy``, with a NaN step skipped, centers kept), remat
  "nothing", the one-rank ``ParallelWrapper`` (replicated and ZeRO-1)
  ``torch.equal`` to eager; the centers move on the first step; the
  centers travel in the zip both ways (JAX <-> port); ``score`` reads the
  centers from before the update; ``SharedTrainingMaster`` refuses a
  center-loss network (layer state), as JAX's does; class means over two
  ranks are the global batch's.
- ``init_pretrained``: the committed LeNet fixture reproduces its golden
  output (1e-5 / 1e-4), a checksum mismatch, a missing path, the per-class
  registries, and the download from a local HTTP server (resumed from a
  partial file, a bad download deleted, a staged file kept, 416 on a
  complete part). Nothing leaves the machine.
- Labels: decoding, the embedded lists, the cached file, placeholders.
"""

import http.server
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.models as J
import deeplearning4j_tpu.updaters as jupd
import deeplearning4j_tpu_torch.models as T
import deeplearning4j_tpu_torch.updaters as tupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import batch_stats
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster
from deeplearning4j_tpu_torch.train import pipeline
from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection
from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser, ModelSerializer

FWD_TOL = 1e-5     # eval-mode outputs, relative to the largest
FIT_TOL = 1e-5     # a fit step's score and layer state (centers)
HEAD_TOL = 1e-4    # the head's update: its input is the deep train-mode forward
UPDATE_TOL = 5e-2  # a fit step's whole update, norm-relative (ReLU branches)
# ResNet-50 at 32x32: its last stage's train-mode BN takes the statistics
# of 1x1 maps over 8 examples, which carries f32 rounding through 53 BN
# layers up to ~5e-5 of the score and the running statistics, 1.5e-4 of
# the head's update
RESNET_FIT_TOL = 5e-4

NEW = ("alexnet", "simplecnn", "googlenet", "darknet19", "tinyyolo", "yolo2",
       "facenetnn4small2", "inceptionresnetv1")
SMALL = {
    "alexnet": dict(num_classes=7, height=96, width=96),
    "simplecnn": dict(num_classes=5, height=48, width=48),
    "googlenet": dict(num_classes=4, height=64, width=64),
    "darknet19": dict(num_classes=4, height=64, width=64),
    "tinyyolo": dict(num_classes=3, height=64, width=64),
    "yolo2": dict(num_classes=3, height=64, width=64),
    "facenetnn4small2": dict(num_classes=5, height=64, width=64, embedding_size=32),
    "inceptionresnetv1": dict(num_classes=5, height=64, width=64, embedding_size=32),
}
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "zoo", "lenet_synthmnist.zip")
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "zoo",
                      "lenet_synthmnist_golden.npz")
SHA256 = "8d16369d4cc18397794baad462ed3689f1b60eaf7be7377fae1c1a143a0784c5"


# ------------------------------------------------------------------ helpers
def _tree_items(tree):
    """(key, layer dict) pairs of a graph's dict or a network's list."""
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _randomize(tnet, seed):
    """Seeded BN running statistics and affine params, and a YOLO head's
    last conv scaled by 0.1, on the port's model (in place)."""
    rng = np.random.default_rng(seed)
    params, state = interop.export_params(tnet), interop.export_state(tnet)
    for v, p in _tree_items(params):
        for k in sorted(p):
            if k == "gamma":
                p[k] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
            elif k == "beta":
                p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    for v, s in _tree_items(state):
        if "mean" in s:
            s["mean"] = (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
    layers = ([tnet.conf.vertices[n].layer for n in tnet.layer_names]
              if isinstance(tnet, TGraph) else tnet.layers)
    keys = tnet.layer_names if isinstance(tnet, TGraph) else range(len(layers))
    for i, (key, layer) in enumerate(zip(keys, layers)):
        if isinstance(layer, TL.Yolo2OutputLayer):
            prev = list(keys)[i - 1]
            params[prev]["W"] = params[prev]["W"] * np.float32(0.1)
    interop.load_jax_params(tnet, params, state)


def _jax_twin(tnet, jconf):
    """A JAX network over ``jconf`` holding the port model's params, state
    and updater state (no JAX init: its arrays are carried)."""
    jn = (JGraph if isinstance(tnet, TGraph) else JNet)(jconf)
    jn.params_ = jax.tree_util.tree_map(jnp.asarray, interop.export_params(tnet))
    jn.state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_state(tnet))
    jn.opt_state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_opt_state(tnet))
    jn.iteration = jn.epoch = 0
    return jn


def _pair(name, seed=0, **kw):
    kw = dict(SMALL[name], **kw)
    tnet = T.ZOO[name](**{k: (v if k != "updater" else v[1]) for k, v in kw.items()}
                       ).init(device="cpu")
    _randomize(tnet, seed)
    jconf = J.ZOO[name](**{k: (v if k != "updater" else v[0]) for k, v in kw.items()}).conf()
    return _jax_twin(tnet, jconf), tnet


def _images(name, b, seed):
    kw = SMALL[name]
    return np.random.default_rng(seed).standard_normal(
        (b, kw.get("height", 48), kw.get("width", 48), 3)).astype(np.float32)


def _labels(name, b, seed):
    rng = np.random.default_rng(seed)
    k = SMALL[name]["num_classes"]
    if name in ("tinyyolo", "yolo2"):
        g = SMALL[name]["height"] // 32
        lab = np.zeros((b, g, g, 4 + k), np.float32)
        for ex in range(b):
            cy, cx = rng.integers(0, g, 2)
            x1, y1 = cx + 0.5 * rng.random(), cy + 0.5 * rng.random()
            lab[ex, cy, cx, :4] = [x1, y1, x1 + 0.3 + rng.random(), y1 + 0.3 + rng.random()]
            lab[ex, cy, cx, 4 + rng.integers(0, k)] = 1.0
        return lab
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, b)]


def _out(net, x):
    if hasattr(net, "output_single"):
        return np.asarray(net.output_single(x))
    return np.asarray(net.output(x))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(net, tree):
    """((layer, name), array) in the model's layer order (a graph's
    topological order), names sorted."""
    keys = net.layer_names if isinstance(tree, dict) else range(len(tree))
    return [((k, n), np.asarray(tree[k][n], np.float64)) for k in keys for n in sorted(tree[k])]


# ----------------------------------------------------------------- registry
def test_all_13_reference_names_build():
    assert sorted(T.ZOO) == sorted(J.ZOO) and len(T.ZOO) == 13
    for name in T.ZOO:
        assert isinstance(T.ModelSelector.select(name.upper()), T.ZOO[name])
    assert T.ModelSelector.available() == sorted(J.ZOO)
    with pytest.raises(KeyError, match="Unknown zoo model"):
        T.ModelSelector.select("nope")
    assert T.PretrainedType.IMAGENET == J.PretrainedType.IMAGENET == "imagenet"
    assert not hasattr(T.selector, "ZooModelNotPortedError")
    assert T.AlexNet.serving_int8 and T.AlexNet.serving_int8 == J.AlexNet.serving_int8


FULL = [(n, {}) for n in NEW] + [("resnet50", {"stem_space_to_depth": True})]


def _param_count(conf, jax_side: bool) -> int:
    if hasattr(conf, "network_inputs"):
        lt = conf.layer_input_types()
        items = [(conf.vertices[n].layer, lt[n]) for n in lt]
    else:
        items = list(zip(conf.layers, conf.layer_types()))
    if jax_side:
        key = jax.random.PRNGKey(0)
        return sum(int(np.prod(a.shape)) for layer, t in items for a in
                   jax.tree_util.tree_leaves(jax.eval_shape(
                       lambda layer=layer, t=t: layer.init_params(key, t))))
    with torch.device("meta"):
        return sum(layer.n_params(t) for layer, t in items)


@pytest.mark.parametrize("name,kw", FULL, ids=[n + ("_s2d" if kw else "") for n, kw in FULL])
def test_full_width_conf_json_and_param_count_match_jax(name, kw):
    jc, tc = J.ZOO[name](**kw).conf(), T.ZOO[name](**kw).conf()
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert type(tc).from_json(jc.to_json()) == tc
    assert _param_count(tc, False) == _param_count(jc, True)


def test_resnet50_space_to_depth_stem_builds():
    conf = T.ResNet50(stem_space_to_depth=True, fused_pallas=True).conf()
    assert isinstance(conf.vertices["stem_s2d"].layer, TL.SpaceToDepthLayer)
    lt = conf.layer_input_types()
    assert (lt["stem_conv"].height, lt["stem_conv"].channels) == (112, 12)
    assert conf.vertices["stem_conv"].layer.kernel_size == [4, 4]
    assert lt["stem_pool"].height == 112 and lt["s0b0"].height == 56


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("name", NEW)
def test_forward_from_carried_params_matches_jax(name):
    jn, tn = _pair(name, seed=1)
    x = _images(name, 2, seed=2)
    want = _out(jn, x)
    got = _out(tn, x)
    assert got.shape == want.shape
    assert _rel(got, want) <= FWD_TOL


# ---------------------------------------------------------------- fit steps
FIT = {
    "yolo2": dict(b=4),
    "facenetnn4small2": dict(b=4),
    "darknet19": dict(b=4),
}


def _fit_one(jn, tn, x, y):
    jn.fit(JDataSet(x, y))
    tn.fit(ExistingDataSetIterator([TDataSet(x, y)]))


def _check_fit(jn, tn, p0, tol=FIT_TOL):
    """The step's score and new layer state within ``tol`` (relative to the
    largest value), the head's update within ``HEAD_TOL``, the whole update within
    ``UPDATE_TOL``: a ReLU (or leaky ReLU) whose pre-activation lies within
    the two packages' f32 rounding of 0 takes another branch in each, and
    moves its layer's gradient by that unit's whole share."""
    assert abs(tn.score() - float(jn.score_)) <= tol * abs(float(jn.score_))
    for (key, a), (_, b) in zip(_leaves(tn, interop.export_state(tn)),
                                _leaves(tn, jax.tree_util.tree_map(np.asarray, jn.state_))):
        assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1.0), key
    tp = _leaves(tn, interop.export_params(tn))
    jp = _leaves(tn, jax.tree_util.tree_map(np.asarray, jn.params_))
    p0 = _leaves(tn, p0)
    num = den = 0.0
    for (key, a), (_, b), (_, c) in zip(tp, jp, p0):
        num += float(np.sum(((a - c) - (b - c)) ** 2))
        den += float(np.sum((b - c) ** 2))
    assert den > 0 and np.sqrt(num / den) <= UPDATE_TOL
    # the head (the last layer with params): past every branch
    for (key, a), (_, b), (_, c) in zip(tp, jp, p0):
        if key[0] == tp[-1][0][0]:
            head_tol = max(HEAD_TOL, tol)
            assert np.max(np.abs(a - b)) <= head_tol * np.max(np.abs(b - c)) + 2 * np.spacing(
                np.float32(np.max(np.abs(c)))), key


@pytest.mark.parametrize("name", sorted(FIT))
def test_one_fit_step_matches_jax(name):
    upd = (jupd.Nesterovs(1e-3, 0.9), tupd.Nesterovs(1e-3, 0.9))
    jn, tn = _pair(name, seed=3, updater=upd)
    b = FIT[name]["b"]
    x, y = _images(name, b, 4), _labels(name, b, 5)
    p0 = interop.export_params(tn)
    _fit_one(jn, tn, x, y)
    _check_fit(jn, tn, p0)
    if name == "facenetnn4small2":
        centers = interop.export_state(tn)["output"]["centers"]
        assert np.abs(centers).max() > 0  # moved from zero on the first step
        np.testing.assert_allclose(centers, np.asarray(jn.state_["output"]["centers"]),
                                   rtol=0, atol=FIT_TOL * np.abs(centers).max())


def test_resnet50_space_to_depth_stem_forward_and_step_match_jax():
    kw = dict(num_classes=4, height=32, width=32, stem_space_to_depth=True)
    tn = T.ResNet50(updater=tupd.Nesterovs(1e-3, 0.9), **kw).init(device="cpu")
    _randomize(tn, 6)
    jn = _jax_twin(tn, J.ResNet50(updater=jupd.Nesterovs(1e-3, 0.9), **kw).conf())
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    assert _rel(tn.output_single(x), np.asarray(jn.output_single(x))) <= FWD_TOL
    p0 = interop.export_params(tn)
    _fit_one(jn, tn, x, y)
    _check_fit(jn, tn, p0, tol=RESNET_FIT_TOL)


def test_yolo_labels_pass_rank_4_through_score_batching_and_bundles():
    """YOLO2's (b, H, W, 4 + C) labels: ``score(ds)`` equals JAX's eval
    score; ``fit(DataSet)`` cut into batches equals a fit over the same
    batches; an emulated bundle of two steps (the card's stacked batch and
    static buffers, run eagerly) equals two eager steps bit for bit."""
    upd = (jupd.Nesterovs(1e-3, 0.9), tupd.Nesterovs(1e-3, 0.9))
    jn, tn = _pair("yolo2", seed=5, updater=upd)
    x, y = _images("yolo2", 4, 20), _labels("yolo2", 4, 21)
    assert y.ndim == 4
    want = float(jn.score(JDataSet(x, y)))
    assert abs(tn.score(TDataSet(x, y)) - want) <= FIT_TOL * abs(want)
    cut, listed, bundled = tn.clone(), tn.clone(), tn.clone()
    cut.fit(TDataSet(x, y), batch_size=2)
    listed.fit(ExistingDataSetIterator([TDataSet(x[:2], y[:2]), TDataSet(x[2:], y[2:])]))
    bundled.conf.global_conf.steps_per_call = 2
    bundled._bundle_step(2).emulate = True
    bundled.fit(ExistingDataSetIterator([TDataSet(x[:2], y[:2]), TDataSet(x[2:], y[2:])]))
    _assert_equal_nets(cut, listed)
    _assert_equal_nets(bundled, listed)


# ---------------------------------------------------- center loss, fit paths
def _facenet(k=1, policy=None, fault=None, remat=None):
    net = T.FaceNetNN4Small2(num_classes=5, height=32, width=32, embedding_size=16,
                             updater=tupd.Nesterovs(1e-3, 0.9)).init(device="cpu")
    g = net.conf.global_conf
    g.steps_per_call, g.fault_policy, g.remat_policy = k, fault, remat
    if k > 1:
        net._bundle_step(k).emulate = True
    return net


def _face_data(n, seed=8):
    rng = np.random.default_rng(seed)
    return [TDataSet(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                     np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]) for _ in range(n)]


def _assert_equal_nets(a, b):
    for x, y in ((a.params_, b.params_), (a.state_, b.state_), (a.opt_state_, b.opt_state_)):
        la, lb = pipeline.tree_leaves(x), pipeline.tree_leaves(y)
        assert len(la) == len(lb) and la
        for s, t in zip(la, lb):
            assert torch.equal(s, t)
    assert torch.equal(a.score_, b.score_) and a.iteration == b.iteration


def test_center_loss_equal_on_every_fit_path():
    data = _face_data(2)
    eager = _facenet()
    c0 = eager.state_["output"]["centers"].clone()
    eager.fit(ExistingDataSetIterator(data[:1]))
    assert not torch.equal(eager.state_["output"]["centers"], c0)  # moved on step 1
    eager.fit(ExistingDataSetIterator(data[1:]))
    for net in (_facenet(k=2), _facenet(fault=FaultPolicy()), _facenet(remat="nothing")):
        net.fit(ExistingDataSetIterator(data))
        _assert_equal_nets(net, eager)
    for sharded in (False, True):
        net = _facenet()
        ParallelWrapper.builder(net).workers(1).sharded_update(sharded).build().fit(
            ExistingDataSetIterator(data))
        _assert_equal_nets(net, eager)


def test_guard_skips_the_center_update_of_a_bad_step():
    data = _face_data(2, seed=9)
    net = _facenet(fault=FaultPolicy())
    with fault_injection([1]):
        net.fit(ExistingDataSetIterator(data))
    ref = _facenet(fault=FaultPolicy())
    ref.fit(ExistingDataSetIterator(data[:1]))
    assert torch.equal(net.state_["output"]["centers"], ref.state_["output"]["centers"])
    assert torch.equal(net.params_["output"]["W"], ref.params_["output"]["W"])


def test_score_reads_the_centers_before_the_update():
    net = _facenet()
    ds = _face_data(1, seed=10)[0]
    before = net.score(ds)
    centers = torch.from_numpy(np.random.default_rng(15).standard_normal(
        tuple(net.state_["output"]["centers"].shape)).astype(np.float32))
    net.state_["output"]["centers"] = centers.clone()
    assert net.score(ds) != before  # the eval score reads the centers
    _, want = net.compute_gradient_and_score(ds)  # train mode, nothing updated
    assert torch.equal(net.state_["output"]["centers"], centers)
    net.fit(ExistingDataSetIterator([ds]))
    # the step's score: the loss at the centers it started from
    assert float(net.score_) == pytest.approx(want, rel=1e-6)
    assert not torch.equal(net.state_["output"]["centers"], centers)


def _center_mln(pkg_layers, conf_mod, upd):
    return (conf_mod.NeuralNetConfiguration.builder().seed(3).updater(upd)
            .weight_init("xavier").list()
            .layer(pkg_layers.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg_layers.CenterLossOutputLayer(n_out=3, activation="softmax",
                                                    alpha=0.2, lambda_=0.1))
            .set_input_type(conf_mod.InputType.feed_forward(5)).build())


def test_center_loss_list_network_matches_jax_and_the_master_refuses_it():
    import deeplearning4j_tpu.nn.conf as jconf
    import deeplearning4j_tpu_torch.nn.conf as tconf
    from deeplearning4j_tpu.nn.conf import layers as jlayers

    tn = TNet(_center_mln(TL, tconf, tupd.Nesterovs(1e-2, 0.9))).init(device="cpu")
    jn = _jax_twin(tn, _center_mln(jlayers, jconf, jupd.Nesterovs(1e-2, 0.9)))
    rng = np.random.default_rng(12)
    for step in range(2):
        x = rng.standard_normal((6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        jn.fit(JDataSet(x, y))
        tn.fit(ExistingDataSetIterator([TDataSet(x, y)]))
        assert abs(tn.score() - float(jn.score_)) <= FIT_TOL * abs(float(jn.score_))
        assert _rel(tn.state_[-1]["centers"].numpy(), np.asarray(jn.state_[-1]["centers"])) \
            <= FIT_TOL
        for i in range(2):
            for k in ("W", "b"):
                assert _rel(tn.params_[i][k].numpy(), np.asarray(jn.params_[i][k])) <= FIT_TOL
    assert np.allclose(tn.score_examples(TDataSet(x, y), False),
                       np.asarray(jn.score_examples(JDataSet(x, y), False)), atol=1e-5)
    with pytest.raises(ValueError, match="layer state"):
        SharedTrainingMaster.builder(1e-3).build().fit(tn, ExistingDataSetIterator(
            [TDataSet(x, y)]))


def test_centers_travel_in_the_zip_both_ways(tmp_path):
    import deeplearning4j_tpu.nn.conf as jconf
    import deeplearning4j_tpu_torch.nn.conf as tconf
    from deeplearning4j_tpu.nn.conf import layers as jlayers

    net = TNet(_center_mln(TL, tconf, tupd.Nesterovs(1e-2, 0.9))).init(device="cpu")
    rng = np.random.default_rng(16)
    net.fit(ExistingDataSetIterator([TDataSet(
        rng.standard_normal((6, 5)).astype(np.float32),
        np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])]))
    assert net.state_[-1]["centers"].abs().max() > 0
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    jnet = JSerializer.restore_multi_layer_network(path)
    assert jnet.conf.to_dict() == _center_mln(jlayers, jconf, jupd.Nesterovs(
        1e-2, 0.9)).to_dict() | {"global_conf": jnet.conf.to_dict()["global_conf"]}
    np.testing.assert_array_equal(np.asarray(jnet.state_[-1]["centers"]),
                                  net.state_[-1]["centers"].numpy())
    jnet.state_[-1]["centers"] = jnet.state_[-1]["centers"] + 1.0
    back = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, back)
    tnet = ModelGuesser.load_model_guess(back, device="cpu")
    np.testing.assert_array_equal(tnet.state_[-1]["centers"].numpy(),
                                  np.asarray(jnet.state_[-1]["centers"]))
    for i in range(2):
        for k in ("W", "b"):
            assert torch.equal(tnet.params_[i][k], net.params_[i][k])


def test_class_means_over_ranks_are_the_global_batchs():
    """Inside a step that spans two ranks, the centers move toward the
    class means of both ranks' rows (the other rank's sums stand in for its
    collective)."""
    layer = TL.CenterLossOutputLayer(n_in=4, n_out=3, alpha=0.5)
    rng = np.random.default_rng(13)
    x0, x1 = (torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
              for _ in range(2))
    y0 = torch.eye(3)[[0, 0, 1, 1, 0]]
    y1 = torch.eye(3)[[2, 0, 2, 1, 1]]
    st = {"centers": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))}
    other = [y1.T @ x1, y1.sum(0)]
    with batch_stats.across_ranks(lambda ts: [t + o for t, o in zip(ts, other)], 2):
        got = layer.update_centers(st, x0, y0)["centers"]
    want = layer.update_centers(st, torch.cat([x0, x1]), torch.cat([y0, y1]))["centers"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- pretrained
def test_init_pretrained_reproduces_the_golden_output():
    net = T.LeNet(num_classes=10).init_pretrained(path=FIXTURE, checksum=SHA256, device="cpu")
    d = np.load(GOLDEN)
    np.testing.assert_allclose(net.output(d["x"]), d["y"], atol=1e-5, rtol=1e-4)
    assert T.LeNet.initPretrained is T.LeNet.init_pretrained


def test_init_pretrained_checksum_mismatch_and_missing_path():
    with pytest.raises(ValueError, match="Checksum mismatch"):
        T.LeNet(num_classes=10).init_pretrained(path=FIXTURE, checksum="0" * 64, device="cpu")
    assert os.path.exists(FIXTURE)  # a given file is never deleted
    with pytest.raises(FileNotFoundError, match="zoo"):
        T.LeNet(num_classes=10).init_pretrained(dataset="nope", device="cpu")


def test_pretrained_registries_are_per_class(monkeypatch):
    monkeypatch.setattr(T.LeNet, "pretrained_checksums", {"synthmnist": SHA256})
    net = T.LeNet(num_classes=10).init_pretrained(dataset="synthmnist", path=FIXTURE,
                                                  device="cpu")
    assert net.num_params() == 1256080
    try:
        T.LeNet.pretrained_urls["imagenet"] = "http://127.0.0.1:9/x"
        assert "imagenet" not in T.ResNet50.pretrained_urls
        assert "imagenet" not in tzoo.ZooModel.pretrained_urls
    finally:
        T.LeNet.pretrained_urls.pop("imagenet", None)
    assert T.LeNet().pretrained_url("imagenet") is None


@pytest.fixture()
def weight_server():
    """A local HTTP server of the fixture's bytes, honouring Range."""
    data = open(FIXTURE, "rb").read()
    hits = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            rng = self.headers.get("Range")
            hits.append(rng)
            if self.path.endswith("416") and rng:
                self.send_error(416)
                return
            if rng and rng.startswith("bytes="):
                start = int(rng.split("=")[1].split("-")[0])
                body = data[start:]
                self.send_response(206)
                self.send_header("Content-Range", f"bytes {start}-{len(data) - 1}/{len(data)}")
            else:
                body = data
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/lenet", hits
    srv.shutdown()


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(tzoo, "CACHE_DIR", str(tmp_path))
    return tmp_path


def test_download_resumes_verifies_and_caches(weight_server, tmp_cache, monkeypatch):
    url, hits = weight_server
    monkeypatch.setattr(T.LeNet, "pretrained_urls", {"synthmnist": url})
    monkeypatch.setattr(T.LeNet, "pretrained_checksums", {"synthmnist": SHA256})
    model = T.LeNet(num_classes=10)
    dest = model.pretrained_path("synthmnist")
    assert dest.startswith(str(tmp_cache))
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    with open(dest + ".part", "wb") as f:
        f.write(open(FIXTURE, "rb").read()[:1000])  # an interrupted pull
    net = model.init_pretrained(dataset="synthmnist", device="cpu")
    assert hits == ["bytes=1000-"] and not os.path.exists(dest + ".part")
    assert net.num_params() == 1256080
    # the second call reads the cache (the URL no longer answers)
    monkeypatch.setattr(T.LeNet, "pretrained_urls", {"synthmnist": "http://127.0.0.1:9/x"})
    assert model.init_pretrained(dataset="synthmnist", device="cpu").num_params() == 1256080


def test_bad_download_is_deleted_and_a_staged_file_kept(weight_server, tmp_cache,
                                                        monkeypatch):
    url, _ = weight_server
    monkeypatch.setattr(T.LeNet, "pretrained_urls", {"synthmnist": url})
    monkeypatch.setattr(T.LeNet, "pretrained_checksums", {"synthmnist": "0" * 64})
    model = T.LeNet(num_classes=10)
    with pytest.raises(ValueError, match="deleted; retry will re-download"):
        model.init_pretrained(dataset="synthmnist", device="cpu")
    dest = model.pretrained_path("synthmnist")
    assert not os.path.exists(dest)
    shutil.copy(FIXTURE, dest)  # staged by hand
    with pytest.raises(ValueError, match="Checksum mismatch"):
        model.init_pretrained(dataset="synthmnist", device="cpu")
    assert os.path.exists(dest)


def test_complete_part_promotes_on_416_and_a_dead_host_names_the_staging_path(
        weight_server, tmp_cache, monkeypatch):
    url, _ = weight_server
    monkeypatch.setattr(T.LeNet, "pretrained_urls", {"synthmnist": url + "/416"})
    monkeypatch.setattr(T.LeNet, "pretrained_checksums", {"synthmnist": SHA256})
    model = T.LeNet(num_classes=10)
    dest = model.pretrained_path("synthmnist")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    shutil.copy(FIXTURE, dest + ".part")
    assert model.init_pretrained(dataset="synthmnist", device="cpu").num_params() == 1256080
    assert not os.path.exists(dest + ".part")
    monkeypatch.setattr(T.LeNet, "pretrained_urls", {"other": "http://127.0.0.1:9/x"})
    with pytest.raises(ConnectionError, match="stage the artifact"):
        model.init_pretrained(dataset="other", device="cpu")
    with pytest.raises(FileNotFoundError):  # an explicit path never downloads
        model.init_pretrained(dataset="other", path=str(tmp_cache / "none.zip"), device="cpu")


# ------------------------------------------------------------------- labels
def test_labels_decode_like_jax(tmp_path, monkeypatch):
    voc, jvoc = T.VOCLabels(), J.VOCLabels()
    probs = np.random.default_rng(14).random((3, 20)).astype(np.float32)
    for a, b in zip(voc.decode_predictions(probs, n=3), jvoc.decode_predictions(probs, n=3)):
        assert [(p.number, p.label, p.probability) for p in a] == \
            [(p.number, p.label, p.probability) for p in b]
    assert voc.get_label(14) == "person" and T.COCOLabels().num_classes() == 80
    assert [T.COCOLabels().get_label(i) for i in range(80)] == \
        [J.COCOLabels().get_label(i) for i in range(80)]
    assert repr(voc.decode_predictions(probs[0], n=1)[0][0]).startswith("ClassPrediction(")
    monkeypatch.setattr(tzoo, "CACHE_DIR", str(tmp_path))
    assert T.ImageNetLabels().get_label(3) == "class_0003"
    os.makedirs(tmp_path / "labels")
    (tmp_path / "labels" / "darknet_labels.txt").write_text(
        "\n".join(f"thing {i}" for i in range(1000)) + "\n")
    assert T.DarknetLabels().get_label(999) == "thing 999"
    (tmp_path / "labels" / "imagenet_labels.txt").write_text("a\nb\n")
    with pytest.raises(ValueError, match="expected 1000"):
        T.ImageNetLabels()
    with pytest.raises(ValueError, match="classes"):
        voc.decode_predictions(np.zeros((1, 5)))
