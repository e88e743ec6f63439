"""Bundled train steps (``steps_per_call > 1``, the port's
``train/pipeline.py``) against single steps and against the JAX package's
bundled ``fit``, on the CPU.

- On the CPU a bundle of k is k eager steps in order, so it is held bit for
  bit to k single steps: params, updater slots, layer state, ``iteration``
  and the per-step scores. Each such case also runs the card's path with
  the CUDA graph left out (``BundledStep.emulate``): the static buffers, the
  scalar feed that hands the steps Adam's ``alpha`` from a buffer the host
  fills, the copy-in of state a single step changed and the write-back,
  run eagerly; it is held bit for bit too.
- Against the JAX package's bundled fit (the reference legs of
  ``tests/test_pipeline.py`` that pass), from params carried across:
  FIT_TOL (1e-5, absolute), the tolerance of
  ``tests/test_torch_multilayer_train.py``: both compute the same f32
  operations, only the order of the sums differs.
"""

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
from deeplearning4j_tpu.data.iterators import iter_bundled as jiter_bundled
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import BatchBundle, iter_bundled
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.train import pipeline

FIT_TOL = 1e-5

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def batches(n, b=8, d=12, c=3, seed=0):
    """``tests/test_pipeline.py``'s ``_batches``: (features, labels) arrays."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, d)).astype(np.float32),
             np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]) for _ in range(n)]


def mlp(pkg, k, d=12):
    """``tests/test_pipeline.py``'s ``_mlp``: Adam(1e-3), dense 16 relu,
    softmax 3."""
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(7).updater(upd.Adam(1e-3))
            .steps_per_call(k).list()
            .layer(layers.DenseLayer(n_out=16, activation="relu"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.feed_forward(d)).build())


def graph(pkg, k):
    """``tests/test_pipeline.py::test_computation_graph_bundled_parity``'s
    graph: dense 8 tanh, softmax 3, Adam(1e-3)."""
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(5).updater(upd.Adam(1e-3))
            .steps_per_call(k).graph_builder().add_inputs("in")
            .add_layer("d0", layers.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", layers.OutputLayer(n_out=3, activation="softmax",
                                                 loss="mcxent"), "d0")
            .set_outputs("out").set_input_types(conf.InputType.feed_forward(4)).build())


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(net, jnet):
    """``net`` holding ``jnet``'s params, state and updater slots."""
    interop.load_jax_params(net, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return net


def emulated(net, k):
    """``net`` whose bundles run the card's path without the graph."""
    net._bundle_step(k).emulate = True
    return net


def fit_recording(net, data, epochs, monkeypatch):
    """Fit ``net`` on ``data`` (a list of (x, y)); returns (every step's
    score in order, as one f32 tensor, and the BundleScores of each
    bundle)."""
    scores, bundles = [], []
    single = net._fit_batch

    def one(ds):
        single(ds)
        scores.append(net.score_.reshape(1))

    net._fit_batch = one
    bundled = pipeline.BundledStep.__call__

    def call(self, stacked):
        out = bundled(self, stacked)
        scores.append(out.dev)
        bundles.append(out)
        return out

    monkeypatch.setattr(pipeline.BundledStep, "__call__", call)
    net.fit(TExisting([TDataSet(x, y) for x, y in data]), epochs=epochs)
    return torch.cat(scores), bundles


def assert_same(a, b):
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    np.testing.assert_array_equal(a.opt_state_flat(), b.opt_state_flat())
    la, lb = pipeline.tree_leaves(a.state_), pipeline.tree_leaves(b.state_)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a.iteration == b.iteration and a.epoch == b.epoch


# ------------------------------------------------------------ bundle == singles
@pytest.mark.parametrize("emulate", [False, True])
def test_k4_bundles_equal_single_steps_incl_ragged_tail(emulate, monkeypatch):
    """10 batches at k = 4, 2 epochs: two bundles and two ragged single
    steps an epoch; params, Adam m/v, iteration and every step's score
    equal k = 1's bit for bit; each bundle's scores reach the host once."""
    data = batches(10)
    a, b = TNet(mlp(PORT, 1)).init(device="cpu"), TNet(mlp(PORT, 4)).init(device="cpu")
    if emulate:
        emulated(b, 4)
    sa, _ = fit_recording(a, data, 2, monkeypatch)
    sb, bundles = fit_recording(b, data, 2, monkeypatch)
    assert a.iteration == b.iteration == 20
    assert_same(a, b)
    assert torch.equal(sa, sb) and sa.shape == (20,)
    assert [len(s) for s in bundles] == [4, 4, 4, 4]
    before = pipeline._host_fetches
    for s in bundles:
        s.host()
        s.host()
    assert pipeline._host_fetches - before == 4 and all(s.fetch_count == 1 for s in bundles)
    assert b.bundle_scores_ is bundles[-1]
    assert torch.equal(b.score_, sb[-1])  # the ragged tail's single step


def test_k4_bundled_fit_tracks_jax():
    """The port's bundled fit against ``test_pipeline.py::TestBundledParity::
    test_k4_bit_exact_incl_ragged_tail``'s (JAX at k = 4), from carried
    params: params, slots and the last score within FIT_TOL."""
    data = batches(10)
    jnet = JNet(mlp(JAX, 4)).init()
    tnet = carried(TNet(mlp(PORT, 4)).init(device="cpu"), jnet)
    jnet.fit(JExisting([JDataSet(x, y) for x, y in data]), epochs=2)
    tnet.fit(TExisting([TDataSet(x, y) for x, y in data]), epochs=2)
    assert tnet.iteration == jnet.iteration == 20
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)
    assert abs(tnet.score() - float(jnet.score())) <= FIT_TOL


@pytest.mark.parametrize("emulate", [False, True])
def test_computation_graph_bundles_equal_singles_and_track_jax(emulate):
    """A graph at k = 2, 40 rows in batches of 8, 2 epochs (two bundles and
    a ragged single an epoch): bit-equal to k = 1, and within FIT_TOL of
    ``test_pipeline.py::test_computation_graph_bundled_parity``'s JAX fit
    at k = 2 from carried params."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
    jg = JGraph(graph(JAX, 2)).init()
    a = carried(TGraph(graph(PORT, 1)).init(device="cpu"), jg)
    b = carried(TGraph(graph(PORT, 2)).init(device="cpu"), jg)
    if emulate:
        emulated(b, 2)
    a.fit(TDataSet(x, y), epochs=2, batch_size=8)
    b.fit(TDataSet(x, y), epochs=2, batch_size=8)
    jg.fit(JDataSet(x, y), epochs=2, batch_size=8)
    assert a.iteration == b.iteration == jg.iteration == 10
    assert_same(a, b)
    assert torch.equal(a.score_, b.score_)
    np.testing.assert_allclose(b.params_flat(), np.asarray(jg.params_flat()), rtol=0,
                               atol=FIT_TOL)


@pytest.mark.parametrize("emulate", [False, True])
@pytest.mark.parametrize("sharded", [False, True])
def test_one_rank_wrapper_bundles_equal_single_steps(sharded, emulate):
    """``ParallelWrapper`` on one rank in this process (a gloo group), k = 2
    over 5 batches and 2 epochs, replicated and ZeRO-1: the bundled step
    (for ZeRO-1 ``make_sharded_train_step``'s bundled variant) gives k =
    1's params, slots and scores bit for bit; the updater state is back in
    the per-layer layout after the fit."""
    data = [TDataSet(x, y) for x, y in batches(5)]
    a, b = TNet(mlp(PORT, 1)).init(device="cpu"), TNet(mlp(PORT, 2)).init(device="cpu")
    ParallelWrapper.builder(a).workers(1).sharded_update(sharded).build().fit(
        TExisting(data), epochs=2)
    pw = ParallelWrapper.builder(b).workers(1).sharded_update(sharded).build()
    if emulate:
        step = pw._bundle_step(2)
        (step._runner if sharded else step).emulate = True
    pw.fit(TExisting(data), epochs=2)
    assert type(pw._bstep).__name__ == ("BundledShardedStep" if sharded else "BundledStep")
    assert_same(a, b)
    assert torch.equal(a.score_, b.score_) and len(b.bundle_scores_) == 2
    assert getattr(b, "_opt_state_sync", None) is None
    assert [len(o) for o in b.opt_state_] == [len(p) for p in b.params_]


# ----------------------------------------------------------------- grouping
def test_shape_change_flushes_to_singles(monkeypatch):
    """``test_pipeline.py::test_shape_change_flushes_to_singles``: 3 batches
    of 8 then 3 of 16 at k = 2 give a bundle, a single, a bundle, a single,
    as JAX's ``iter_bundled`` gives them; a fit over that stream equals k =
    1's bit for bit."""
    small = batches(3, b=8)
    big = batches(3, b=16, seed=1)
    mine = list(iter_bundled(iter([TDataSet(x, y) for x, y in small + big]), 2))
    theirs = list(jiter_bundled(iter([JDataSet(x, y) for x, y in small + big]), 2))
    kinds = [type(i).__name__ for i in mine]
    assert kinds == ["BatchBundle", "DataSet", "BatchBundle", "DataSet"]
    assert kinds == [type(i).__name__ for i in theirs]
    assert mine[0].features.shape == (2, 8, 12) and mine[2].features.shape == (2, 16, 12)
    np.testing.assert_array_equal(mine[2].labels, np.asarray(theirs[2].labels))
    a, b = TNet(mlp(PORT, 1)).init(device="cpu"), TNet(mlp(PORT, 2)).init(device="cpu")
    sa, _ = fit_recording(a, small + big, 1, monkeypatch)
    sb, bundles = fit_recording(b, small + big, 1, monkeypatch)
    assert len(bundles) == 2 and torch.equal(sa, sb)
    assert_same(a, b)


def test_batch_bundle_unstack_round_trips():
    """Stacking and unstacking give back each batch's arrays, masks
    included (``test_pipeline.py::test_bundle_unstack_roundtrip``)."""
    rng = np.random.default_rng(4)
    data = [TDataSet(x, y, None, (rng.random((8, 1)) > 0.5).astype(np.float32))
            for x, y in batches(3)]
    bundle = BatchBundle.stack(data)
    assert bundle.k == 3 and bundle.features.shape == (3, 8, 12)
    assert bundle.features_mask is None and bundle.labels_mask.shape == (3, 8, 1)
    back = bundle.unstack()
    assert len(back) == 3
    for orig, got in zip(data, back):
        for key in ("features", "labels", "labels_mask"):
            np.testing.assert_array_equal(getattr(orig, key), getattr(got, key))
        assert got.features_mask is None
    assert BatchBundle.compat_key(back[0]) == BatchBundle.compat_key(data[0])


# ----------------------------------------------------- legality, conf, feed
def test_tbptt_refuses_bundles():
    """A tBPTT configuration at k > 1 raises ValueError before anything
    trains, in both packages (``test_pipeline.py::test_tbptt_rejects_bundling``)."""
    def conf(pkg):
        c, layers, upd = pkg
        return (c.NeuralNetConfiguration.builder().seed(1).updater(upd.Adam(1e-3))
                .steps_per_call(4).list()
                .layer(layers.LSTM(n_out=6))
                .layer(layers.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .backprop_type("tbptt", fwd_length=4, back_length=4)
                .set_input_type(c.InputType.recurrent(3, 8)).build())

    rng = np.random.default_rng(0)
    f = rng.standard_normal((4, 8, 3)).astype(np.float32)
    lab = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 8))]
    tnet = TNet(conf(PORT)).init(device="cpu")
    with pytest.raises(ValueError, match="tBPTT"):
        tnet.fit(TDataSet(f, lab))
    assert tnet.iteration == 0
    with pytest.raises(ValueError, match="tBPTT"):
        JNet(conf(JAX)).init().fit(JDataSet(f, lab))
    assert pipeline.resolve_steps_per_call(tnet, requested=1) == 1


def test_listener_hooks_would_force_single_steps():
    """The reference's rule: a listener with a per-step host hook (or that
    snapshots the model each step) forces k = 1; without one k is the
    configuration's, and a bundle's scores reach the listeners."""
    class Backward:
        def on_backward_pass(self, model):
            pass

    class Snapshots:
        requires_per_step_state = True

    assert pipeline.bundling_blockers([Backward(), Snapshots(), object()]) == [
        "Backward.on_backward_pass", "Snapshots.requires_per_step_state"]
    net = TNet(mlp(PORT, 4)).init(device="cpu")
    assert pipeline.resolve_steps_per_call(net) == 4
    net.listeners = [Backward()]
    assert pipeline.resolve_steps_per_call(net) == 1

    class Legacy:
        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration, epoch):
            self.seen.append((iteration, float(model.score_)))

    net.listeners = [Legacy()]
    pipeline.dispatch_bundle_listeners(net, 4, 0, pipeline.BundleScores(
        torch.tensor([1.0, 2.0])))
    assert net.listeners[0].seen == [(5, 1.0), (6, 2.0)] and float(net.score_) == 2.0


def test_conf_round_trips_through_json():
    """``steps_per_call(8)`` survives the port's JSON, and the JSON of
    either package reads in the other (``test_pipeline.py::test_conf_serde_roundtrip``)."""
    mine, theirs = mlp(PORT, 8), mlp(JAX, 8)
    assert mine.global_conf.steps_per_call == 8
    assert TConf.from_json(mine.to_json()).global_conf.steps_per_call == 8
    assert TConf.from_json(theirs.to_json()).global_conf.steps_per_call == 8
    back = type(theirs).from_json(mine.to_json())
    assert back.global_conf.steps_per_call == 8
    g = graph(PORT, 3)
    assert type(g).from_json(g.to_json()).global_conf.steps_per_call == 3


@pytest.mark.parametrize("t", [1, 2, 1000])
def test_alpha_buffer_gives_adam_apply_bits(t):
    """The scalar feed of a captured bundle: the warm-up records Adam's
    ``alpha`` (one slot; a fixed schedule's scalars stay on the host); the
    host fills the (k, slots) buffer by ``Adam.alpha``'s pipeline, the bits
    of each step's ``alpha``; ``Adam.apply`` and the fused update reading
    the buffer give the eager step's bits."""
    upd, nest = tupd.Adam(1e-3), tupd.Nesterovs(1e-3, 0.9)
    g = torch.Generator().manual_seed(t)
    p, grad, m = (torch.randn(257, generator=g) for _ in range(3))
    v = torch.rand(257, generator=g) * 1e-3
    slots = {"m": m * 0.1, "v": v}
    feed = pipeline._ScalarFeed()
    with tupd.scalar_feed(feed):
        feed.begin(0, t - 1)
        eager = upd.apply(grad, slots, t, t - 1, 0)
        nest.apply(grad, {"v": m}, t, t - 1, 0)
    assert [(s[1], s[2], s[3]) for s in feed.specs] == [("alpha", 1, 0)]
    feed.buf = feed.host_values(t - 1, 0, 3)
    for j in range(3):
        assert torch.equal(feed.buf[j, 0], upd.alpha(t + j, t - 1 + j, 0))
    with tupd.scalar_feed(feed):
        feed.begin(0, t - 1)
        fed = upd.apply(grad, slots, t, t - 1, 0)
        fused = fu.fused_adam_apply(p, grad, slots["m"], slots["v"],
                                    upd.step_scalar("alpha", t, t - 1, 0),
                                    b1=0.9, b2=0.999, eps=1e-8)
    assert torch.equal(fed[0], eager[0])
    assert all(torch.equal(fed[1][s], eager[1][s]) for s in ("m", "v"))
    want = fu.fused_adam_plain(p, grad, slots["m"], slots["v"], upd.alpha(t, t - 1, 0),
                               b1=0.9, b2=0.999, eps=1e-8)
    assert all(torch.equal(a, b) for a, b in zip(fused, want))


@pytest.mark.parametrize("kind", ["list", "graph"])
def test_params_taken_between_fits_keep_their_values(kind):
    """Tensors a caller takes from ``params_``, ``opt_state_`` and ``state_``
    after a bundled fit are not the bundled step's static buffers, and keep
    their values through a later fit (the card's path, run eagerly here)."""
    if kind == "list":
        net = emulated(TNet(mlp(PORT, 2)).init(device="cpu"), 2)
        data = TExisting([TDataSet(x, y) for x, y in batches(4)])
    else:
        net = emulated(TGraph(graph(PORT, 2)).init(device="cpu"), 2)
        data = TExisting([TDataSet(x, y) for x, y in batches(4, d=4)])
    net.fit(data)
    held = pipeline.tree_leaves((net.params_, net.opt_state_, net.state_))
    values = [t.clone() for t in held]
    static = {id(t) for t in pipeline.tree_leaves(net._bundled._static)}
    assert held and not any(id(t) in static for t in held)
    net.fit(data)
    assert net.iteration == 8
    assert all(torch.equal(a, b) for a, b in zip(held, values))
    assert not all(torch.equal(a, b) for a, b in zip(pipeline.tree_leaves(net.params_), values))


@pytest.mark.parametrize("emulate", [False, True])
def test_changes_between_fits_reach_the_next_bundle(emulate):
    """Params and updater state set from outside between two fits
    (``set_params_flat``, ``set_opt_state_flat``, as a restored checkpoint
    or the wrapper's gather do) are what the next bundle starts from: the
    card's path copies them into its static buffers."""
    data = TExisting([TDataSet(x, y) for x, y in batches(4)])
    a, b = TNet(mlp(PORT, 1)).init(device="cpu"), TNet(mlp(PORT, 2)).init(device="cpu")
    if emulate:
        emulated(b, 2)
    for net in (a, b):
        net.fit(data)
    rng = np.random.default_rng(8)
    params = rng.standard_normal(a.params_flat().shape).astype(np.float32) * 0.1
    slots = np.abs(rng.standard_normal(a.opt_state_flat().shape)).astype(np.float32) * 1e-3
    for net in (a, b):
        net.set_params_flat(params)
        net.set_opt_state_flat(slots)
        net.fit(data)
    assert_same(a, b)
    assert a.iteration == 8


# ------------------------------------------------------------------ dropout
def noisy_mlp(k, policy=None):
    """``mlp`` with every kind of noise: AlphaDropout and DropConnect on the
    hidden layer, plain dropout on the output layer's input and weight
    noise on its params, a max-norm constraint on both ``W``."""
    from deeplearning4j_tpu_torch.regularization import MaxNormConstraint

    b = (tconf.NeuralNetConfiguration.builder().seed(7).updater(tupd.Adam(1e-3))
         .steps_per_call(k))
    if policy is not None:
        b = b.fault_policy(policy)
    return (b.list()
            .layer(tlayers.DenseLayer(n_out=16, activation="relu",
                                      dropout=tlayers.AlphaDropout(0.2),
                                      weight_noise=tlayers.DropConnect(0.9),
                                      constraints=[MaxNormConstraint(0.8)]))
            .layer(tlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                       dropout=0.3, weight_noise=tlayers.WeightNoise(0.02),
                                       constraints=[MaxNormConstraint(0.8)]))
            .set_input_type(tconf.InputType.feed_forward(12)).build())


def noisy_graph(k):
    conf = graph(PORT, k)
    conf.vertices["d0"].layer.dropout = tlayers.GaussianDropout(0.3)
    conf.vertices["out"].layer.dropout = 0.25
    conf.vertices["out"].layer.weight_noise = tlayers.DropConnect(0.8)
    return conf


@pytest.mark.parametrize("emulate", [False, True])
@pytest.mark.parametrize("kind", ["mln", "graph", "guarded", "wrapper", "wrapper-zero1"])
def test_dropout_bundles_equal_single_steps(kind, emulate):
    """With dropout, weight noise and constraints, k bundled steps equal k
    eager steps bit for bit (params, slots, scores), eager and on the card's
    path run without the graph (``emulate``: the step's draw position comes
    from the bundle's iteration buffer, a device scalar); each step draws
    fresh masks (the scores of one repeated batch differ)."""
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy

    k = 2 if kind.startswith("graph") else 4
    if kind == "graph":
        rng = np.random.default_rng(3)
        x = rng.standard_normal((8, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        data = [TDataSet(x, y)] * 5
        a, b = TGraph(noisy_graph(1)).init(device="cpu"), TGraph(noisy_graph(k)).init(device="cpu")
    else:
        x, y = batches(1)[0]
        data = [TDataSet(x, y)] * 9
        policy = FaultPolicy() if kind == "guarded" else None
        a = TNet(noisy_mlp(1, policy)).init(device="cpu")
        b = TNet(noisy_mlp(k, policy)).init(device="cpu")
    if kind.startswith("wrapper"):
        sharded = kind == "wrapper-zero1"
        ParallelWrapper.builder(a).workers(1).sharded_update(sharded).build().fit(
            TExisting(data))
        pw = ParallelWrapper.builder(b).workers(1).sharded_update(sharded).build()
        if emulate:
            step = pw._bundle_step(k)
            (step._runner if sharded else step).emulate = True
        pw.fit(TExisting(data))
        seen = [float(s) for s in b.bundle_scores_.host()]
    else:
        if emulate:
            emulated(b, k)
        scores = []
        for ds in data:
            a.fit(TExisting([ds]))
            scores.append(float(a.score_))
        b.fit(TExisting(data))
        seen = scores
        a.epoch = b.epoch  # a fit a batch above: one epoch each
        bundle = b.bundle_scores_.host()
        assert [float(s) for s in bundle] == scores[len(data) // k * k - k:len(data) // k * k]
    assert_same(a, b)
    assert torch.equal(a.score_, b.score_)
    assert len(set(seen)) > 1  # one batch, fresh masks each step
