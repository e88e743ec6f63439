"""The networks' other public methods in the port against the JAX package,
on the CPU, from params carried across (``interop``).

- ``MultiLayerNetwork``: the evaluate family (``evaluate`` with ``top_n``,
  ``evaluate_roc``, ``evaluate_roc_multi_class``, ``evaluate_regression``,
  ``f1_score``) over a DataSet and an iterator (reset afterwards),
  ``predict``, ``feed_forward`` in eval and in train (BN batch statistics,
  no dropout), ``score_examples`` with and without the regularization
  terms, ``layer_size`` of every layer kind, ``summary``,
  ``to_computation_graph`` (its output and one fit step after it).
- ``ComputationGraph``: ``feed_forward``, ``summary``, the evaluate
  family, ``rnn_time_step`` over a graph with a GravesLSTM in calls of 1, 4
  and 1 steps, then ``rnn_clear_previous_state``.
- Both: ``set_learning_rate`` (the updater's JSON and the next step as
  JAX's), and ``train_step_fn``'s pure step ``torch.equal`` to one ``fit``
  step, unguarded and guarded.
- The stale-bundle repair: after two bundled fits, ``set_learning_rate``
  drops the cached bundle, and the third bundled fit (the card's path,
  emulated) equals eager steps at the new rate bit for bit.

Tolerance: 1e-5 (f32) absolute on activations, losses and params, the
port's train tests' (``test_torch_multilayer_train.py``); evaluation
figures within 1e-5 where they come from those outputs, counts exactly
(the seeded outputs are far from any argmax tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lstm as tl
import test_torch_multilayer_train as mlt
import test_torch_train as tt
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.data import ListDataSetIterator as TList
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import _as_multi
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train import pipeline
from deeplearning4j_tpu_torch.train.faults import FaultPolicy

TOL = 1e-5


def conv_bn_pair():
    """``test_torch_multilayer_train.py``'s conv-BN network (conv, BN, pool,
    conv, pool, dense, softmax; l2 1e-4), its BN state seeded, in both
    packages with the same params."""
    jnet, tnet = mlt.pair("conv_bn")
    rng = np.random.default_rng(2)
    state = mlt.numpy_tree(jnet.state_)
    state[1] = {"mean": (rng.standard_normal(4) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    jnet.state_ = jax.tree_util.tree_map(jnp.asarray, state)
    interop.load_jax_params(tnet, mlt.numpy_tree(jnet.params_), state,
                            opt_state=mlt.numpy_tree(jnet.opt_state_))
    return jnet, tnet


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
                               atol=TOL, err_msg=what)


# ------------------------------------------------------------ evaluation
@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_mln_evaluate_family_matches_jax(source):
    jnet, tnet = conv_bn_pair()
    x, y = mlt.data("conv_bn", 40, seed=6)

    def it(pkg):
        if source == "dataset":
            return (TDataSet if pkg == "t" else JDataSet)(x, y)
        return (TList(TDataSet(x, y), 16) if pkg == "t" else JList(JDataSet(x, y), 16))

    t_ev, j_ev = tnet.evaluate(it("t"), top_n=2), jnet.evaluate(it("j"), top_n=2)
    np.testing.assert_array_equal(t_ev.confusion.matrix, j_ev.confusion.matrix)
    assert t_ev.stats() == j_ev.stats()
    close(t_ev.top_n_accuracy(), j_ev.top_n_accuracy())
    assert tnet.f1_score(it("t")) == jnet.f1_score(it("j"))
    roc_t, roc_j = (tnet.evaluate_roc_multi_class(it("t")),
                    jnet.evaluate_roc_multi_class(it("j")))
    for c in range(5):
        close(roc_t.calculate_auc(c), roc_j.calculate_auc(c), f"auc {c}")
    for steps in (0, 20):
        r_t, r_j = tnet.evaluate_roc(it("t"), steps), jnet.evaluate_roc(it("j"), steps)
        close(r_t.calculate_auc(), r_j.calculate_auc())
    reg_t, reg_j = tnet.evaluate_regression(it("t")), jnet.evaluate_regression(it("j"))
    for c in range(5):
        close(reg_t.mean_squared_error(c), reg_j.mean_squared_error(c))
        close(reg_t.r_squared(c), reg_j.r_squared(c))
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    np.testing.assert_array_equal(tnet.predict(x), tnet.output(x).argmax(-1))
    if source == "iterator":  # reset afterwards: a second pass sees every batch
        t_it = it("t")
        tnet.evaluate(t_it)
        assert tnet.evaluate(t_it).confusion.matrix.sum() == 40


def test_graph_evaluate_family_matches_jax(narrow_pair):
    jg, tg, x, y = narrow_pair
    t_ev, j_ev = tg.evaluate(TDataSet(x, y), top_n=3), jg.evaluate(JDataSet(x, y), top_n=3)
    np.testing.assert_array_equal(t_ev.confusion.matrix, j_ev.confusion.matrix)
    assert t_ev.stats() == j_ev.stats()
    r_t, r_j = (tg.evaluate_roc_multi_class(TDataSet(x, y)),
                jg.evaluate_roc_multi_class(JDataSet(x, y)))
    close(r_t.calculate_average_auc(), r_j.calculate_average_auc())
    close(tg.evaluate_regression(TDataSet(x, y)).average_mean_squared_error(),
          jg.evaluate_regression(JDataSet(x, y)).average_mean_squared_error())
    # one-hot labels and softmax outputs flatten into one binary ROC
    close(tg.evaluate_roc(TDataSet(x, y)).calculate_auc(),
          jg.evaluate_roc(JDataSet(x, y)).calculate_auc())


# --------------------------------------------------------- introspection
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mln_feed_forward_matches_jax(train):
    """Every layer's activation; in train mode BN takes the batch's
    statistics (no dropout in this network), and the model is unchanged."""
    jnet, tnet = conv_bn_pair()
    x, _ = mlt.data("conv_bn", 6, seed=3)
    before = [dict(s) for s in tnet.state_]
    t_acts, j_acts = tnet.feed_forward(x, train=train), jnet.feed_forward(x, train=train)
    assert len(t_acts) == len(j_acts) == len(tnet.layers)
    for i, (a, b) in enumerate(zip(t_acts, j_acts)):
        assert a.shape == b.shape
        close(a, b, f"layer {i}")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(tnet.state_, before) for k in a)
    if not train:
        np.testing.assert_array_equal(t_acts[-1], tnet.output(x))


def test_feed_forward_in_train_draws_a_stream_of_its_own():
    """With dropout, train-mode feed_forward draws other masks than the
    next fit step (its own stream) and other masks call by call."""
    c = mlt.conv_bn(mlt.PORT)
    c.layers[5].dropout = 0.5
    net = TNet(c).init(device="cpu")
    x, y = mlt.data("conv_bn", 6, seed=3)
    a, b = net.feed_forward(x, train=True), net.feed_forward(x, train=True)
    assert not np.array_equal(a[5], b[5])
    batch = net._batch(TDataSet(x, y))
    step_input = net._walk(net.params_, net.state_, batch[0], train=True, stop_before=None,
                           cast_params=True, fmask=None, carries=None, noise=net.step_noise(),
                           collect=True)[4][5]
    assert not np.array_equal(step_input.detach().numpy(), a[5])
    np.testing.assert_array_equal(net.feed_forward(x)[5], net.feed_forward(x)[5])


@pytest.mark.parametrize("reg", [True, False], ids=["with_reg", "without_reg"])
def test_score_examples_matches_jax(reg):
    jnet, tnet = conv_bn_pair()
    x, y = mlt.data("conv_bn", 9, seed=4)
    t_s = tnet.score_examples(TDataSet(x, y), add_regularization_terms=reg)
    j_s = jnet.score_examples(JDataSet(x, y), add_regularization_terms=reg)
    assert t_s.shape == j_s.shape == (9,)
    close(t_s, j_s)
    if not reg:
        close(t_s.mean() + float(tnet._reg_score(tnet.params_)), tnet.score(TDataSet(x, y)))


LAYER_SIZE_NETS = {
    "conv_bn": lambda: mlt.pair("conv_bn"),
    "lstm": lambda: tl._pair(tl.BODIES["dense_per_step"]),
    "bidirectional": lambda: tl._pair(tl.BODIES["bidir_concat"]),
    "blocks": lambda: (__import__("test_torch_attention_train").pair()),
}


@pytest.mark.parametrize("name", sorted(LAYER_SIZE_NETS))
def test_layer_size_and_summary_match_jax(name):
    """layer_size of every layer (conv: channels, dense/recurrent: n_out,
    pooling, BN, attention, embedding, a bidirectional wrapper) and the
    summary table, row for row (the reference's summary cannot count a
    Bidirectional layer's nested params, so that one is held to the port's
    own count)."""
    jnet, tnet = LAYER_SIZE_NETS[name]()
    sizes = [tnet.layer_size(i) for i in range(len(tnet.layers))]
    assert sizes == [jnet.layer_size(i) for i in range(len(jnet.layers))]
    if name == "bidirectional":
        assert tnet.summary().splitlines()[-1] == f"Total parameters: {tnet.num_params():,}"
    else:
        assert tnet.summary().splitlines() == jnet.summary().splitlines()


# --------------------------------------------------------------- graph
@pytest.fixture(scope="module")
def narrow_pair():
    """The narrow graph of ``test_torch_train.py`` (stem conv, BN, pool, two
    fused bottlenecks, avgpool, softmax 10) in both packages, randomized BN,
    and a seeded batch."""
    jg = JGraph(tt._narrow(tt.jconf, tt.jlayers, tt.jupd, None)).init()
    params, state = tt._tree(jg.params_), tt._tree(jg.state_)
    tt.randomize_bn(params, state, 9)
    jg2, tg = tt._narrow_pair(None, params, state)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((10, 15, 17, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 10)]
    return jg2, tg, x, y


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_graph_feed_forward_and_summary_match_jax(narrow_pair, train):
    jg, tg, x, _ = narrow_pair
    t_acts, j_acts = tg.feed_forward(x, train=train), jg.feed_forward(x, train=train)
    assert t_acts.keys() == j_acts.keys()
    for k in j_acts:
        close(t_acts[k], j_acts[k], k)
    assert tg.summary().splitlines() == jg.summary().splitlines()


def _lstm_graph(pkg):
    conf, layers = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(11).graph_builder().add_inputs("in")
          .set_input_types(conf.InputType.recurrent(5)))
    gb.add_layer("lstm", layers.GravesLSTM(n_out=6, activation="tanh"), "in")
    gb.add_layer("dense", layers.DenseLayer(n_out=7, activation="relu"), "lstm")
    gb.add_layer("out", layers.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                 "dense")
    return gb.set_outputs("out").build()


def test_graph_rnn_time_step_matches_jax():
    """A graph with a GravesLSTM streamed in calls of 1, 4 and 1 steps (a
    2-D call is one step and comes back 2-D), against JAX's, and against
    the port's own full-sequence output; rnn_clear_previous_state starts
    over."""
    jg = JGraph(_lstm_graph(tl.J)).init()
    params = jax.tree_util.tree_map(np.asarray, jg.params_)
    tl._perturb(list(params.values()), seed=5)
    jg.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tg = TGraph(_lstm_graph(tl.T)).init(device="cpu")
    interop.load_jax_params(tg, params, tt._tree(jg.state_))
    x, _ = tl._seq(b=3, t=6)
    full = tg.output_single(x)
    close(full, jg.output_single(x))
    got = []
    for lo, hi in ((0, 1), (1, 5), (5, 6)):
        chunk = x[:, lo] if hi - lo == 1 else x[:, lo:hi]
        (t_y,), (j_y,) = tg.rnn_time_step(chunk), jg.rnn_time_step(chunk)
        assert t_y.shape == j_y.shape
        close(t_y, j_y, f"steps {lo}:{hi}")
        got.append(t_y[:, None] if t_y.ndim == 2 else t_y)
    close(np.concatenate(got, axis=1), full)
    tg.rnn_clear_previous_state()
    jg.rnn_clear_previous_state()
    (t_y,), (j_y,) = tg.rnn_time_step(x[:, 2:4]), jg.rnn_time_step(x[:, 2:4])
    close(t_y, j_y)
    close(t_y, tg.output_single(x[:, 2:4]))


# ------------------------------------------------------------ conversion
def test_to_computation_graph_matches_the_network_and_jax():
    """The chain graph gives the network's output bit for bit and JAX's
    conversion's; one fit step after the conversion equals the network's
    step (bit for bit) and JAX's graph step (1e-5)."""
    jnet, tnet = conv_bn_pair()
    x, y = mlt.data("conv_bn", 8, seed=5)
    tnet.fit(TDataSet(x, y))
    jnet.fit(JDataSet(x, y), batch_size=32)
    tg, jg = tnet.to_computation_graph(), jnet.to_computation_graph()
    assert tg.layer_names == [f"layer_{i}" for i in range(len(tnet.layers))]
    assert tg.iteration == tnet.iteration == 1
    np.testing.assert_array_equal(tg.output_single(x), tnet.output(x))
    close(tg.output_single(x), jg.output_single(x))
    x2, y2 = mlt.data("conv_bn", 8, seed=6)
    tnet.fit(TDataSet(x2, y2))
    tg.fit(TDataSet(x2, y2))
    jg.fit(JDataSet(x2, y2), batch_size=32)
    np.testing.assert_array_equal(tg.params_flat(), tnet.params_flat())
    np.testing.assert_array_equal(tg.opt_state_flat(), tnet.opt_state_flat())
    assert tg.score() == tnet.score()
    close(tg.params_flat(), jg.params_flat())
    close(tg.score(), float(jg.score()))


# ---------------------------------------------------------------- control
def test_set_learning_rate_matches_jax():
    """The updater's JSON after set_learning_rate (and its alias) is the
    reference's, and the next step follows the new rate as JAX's does."""
    jnet, tnet = conv_bn_pair()
    tnet.set_learning_rate(0.05)
    jnet.setLearningRate(0.05)
    assert tnet.conf.to_dict() == jnet.conf.to_dict()
    x, y = mlt.data("conv_bn", 8, seed=7)
    tnet.fit(TDataSet(x, y))
    jnet.fit(JDataSet(x, y), batch_size=32)
    close(tnet.params_flat(), jnet.params_flat())
    tnet.setLearningRate(1e-3)
    assert tnet.layers[0].updater["learning_rate"]["value"] == 1e-3


def _step_args(net, ds, graph):
    return net._batch(_as_multi(ds)) if graph else net._batch(ds)


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_train_step_fn_equals_a_fit_step(kind, guarded, narrow_pair):
    """The pure step on the model's trees (which it leaves unchanged) gives
    what one fit step leaves on the model, bit for bit; guarded: with the
    fault state too. With telemetry the same outputs come first and the
    step's telemetry dict last."""
    if kind == "mln":
        _, net = conv_bn_pair()
        x, y = mlt.data("conv_bn", 8, seed=8)
    else:
        _, tg, x, y = narrow_pair
        net = tg.clone()
    if guarded:
        net.set_fault_policy(FaultPolicy())
    ds = TDataSet(x, y)
    opt = net._ensure_opt_state()
    trees = pipeline.tree_map(lambda t: t.clone(), (net.params_, opt, net.state_))
    args = _step_args(net, ds, kind == "graph")
    step = net.train_step_fn()
    if guarded:
        fstate = net._ensure_fault_state(net._active_fault_policy())
        out = step(net.params_, opt, net.state_, fstate, *args, None, net.iteration, net.epoch)
    else:
        out = step(net.params_, opt, net.state_, *args, None, net.iteration, net.epoch)
    for a, b in zip(pipeline.tree_leaves((net.params_, opt, net.state_)),
                    pipeline.tree_leaves(trees)):
        assert torch.equal(a, b)
    tstep = net.train_step_fn(telemetry=True)
    pre = (fstate,) if guarded else ()
    *tout, telem = tstep(net.params_, opt, net.state_, *pre, *args, None, net.iteration,
                         net.epoch)
    for a, b in zip(pipeline.tree_leaves(tout), pipeline.tree_leaves(out)):
        assert torch.equal(a, b)
    assert ("bad_count" in telem) == guarded and float(telem["update_norm"]) > 0
    net.fit(ExistingDataSetIterator([ds]))
    want = (net.params_, net.opt_state_, net.state_) + (
        (net.fault_state_,) if guarded else ()) + (net.score_,)
    got = pipeline.tree_leaves(out)
    assert len(got) == len(pipeline.tree_leaves(want))
    for a, b in zip(got, pipeline.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_set_learning_rate_drops_the_captured_bundle(kind):
    """The repair: a bundle holds a fixed learning rate as a constant of its
    captured graph. After two bundled fits (k 2, the card's path emulated),
    set_learning_rate drops it; the third bundled fit equals eager steps at
    the new rate bit for bit."""
    if kind == "mln":
        def make(k):
            c = mlt.conv_bn(mlt.PORT)
            c.global_conf.steps_per_call = k
            return TNet(c).init(device="cpu")
        shape, classes = (12, 12, 1), 5
    else:
        def make(k):
            c = tt._narrow(tt.tconf, tt.tlayers, tt.tupd, None)
            c.global_conf.steps_per_call = k
            return TGraph(c).init(device="cpu")
        shape, classes = (15, 17, 3), 10
    rng = np.random.default_rng(9)
    data = [TDataSet(rng.standard_normal((6,) + shape).astype(np.float32),
                     np.eye(classes, dtype=np.float32)[rng.integers(0, classes, 6)])
            for _ in range(2)]
    bundled, eager = make(2), make(1)
    for fit in range(3):
        if fit == 2:
            first = bundled._bundled
            for n in (bundled, eager):
                n.set_learning_rate(0.02)
            assert bundled._bundled is None
        bundled._bundle_step(2).emulate = True
        bundled.fit(ExistingDataSetIterator(data))
        eager.fit(ExistingDataSetIterator(data))
    assert bundled._bundled is not first
    for a, b in zip(pipeline.tree_leaves((bundled.params_, bundled.opt_state_, bundled.state_)),
                    pipeline.tree_leaves((eager.params_, eager.opt_state_, eager.state_))):
        assert torch.equal(a, b)
    assert torch.equal(bundled.score_, eager.score_) and bundled.iteration == 6


def test_set_learning_rate_remakes_the_wrappers_and_masters_bundles():
    """The wrapper's (replicated and ZeRO-1) and the master's cached bundles
    are keyed on the model's learning-rate version too: after
    set_learning_rate their next bundled fit builds a new one, and the
    wrapper's equals the model's own eager steps at the new rate."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster

    def make(k):
        c = mlt.conv_bn(mlt.PORT)
        c.global_conf.steps_per_call = k
        return TNet(c).init(device="cpu")

    rng = np.random.default_rng(10)
    data = [TDataSet(rng.standard_normal((6, 12, 12, 1)).astype(np.float32),
                     np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]) for _ in range(2)]
    for sharded in (False, True):
        net, eager = make(2), make(1)
        pw = ParallelWrapper.builder(net).workers(1).sharded_update(sharded).build()
        pw.fit(ExistingDataSetIterator(data))
        eager.fit(ExistingDataSetIterator(data))
        first = pw._bstep
        for n in (net, eager):
            n.set_learning_rate(0.03)
        pw.fit(ExistingDataSetIterator(data))
        eager.fit(ExistingDataSetIterator(data))
        assert pw._bstep is not first
        np.testing.assert_array_equal(net.params_flat(), eager.params_flat())
    c = mlt.dense(mlt.PORT)  # the master keeps no layer state: no BN
    c.global_conf.steps_per_call = 2
    net = TNet(c).init(device="cpu")
    data = [TDataSet(*mlt.data("dense", 6, seed=s)) for s in (1, 2)]
    master = SharedTrainingMaster.builder(1e-3).build()
    master.fit(net, ExistingDataSetIterator(data))
    first = master._bstep
    net.set_learning_rate(0.03)
    master.fit(net, ExistingDataSetIterator(data))
    assert master._bstep is not first
