"""Truncated BPTT and the recurrent heads' score of the port against the JAX
package, on the CPU.

Weights move between the packages as arrays (``interop``) or through the
regression zip, never by seed; inputs are made with numpy from a seed.

- ``fit`` of two GravesLSTM(8) layers with an RnnOutputLayer under tBPTT
  (T 13, chunks of 4, so the last chunk has one step), 2 batches, with and
  without masks, under RmsProp and Adam (every chunk of a batch at the
  batch's ``t``): params, updater state and score within TOL (1e-5, JAX's
  own tolerance), the same for a ``ComputationGraph`` built with
  ``GraphBuilder.backprop_type``, and ``lstm_adam_v1.zip`` resumed in both
  packages, standard and tBPTT.
- ``compute_score`` of ``RnnOutputLayer`` and ``RnnLossLayer`` with a label
  mask, for mcxent, mse and negative log-likelihood: within TOL of JAX's.
- The reference's ``ValueError``s: 2-D labels, ``steps_per_call > 1``; 2-D
  features take the standard step.
- The guard: a poisoned batch skips every chunk (params, updater state and
  the carries kept; the fault state counts the chunks), held to the port's
  own skip and to JAX's unguarded fit on the clean batches.
- Each chunk of a batch draws its own noise; the zoo's TextGenerationLSTM,
  narrow, trains with its tBPTT configuration.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.models.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

TOL = 1e-5
T, L, N_IN, N_OUT, B = 13, 4, 5, 4, 4
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regression")

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _updater(pkg, name):
    return pkg[2].RmsProp(1e-2) if name == "rmsprop" else pkg[2].Adam(1e-2)


def lstm_conf(pkg, updater="adam", dropout=0.0):
    conf, layers, _ = pkg
    return (conf.NeuralNetConfiguration.builder().seed(6).updater(_updater(pkg, updater))
            .list()
            .layer(layers.GravesLSTM(n_out=8, activation="tanh"))
            .layer(layers.GravesLSTM(n_out=8, activation="tanh", dropout=dropout))
            .layer(layers.RnnOutputLayer(n_out=N_OUT, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.recurrent(N_IN))
            .backprop_type("tbptt", L, L).build())


def lstm_graph_conf(pkg, updater="adam"):
    conf, layers, _ = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(6).updater(_updater(pkg, updater))
          .graph_builder().add_inputs("in")
          .set_input_types(conf.InputType.recurrent(N_IN)))
    gb.add_layer("l0", layers.GravesLSTM(n_out=8, activation="tanh"), "in")
    gb.add_layer("l1", layers.GravesLSTM(n_out=8, activation="tanh"), "l0")
    gb.add_layer("out", layers.RnnOutputLayer(n_out=N_OUT, activation="softmax",
                                              loss="mcxent"), "l1")
    return gb.set_outputs("out").backprop_type("tbptt", L, L).build()


def _perturb(tree, seed):
    """Live peepholes and biases (fresh ones are 0 and 1): noise on every
    array."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.2).astype(np.float32), tree)


def pair(updater="adam", graph=False):
    if graph:
        jnet = JGraph(lstm_graph_conf(JAX, updater)).init()
        tnet = TGraph(lstm_graph_conf(PORT, updater)).init(device="cpu")
    else:
        jnet = JNet(lstm_conf(JAX, updater)).init()
        tnet = TNet(lstm_conf(PORT, updater)).init(device="cpu")
    params = _perturb(numpy_tree(jnet.params_), seed=3)
    jnet.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    interop.load_jax_params(tnet, params, numpy_tree(jnet.state_))
    return jnet, tnet


def batches(n=2, masked=False, b=B, t=T, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((b, t, N_IN)).astype(np.float32)
        y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, (b, t))]
        fm = lm = None
        if masked:
            lengths = rng.integers(2, t + 1, b)
            fm = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
            lm = fm.copy()
        out.append((x, y, fm, lm))
    return out


def both_fit(jnet, tnet, data, graph=False):
    jnet.fit(JExisting([JDataSet(*d) for d in data]))
    tnet.fit(TExisting([TDataSet(*d) for d in data]))


def assert_tracks(jnet, tnet, tol=TOL):
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=tol)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0, atol=tol)
    assert abs(tnet.score() - float(jnet.score())) <= tol
    assert tnet.iteration == jnet.iteration


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("updater", ["rmsprop", "adam"])
def test_tbptt_fit_matches_jax(updater, masked):
    jnet, tnet = pair(updater)
    both_fit(jnet, tnet, batches(2, masked))
    assert tnet.iteration == 2
    assert_tracks(jnet, tnet)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("updater", ["rmsprop", "adam"])
def test_tbptt_graph_fit_matches_jax(updater, masked):
    conf = lstm_graph_conf(PORT, updater)
    assert conf.backprop_type == "tbptt" and conf.tbptt_fwd_length == L
    again = type(conf).from_json(conf.to_json())
    assert (again.backprop_type, again.tbptt_fwd_length, again.tbptt_back_length) == \
        ("tbptt", L, L)
    jconf_again = type(lstm_graph_conf(JAX)).from_json(conf.to_json())
    assert jconf_again.tbptt_fwd_length == L
    jnet, tnet = pair(updater, graph=True)
    both_fit(jnet, tnet, batches(2, masked, seed=1))
    assert_tracks(jnet, tnet)


def test_tbptt_shares_t_within_a_batch():
    """Every chunk of a batch runs at the batch's iteration: after one
    batch of four chunks the iteration is 1, and the port's Adam moments
    equal four updates at t = 1 (JAX's NOTE on the clock)."""
    jnet, tnet = pair("adam")
    both_fit(jnet, tnet, batches(1))
    assert tnet.iteration == jnet.iteration == 1
    assert_tracks(jnet, tnet)


@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_regression_zip_resumes_training(mode):
    """``lstm_adam_v1.zip`` restored in both packages (Adam slots and
    iteration 2 included) trains 2 more batches standard or under tBPTT
    (chunks of 2 of 5 steps) and tracks JAX."""
    path = os.path.join(FIXTURES, "lstm_adam_v1.zip")
    jnet = JSer.restore_multi_layer_network(path)
    tnet = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    assert tnet.iteration == jnet.iteration == 2
    for net in (jnet, tnet):
        net.conf.backprop_type = mode
        net.conf.tbptt_fwd_length = 2
    rng = np.random.default_rng(12)
    data = []
    for _ in range(2):
        x = rng.standard_normal((4, 5, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 5))]
        data.append((x, y, None, None))
    both_fit(jnet, tnet, data)
    assert tnet.iteration == 4
    assert_tracks(jnet, tnet)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"), ("mse", "identity"),
                                      ("negativeloglikelihood", "softmax")])
@pytest.mark.parametrize("head", ["output", "loss"])
def test_head_scores_match_jax(head, loss, act):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    if loss == "mse":
        y = rng.standard_normal((3, 6, 4)).astype(np.float32)
    else:
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
    mask = (np.arange(6)[None, :] < np.array([[6], [2], [4]])).astype(np.float32)
    if head == "output":
        jl = jlayers.RnnOutputLayer(n_in=4, n_out=4, activation=act, loss=loss)
        tl = tlayers.RnnOutputLayer(n_in=4, n_out=4, activation=act, loss=loss)
        p = {"W": rng.standard_normal((4, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32)}
    else:
        jl = jlayers.RnnLossLayer(loss=loss, activation=act)
        tl = tlayers.RnnLossLayer(loss=loss, activation=act)
        p = {}
    for m in (None, mask):
        theirs = jl.compute_score({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  jnp.asarray(y), None if m is None else jnp.asarray(m))
        mine = tl.compute_score({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), torch.from_numpy(y),
                                None if m is None else torch.from_numpy(m))
        assert mine.shape == (3,)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- refusals
def test_tbptt_value_errors_match_jax():
    """2-D labels under tBPTT and ``steps_per_call > 1`` raise JAX's
    ``ValueError``s; 2-D features take the standard step."""
    jnet, tnet = pair()
    x = batches(1)[0][0]
    y2 = np.eye(N_OUT, dtype=np.float32)[:B]
    with pytest.raises(ValueError, match="per-timestep labels") as mine:
        tnet.fit(TDataSet(x, y2))
    with pytest.raises(ValueError, match="per-timestep labels") as theirs:
        jnet.fit(JDataSet(x, y2))
    assert str(mine.value) == str(theirs.value)
    tnet.conf.global_conf.steps_per_call = 2
    jnet.conf.global_conf.steps_per_call = 2
    with pytest.raises(ValueError, match="cannot bundle tBPTT") as mine:
        tnet.fit(TDataSet(*batches(1)[0][:2]))
    with pytest.raises(ValueError, match="cannot bundle tBPTT") as theirs:
        jnet.fit(JDataSet(*batches(1)[0][:2]))
    assert str(mine.value) == str(theirs.value)
    assert tnet.iteration == 0

    def dense(pkg, bp):
        conf, layers, upd = pkg
        b = (conf.NeuralNetConfiguration.builder().seed(1).updater(upd.Adam(1e-2)).list()
             .layer(layers.DenseLayer(n_out=6, activation="tanh"))
             .layer(layers.OutputLayer(n_out=3, activation="softmax"))
             .set_input_type(conf.InputType.feed_forward(5)))
        return b.backprop_type(bp, 3, 3).build() if bp else b.build()

    rng = np.random.default_rng(0)
    xf = rng.standard_normal((6, 5)).astype(np.float32)
    yf = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    a, b = TNet(dense(PORT, "tbptt")).init(device="cpu"), TNet(dense(PORT, None)).init(device="cpu")
    b.params_ = [{k: t.clone() for k, t in p.items()} for p in a.params_]
    a.fit(TDataSet(xf, yf))
    b.fit(TDataSet(xf, yf))
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())


# -------------------------------------------------------------------- guard
def test_poisoned_batch_skips_every_chunk():
    """Under the fault policy, a batch whose gradients are poisoned
    (``fault_injection`` at iteration 1) skips all four of its chunks:
    params and updater state equal JAX's unguarded fit on the clean batches
    at their iterations (0, then 2: a guarded chunk's clock is the batch's
    iteration, as the reference's), the fault state counts four bad chunks
    and eight good ones."""
    jnet, tnet = pair()
    tnet.set_fault_policy(FaultPolicy())
    data = batches(3, seed=4)
    with fault_injection(nan_grad_steps=[1]):
        tnet.fit(TExisting([TDataSet(*d) for d in data]))
    jnet.fit(JExisting([JDataSet(*data[0])]))
    jnet.iteration = 2
    jnet.fit(JExisting([JDataSet(*data[2])]))
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0, atol=TOL)
    fs = {k: int(v) for k, v in tnet.fault_state_.items()}
    assert (fs["bad_count"], fs["good_count"], fs["consec"]) == (4, 8, 0)
    assert tnet.iteration == 3


def test_poisoned_chunk_keeps_params_slots_and_carries():
    """The guarded chunk step (``tbptt_step_fn``): at a poisoned iteration
    it returns the params, updater state and carries it was given, and one
    more bad chunk; at a clean one the carries move."""
    _, tnet = pair()
    tnet.set_fault_policy(FaultPolicy())
    step = tnet.tbptt_step_fn()
    x, y, _, _ = batches(1)[0]
    opt = tnet._ensure_opt_state()
    fstate = tnet._ensure_fault_state(tnet._active_fault_policy())
    carries = tnet._init_carries(B)
    carries = [None if c is None else tuple(torch.randn_like(t) for t in c) for c in carries]
    chunk = (torch.from_numpy(x[:, :L]), torch.from_numpy(y[:, :L]), None, None)
    with fault_injection(nan_grad_steps=[0]):
        p, o, s, f, c, score = step(tnet.params_, opt, tnet.state_, fstate, carries, *chunk,
                                    None, 0, 0)
    for a, b in zip(tnet_leaves((p, o, c)), tnet_leaves((tnet.params_, opt, carries))):
        assert torch.equal(a, b)
    assert int(f["bad_count"]) == 1 and int(f["good_count"]) == 0
    p, o, s, f, c, score = step(tnet.params_, opt, tnet.state_, fstate, carries, *chunk, None,
                                0, 0)
    assert not torch.equal(c[0][0], carries[0][0]) and int(f["good_count"]) == 1
    assert np.isfinite(float(score))


def tnet_leaves(tree):
    from deeplearning4j_tpu_torch.train.pipeline import tree_leaves

    return tree_leaves(tree)


# -------------------------------------------------------------------- noise
def test_chunks_of_a_batch_draw_different_masks():
    """With dropout, each chunk takes its own stream (the chunk's index
    under ``TBPTT_STREAM``): the four chunks of a batch draw four different
    masks at the batch's one iteration, and a second fit of the same start
    draws them again."""
    net = TNet(lstm_conf(PORT, dropout=0.5)).init(device="cpu")
    twin = net.clone()
    drawn = []
    orig = TNet.chunk_noise

    def recording(self, chunk, rank=0):
        src = orig(self, chunk, rank)
        drawn.append((self.iteration, chunk,
                      src.child(1).bernoulli(0.5, (B, L, 8), "cpu").clone()))
        return src

    TNet.chunk_noise = recording
    try:
        net.fit(TDataSet(*batches(1)[0][:2]))
        twin.fit(TDataSet(*batches(1)[0][:2]))
    finally:
        TNet.chunk_noise = orig
    assert [(it, c) for it, c, _ in drawn[:4]] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    masks = [m for _, _, m in drawn[:4]]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(masks[i], masks[j])
    np.testing.assert_array_equal(net.params_flat(), twin.params_flat())


def test_narrow_textgen_trains_with_its_tbptt_configuration():
    """The zoo's TextGenerationLSTM (11 classes, 8 units) keeps its
    ``backprop_type("tbptt", 40, 40)`` and trains on 90 steps (three chunks,
    the last of 10): the score falls over a few batches of a repeated
    pattern."""
    net = TextGenerationLSTM(num_classes=11, units=8).init(device="cpu")
    assert (net.conf.backprop_type, net.conf.tbptt_fwd_length) == ("tbptt", 40)
    ids = np.tile(np.arange(11), 9)[None, :90].repeat(4, 0)
    x = np.eye(11, dtype=np.float32)[ids]
    y = np.eye(11, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    scores = []
    for _ in range(4):
        net.fit(TDataSet(x, y))
        scores.append(net.score())
    assert net.iteration == 4 and all(np.isfinite(scores)) and scores[-1] < scores[0]
