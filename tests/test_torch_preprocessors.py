"""The port's eight preprocessors of ``nn/conf/preprocessors.py`` (CnnToRnn,
RnnToCnn, Reshape, Composable, ZeroMean, UnitVariance,
ZeroMeanAndUnitVariance, BinomialSampling) against the JAX package's on the
CPU.

- Each deterministic one's ``pre_process`` on seeded inputs equals JAX's
  within 1e-6 (absolute, f32), its ``feed_forward_mask`` too (Composable
  maps the mask through its parts), its output type equals JAX's, and its
  configuration dict is JAX's both ways.
- BinomialSampling draws from another generator than JAX's, so it is held
  by moments: 0/1 values in the input's dtype, the mean of the draws within
  four standard errors of the clipped input's mean (and JAX's within the
  same), an input of 0s and 1s returned as it is, two batches drawn apart
  and a batch drawn again the same.
- A Composable preprocessor on a layer vertex of a graph hands the feature
  mask on through its parts: a masked graph's output equals JAX's at 1e-5,
  its masked steps 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph

TOL = 1e-6
GRAPH_TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _itype(conf_mod, kind, dims):
    it = conf_mod.InputType
    return {"feedforward": it.feed_forward, "recurrent": it.recurrent,
            "convolutional": it.convolutional}[kind](*dims)


# name -> (constructor over a preprocessor module, input shape, mask shape or
# None, input type as (kind, dims))
CASES = {
    "cnn_to_rnn": (lambda P: P.CnnToRnnPreProcessor(timesteps=3), (6, 2, 2, 3), (2, 3),
                   ("convolutional", (2, 2, 3))),
    "rnn_to_cnn": (lambda P: P.RnnToCnnPreProcessor(2, 3, 2), (4, 5, 12), (4, 5),
                   ("recurrent", (12, 5))),
    "reshape": (lambda P: P.ReshapePreprocessor([3, 4]), (5, 12), None, ("feedforward", (12,))),
    "reshape_typed": (lambda P: P.ReshapePreprocessor(
        [2, 3, 2], output_type={"kind": "convolutional", "height": 2, "width": 3,
                                "channels": 2}), (4, 12), None, ("feedforward", (12,))),
    "composable": (lambda P: P.ComposableInputPreProcessor(
        P.RnnToFeedForwardPreProcessor(), P.ZeroMeanPrePreProcessor()), (3, 4, 5), (3, 4),
        ("recurrent", (5, 4))),
    "composable_list": (lambda P: P.ComposableInputPreProcessor(
        [P.CnnToFeedForwardPreProcessor(2, 2, 3), P.UnitVarianceProcessor()]), (5, 2, 2, 3),
        None, ("convolutional", (2, 2, 3))),
    "zero_mean": (lambda P: P.ZeroMeanPrePreProcessor(), (7, 6), None, ("feedforward", (6,))),
    "unit_variance": (lambda P: P.UnitVarianceProcessor(), (7, 6), None,
                      ("feedforward", (6,))),
    "unit_variance_constant": (lambda P: P.UnitVarianceProcessor(), (1, 6), None,
                               ("feedforward", (6,))),
    "zero_mean_unit_variance": (lambda P: P.ZeroMeanAndUnitVariancePreProcessor(), (9, 4, 3),
                                (9, 4), ("recurrent", (3, 4))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessor_matches_jax(case):
    make, shape, mshape, (kind, dims) = CASES[case]
    jp, tp = make(JP), make(TP)
    x = _rand(shape, 0)
    m = None if mshape is None else (np.random.default_rng(1).random(mshape) > 0.3).astype(
        np.float32)
    want = np.asarray(jp.pre_process(jnp.asarray(x), None if m is None else jnp.asarray(m)))
    got = tp.pre_process(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jm = jp.feed_forward_mask(None if m is None else jnp.asarray(m))
    tm = tp.feed_forward_mask(None if m is None else torch.from_numpy(m))
    assert (jm is None) == (tm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jt = jp.get_output_type(_itype(jconf, kind, dims))
    tt = tp.get_output_type(_itype(tconf, kind, dims))
    assert tt.to_dict() == jt.to_dict()


@pytest.mark.parametrize("case", sorted(CASES) + ["binomial"])
def test_preprocessor_json_both_ways(case):
    make = CASES[case][0] if case in CASES else (
        lambda P: P.BinomialSamplingPreProcessor(seed=11))
    jp, tp = make(JP), make(TP)
    jd, td = jserde.encode(jp), tserde.encode(tp)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert td["@class"] == type(jp).__name__
    assert tserde.decode(jd) == tp
    assert jserde.decode(td) == jp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binomial_sampling_moments(dtype):
    """0/1 draws whose mean is the clipped input's, as JAX's are."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.2, 1.2, (256, 64)).astype(np.float32)
    p = np.clip(x, 0.0, 1.0)
    se = float(np.sqrt((p * (1 - p)).sum())) / p.size
    tdt = getattr(torch, dtype)
    got = TP.BinomialSamplingPreProcessor(seed=3).pre_process(torch.from_numpy(x).to(tdt))
    want = np.asarray(JP.BinomialSamplingPreProcessor(seed=3).pre_process(
        jnp.asarray(x).astype(getattr(jnp, dtype))).astype(jnp.float32))
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    g = got.float().numpy()
    assert set(np.unique(g)) <= {0.0, 1.0}
    for draws in (g, want):
        assert abs(float(draws.mean()) - float(p.mean())) <= 4 * se
    # where p is 0 or 1 the draw is certain
    assert (g[p == 0.0] == 0).all() and (g[p == 1.0] == 1).all()
    # the draw follows p: rows of high p draw more ones than rows of low p
    lo, hi = p < 0.2, p > 0.8
    assert g[hi].mean() > 0.8 and g[lo].mean() < 0.2


def test_binomial_sampling_is_a_function_of_its_input():
    pre = TP.BinomialSamplingPreProcessor(seed=3)
    x = torch.from_numpy(np.random.default_rng(6).random((32, 16)).astype(np.float32))
    assert torch.equal(pre.pre_process(x), pre.pre_process(x.clone()))
    other = pre.pre_process(x.flip(0).contiguous()).flip(0)
    assert not torch.equal(pre.pre_process(x), other)
    assert not torch.equal(pre.pre_process(x), TP.BinomialSamplingPreProcessor(4).pre_process(x))
    bits = torch.tensor([[0.0, 1.0, 1.0, 0.0]])
    assert torch.equal(pre.pre_process(bits), bits)


def _prep_graph(conf, layers, P, seed=5):
    """A recurrent input into an LSTM, then a per-step output layer behind a
    composition of two batch standardizations, which hands the feature
    mask on to it."""
    gb = (conf.NeuralNetConfiguration.builder().seed(seed).weight_init("xavier").graph_builder()
          .add_inputs("seq").set_input_types(conf.InputType.recurrent(4, 6)))
    gb.add_layer("lstm", layers.LSTM(n_out=5), "seq")
    gb.add_layer("out", layers.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                 "lstm", preprocessor=P.ComposableInputPreProcessor(
                     P.ZeroMeanPrePreProcessor(), P.UnitVarianceProcessor()))
    return gb.set_outputs("out").build()


def test_masked_graph_through_preprocessors_matches_jax():
    t = TGraph(_prep_graph(tconf, tlayers, TP)).init(device="cpu")
    j = JGraph(_prep_graph(jconf, jlayers, JP))
    j.params_ = jax.tree_util.tree_map(jnp.asarray, interop.export_params(t))
    j.state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_state(t))
    x = _rand((3, 6, 4), 7)
    m = (np.arange(6)[None, :] < np.array([[6], [2], [4]])).astype(np.float32)
    want = np.asarray(j.output_single(x, masks=[m]))
    got = t.output_single(x, masks=[m])
    np.testing.assert_allclose(got, want, atol=GRAPH_TOL, rtol=0)
    assert np.abs(got[1, 2:]).max() == 0.0 < np.abs(got[1, :2]).min()
