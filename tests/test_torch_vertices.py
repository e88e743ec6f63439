"""The port's graph vertices (``nn/conf/graph_vertices.py``) against the JAX
package's, on the CPU.

- Each ported vertex's ``apply`` on seeded inputs (numpy) equals JAX's
  within 1e-6 (absolute, f32), in and out of train mode; its
  ``feed_forward_mask`` too (Stack, Unstack, Preprocessor, the default);
  its output type equals JAX's; its configuration dict, with the
  reference's ``@class`` name, is JAX's, and JAX's dict decodes into it.
- The builder's implicit ``"{name}-merge"`` MergeVertex of a multi-input
  layer: the same configuration dict as JAX's builder makes, the same
  collision error, and a graph over it (with Subset, Scale, Shift,
  L2Normalize, L2, Stack/Unstack, Reshape, Preprocessor and PoolHelper
  vertices) whose forward and one ``fit`` step equal JAX's from carried
  params at 1e-5.
- The three time-series vertices (LastTimeStep, DuplicateToTimeSeries,
  ReverseTimeSeries), masked and unmasked: output, output mask and output
  type equal JAX's at 1e-6, and their JSON reads both ways; the builder
  wires DuplicateToTimeSeries' ``timesteps_input`` as JAX's does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.nn.conf.graph_vertices as JV
import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu.updaters as jupd
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.nn.conf.graph_vertices as TV
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
import deeplearning4j_tpu_torch.updaters as tupd
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet as TMulti
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph

TOL = 1e-6       # a vertex's output against JAX's (f32, absolute)
GRAPH_TOL = 1e-5  # the vertex graph's forward and fit step against JAX's

JAX = (jconf, jlayers, jupd, JV, JP)
PORT = (tconf, tlayers, tupd, TV, TP)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.3).astype(np.float32)


# name -> (constructor over a vertex module and a preprocessor module, input
# shapes, input types as (kind, dims))
CASES = {
    "merge_cnn": (lambda V, P: V.MergeVertex(), [(2, 3, 4, 5), (2, 3, 4, 2)],
                  [("convolutional", (3, 4, 5)), ("convolutional", (3, 4, 2))]),
    "merge_ff": (lambda V, P: V.MergeVertex(), [(3, 4), (3, 6), (3, 1)],
                 [("feedforward", (4,)), ("feedforward", (6,)), ("feedforward", (1,))]),
    "merge_rnn_rank3": (lambda V, P: V.MergeVertex(require_rank=3), [(2, 5, 3), (2, 5, 4)],
                        [("recurrent", (3, 5)), ("recurrent", (4, 5))]),
    "merge_one": (lambda V, P: V.MergeVertex(), [(3, 4)], [("feedforward", (4,))]),
    "elementwise_add": (lambda V, P: V.ElementWiseVertex("add"), [(2, 3, 3, 4)] * 3,
                        [("convolutional", (3, 3, 4))] * 3),
    "elementwise_subtract": (lambda V, P: V.ElementWiseVertex("subtract"), [(3, 4)] * 2,
                             [("feedforward", (4,))] * 2),
    "elementwise_product": (lambda V, P: V.ElementWiseVertex("product"), [(3, 4)] * 3,
                            [("feedforward", (4,))] * 3),
    "elementwise_average": (lambda V, P: V.ElementWiseVertex("average"), [(3, 4)] * 3,
                            [("feedforward", (4,))] * 3),
    "elementwise_max": (lambda V, P: V.ElementWiseVertex("max"), [(3, 4)] * 2,
                        [("feedforward", (4,))] * 2),
    "subset_ff": (lambda V, P: V.SubsetVertex(1, 4), [(3, 7)], [("feedforward", (7,))]),
    "subset_cnn": (lambda V, P: V.SubsetVertex(0, 2), [(2, 3, 3, 5)],
                   [("convolutional", (3, 3, 5))]),
    "subset_rnn": (lambda V, P: V.SubsetVertex(2, 2), [(2, 4, 5)], [("recurrent", (5, 4))]),
    "stack": (lambda V, P: V.StackVertex(), [(2, 4), (3, 4)], [("feedforward", (4,))] * 2),
    "unstack": (lambda V, P: V.UnstackVertex(1, 3), [(6, 4)], [("feedforward", (4,))]),
    "l2normalize": (lambda V, P: V.L2NormalizeVertex(), [(3, 2, 2, 3)],
                    [("convolutional", (2, 2, 3))]),
    "l2normalize_eps": (lambda V, P: V.L2NormalizeVertex(eps=1e-3), [(4, 5)],
                        [("feedforward", (5,))]),
    "l2": (lambda V, P: V.L2Vertex(), [(3, 2, 4), (3, 2, 4)], [("recurrent", (4, 2))] * 2),
    "scale": (lambda V, P: V.ScaleVertex(0.17), [(3, 4)], [("feedforward", (4,))]),
    "shift": (lambda V, P: V.ShiftVertex(-1.5), [(3, 2, 2, 2)],
              [("convolutional", (2, 2, 2))]),
    "poolhelper": (lambda V, P: V.PoolHelperVertex(), [(2, 5, 4, 3)],
                   [("convolutional", (5, 4, 3))]),
    "reshape": (lambda V, P: V.ReshapeVertex([-1, 2, 3, 2]), [(4, 12)],
                [("feedforward", (12,))]),
    "reshape_typed": (lambda V, P: V.ReshapeVertex(
        [-1, 6], output_type={"kind": "feedforward", "size": 6}), [(2, 3, 2)],
        [("recurrent", (2, 3))]),
    "preprocessor_cnn_ff": (lambda V, P: V.PreprocessorVertex(
        P.CnnToFeedForwardPreProcessor(3, 2, 2)), [(2, 3, 2, 2)],
        [("convolutional", (3, 2, 2))]),
    "preprocessor_rnn_ff": (lambda V, P: V.PreprocessorVertex(
        P.RnnToFeedForwardPreProcessor()), [(2, 3, 4)], [("recurrent", (4, 3))]),
}


def _itype(conf_mod, kind, dims):
    it = conf_mod.InputType
    return {"feedforward": it.feed_forward, "recurrent": it.recurrent,
            "convolutional": it.convolutional}[kind](*dims)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vertex_matches_jax(case, train):
    make, shapes, types = CASES[case]
    jv, tv = make(JV, JP), make(TV, TP)
    xs = [_rand(s, i) for i, s in enumerate(shapes)]
    want = np.asarray(jv.apply([jnp.asarray(x) for x in xs], [None] * len(xs), train=train))
    got = tv.apply([torch.from_numpy(x) for x in xs], [None] * len(xs), train=train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jt = jv.get_output_type(*[_itype(jconf, k, d) for k, d in types])
    tt = tv.get_output_type(*[_itype(tconf, k, d) for k, d in types])
    assert tt.to_dict() == jt.to_dict()


@pytest.mark.parametrize("case", sorted(CASES))
def test_vertex_json_both_ways(case):
    make = CASES[case][0]
    jv, tv = make(JV, JP), make(TV, TP)
    jd, td = jserde.encode(jv), tserde.encode(tv)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert td["@class"] == type(jv).__name__
    assert tserde.decode(jd) == tv
    assert jserde.decode(td) == jv


# name -> (constructor, mask shapes (None: no mask))
MASK_CASES = {
    "default_first_set": (lambda V, P: V.MergeVertex(), [None, (3, 5), (3, 5)]),
    "default_none": (lambda V, P: V.ElementWiseVertex("add"), [None, None]),
    "stack": (lambda V, P: V.StackVertex(), [(2, 5), (3, 5)]),
    "stack_none": (lambda V, P: V.StackVertex(), [None, None]),
    "unstack": (lambda V, P: V.UnstackVertex(2, 3), [(6, 5)]),
    "unstack_none": (lambda V, P: V.UnstackVertex(0, 2), [None]),
    "preprocessor_rnn_ff": (lambda V, P: V.PreprocessorVertex(
        P.RnnToFeedForwardPreProcessor()), [(2, 4)]),
    "preprocessor_cnn_ff": (lambda V, P: V.PreprocessorVertex(
        P.CnnToFeedForwardPreProcessor(2, 2, 1)), [(3, 4)]),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_feed_forward_mask_matches_jax(case):
    make, shapes = MASK_CASES[case]
    ms = [None if s is None else _mask(s, i) for i, s in enumerate(shapes)]
    want = make(JV, JP).feed_forward_mask([None if m is None else jnp.asarray(m) for m in ms])
    got = make(TV, TP).feed_forward_mask([None if m is None else torch.from_numpy(m)
                                          for m in ms])
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vertex_errors_match_jax():
    """The reference's refusals: an odd stack size, mixed stack masks, a
    subtract of three, the wrong rank for ``require_rank``, mismatched
    merge shapes, a PoolHelper on feed-forward input."""
    x6 = [_rand((5, 2), 0)]
    for V, P, as_t in ((JV, JP, jnp.asarray), (TV, TP, torch.from_numpy)):
        with pytest.raises(ValueError, match="not divisible"):
            V.UnstackVertex(0, 2).apply([as_t(x6[0])], [None])
        with pytest.raises(ValueError, match="all-or-none"):
            V.StackVertex().feed_forward_mask([None, as_t(_mask((2, 3), 1))])
        with pytest.raises(ValueError, match="exactly 2"):
            V.ElementWiseVertex("subtract").apply([as_t(x6[0])] * 3, [None] * 3)
        with pytest.raises(ValueError, match="rank-4"):
            V.MergeVertex(require_rank=4).apply([as_t(x6[0])], [None])
        with pytest.raises(ValueError, match="op must be one of"):
            V.ElementWiseVertex("divide")
    for conf_mod, V in ((jconf, JV), (tconf, TV)):
        it = conf_mod.InputType
        with pytest.raises(ValueError, match="spatial"):
            V.MergeVertex().get_output_type(it.convolutional(2, 2, 1), it.convolutional(3, 2, 1))
        with pytest.raises(ValueError, match="convolutional"):
            V.PoolHelperVertex().get_output_type(it.feed_forward(4))


# name -> (constructor, input shapes, mask shapes or None per input (each
# mask a ragged prefix of ones, a row of zeros among them), input types)
TIME_SERIES_CASES = {
    "LastTimeStepVertex": (lambda V: V.LastTimeStepVertex(mask_input="in"), [(5, 7, 3)],
                           [("recurrent", (3, 7))]),
    "DuplicateToTimeSeriesVertex": (lambda V: V.DuplicateToTimeSeriesVertex("seq"),
                                    [(5, 3), (5, 7, 2)],
                                    [("feedforward", (3,)), ("recurrent", (2, 7))]),
    "ReverseTimeSeriesVertex": (lambda V: V.ReverseTimeSeriesVertex(mask_input="in"),
                                [(5, 7, 3)], [("recurrent", (3, 7))]),
}


def _prefix_mask(b, t, seed):
    lens = np.random.default_rng(seed).integers(0, t + 1, b)
    lens[0] = t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(TIME_SERIES_CASES))
def test_time_series_vertex_matches_jax(name, masked):
    """Each time-series vertex's output, output mask and output type equal
    JAX's (1e-6), with and without masks; its JSON reads both ways."""
    make, shapes, types = TIME_SERIES_CASES[name]
    jv, tv = make(JV), make(TV)
    xs = [_rand(s, i) for i, s in enumerate(shapes)]
    ms = [_prefix_mask(s[0], s[1], 10 + i) if masked and len(s) == 3 else None
          for i, s in enumerate(shapes)]
    jm = [None if m is None else jnp.asarray(m) for m in ms]
    tm = [None if m is None else torch.from_numpy(m) for m in ms]
    want = np.asarray(jv.apply([jnp.asarray(x) for x in xs], jm))
    got = tv.apply([torch.from_numpy(x) for x in xs], tm)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jmask, tmask = jv.feed_forward_mask(jm), tv.feed_forward_mask(tm)
    assert (jmask is None) == (tmask is None)
    if jmask is not None:
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jt = jv.get_output_type(*[_itype(jconf, k, d) for k, d in types])
    tt = tv.get_output_type(*[_itype(tconf, k, d) for k, d in types])
    assert tt.to_dict() == jt.to_dict()
    jd, td = jserde.encode(jv), tserde.encode(tv)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert tserde.decode(jd) == tv and jserde.decode(td) == jv


def test_duplicate_to_time_series_is_wired_as_an_edge():
    """The builder adds a DuplicateToTimeSeriesVertex's ``timesteps_input``
    as its second input, as JAX's builder does."""
    confs = []
    for conf, layers, upd, V, P in (JAX, PORT):
        gb = (conf.NeuralNetConfiguration.builder().graph_builder().add_inputs("seq", "ctx")
              .add_vertex("dup", V.DuplicateToTimeSeriesVertex("seq"), "ctx")
              .add_vertex("both", V.MergeVertex(), "seq", "dup")
              .add_layer("out", layers.RnnOutputLayer(n_out=2, activation="softmax",
                                                      loss="mcxent"), "both")
              .set_outputs("out")
              .set_input_types(conf.InputType.recurrent(3, 6), conf.InputType.feed_forward(4)))
        confs.append(gb.build())
    j, t = confs
    assert t.vertex_inputs["dup"] == ["ctx", "seq"] == j.vertex_inputs["dup"]
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert {k: v.to_dict() for k, v in t.vertex_types().items()} == \
        {k: v.to_dict() for k, v in j.vertex_types().items()}


# ------------------------------------------------------------- the builder
def _merge_graph(pkg, seed=7):
    """Two inputs into one dense layer (the implicit merge), then Subset,
    Scale, Shift, L2Normalize, an L2 distance, Stack/Unstack, a Reshape
    and a Preprocessor into a CNN branch with a PoolHelper, merged again
    into the output layer (the implicit merge of a multi-input output)."""
    conf, layers, upd, V, P = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(seed)
          .updater(upd.Nesterovs(1e-2, 0.9)).weight_init("xavier").graph_builder()
          .add_inputs("a", "b")
          .set_input_types(conf.InputType.feed_forward(6), conf.InputType.feed_forward(4)))
    gb.add_layer("d", layers.DenseLayer(n_out=12, activation="tanh"), "a", "b")
    gb.add_vertex("sub", V.SubsetVertex(2, 9), "d")
    gb.add_vertex("scale", V.ScaleVertex(0.5), "sub")
    gb.add_vertex("shift", V.ShiftVertex(0.25), "scale")
    gb.add_vertex("norm", V.L2NormalizeVertex(), "shift")
    gb.add_vertex("dist", V.L2Vertex(), "sub", "norm")
    gb.add_vertex("stack", V.StackVertex(), "norm", "shift")
    gb.add_vertex("unstack", V.UnstackVertex(1, 2), "stack")
    gb.add_vertex("img", V.ReshapeVertex([-1, 3, 3, 2], output_type={
        "kind": "convolutional", "height": 3, "width": 3, "channels": 2}), "d-pad")
    gb.add_layer("d-pad", layers.DenseLayer(n_out=18, activation="identity"), "d")
    gb.add_layer("conv", layers.ConvolutionLayer(n_out=3, kernel_size=2, activation="relu"),
                 "img")
    gb.add_vertex("trim", V.PoolHelperVertex(), "conv")
    gb.add_vertex("flat", V.PreprocessorVertex(P.CnnToFeedForwardPreProcessor(1, 1, 3)), "trim")
    gb.add_layer("out", layers.OutputLayer(n_out=5, activation="softmax", loss="mcxent"),
                 "unstack", "dist", "flat", "a")
    return gb.set_outputs("out").build()


def test_implicit_merge_matches_jax_builder():
    j, t = _merge_graph(JAX), _merge_graph(PORT)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert isinstance(t.vertices["d-merge"], TV.MergeVertex)
    assert t.vertex_inputs["d-merge"] == ["a", "b"] and t.vertex_inputs["d"] == ["d-merge"]
    assert t.vertex_inputs["out-merge"] == ["unstack", "dist", "flat", "a"]
    assert t.vertices["d"].layer.n_in == 10 and t.vertices["out"].layer.n_in == 8 + 1 + 3 + 6
    back = type(t).from_json(j.to_json())
    assert back == t


def test_implicit_merge_name_collision_raises():
    for conf, layers, upd, V, P in (JAX, PORT):
        gb = (conf.NeuralNetConfiguration.builder().graph_builder().add_inputs("a", "b")
              .add_vertex("d-merge", V.MergeVertex(), "a", "b"))
        with pytest.raises(ValueError, match="Implicit merge name 'd-merge' collides"):
            gb.add_layer("d", layers.DenseLayer(n_out=3), "a", "b")


def _graph_pair():
    tg = TGraph(_merge_graph(PORT)).init(device="cpu")
    jg = JGraph(_merge_graph(JAX))
    jg.params_ = jax.tree_util.tree_map(jnp.asarray, interop.export_params(tg))
    jg.state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_state(tg))
    jg.opt_state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_opt_state(tg))
    jg.iteration = jg.epoch = 0
    return jg, tg


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_vertex_graph_forward_and_fit_match_jax():
    jg, tg = _graph_pair()
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((4, 4)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    np.testing.assert_allclose(tg.output(a, b)[0], np.asarray(jg.output(a, b)[0]),
                               atol=GRAPH_TOL, rtol=0)
    jg.fit(JMulti([a, b], [y]))
    tg.fit(TMulti([a, b], [y]))
    assert abs(tg.score() - float(jg.score_)) <= GRAPH_TOL * abs(float(jg.score_))
    jp = jax.tree_util.tree_map(np.asarray, jg.params_)
    for v, p in interop.export_params(tg).items():
        for k, arr in p.items():
            assert _max_rel(arr, jp[v][k]) <= GRAPH_TOL, (v, k)
