"""Feature masks into the port's ComputationGraph against the JAX package's
graph, on the CPU, at BASELINE config #3's form (the masked LSTM sentiment
graph of ``tests/test_baseline_configs.py``): ``LSTM`` (or ``GravesLSTM``,
peepholes randomized) -> ``LastTimeStepVertex(mask_input="tokens")`` ->
softmax ``OutputLayer``, D 16, T 10, Adam(0.01), xavier; sequences of
seeded lengths 1..T, their steps past the length masked out.

- ``output``, ``output_single``, ``score`` and ``compute_gradient_and_score``
  with masks within 1e-5 (relative to the largest value) of JAX's, weights
  carried from the port (never by seed); ``evaluate`` gives JAX's
  confusion matrix; the mask matters (unmasked outputs differ).
- Three ``fit`` steps: params, Adam slots and score within 1e-5 of JAX's.
- Every fit path of the graph takes the masks and gives eager's bits:
  bundled at k 2 (eager on the CPU and the card's path emulated), guarded
  (``FaultPolicy``, no fault: the unguarded steps; a poisoned step keeps
  params and slots), ``remat_policy`` "nothing", the one-rank
  ``ParallelWrapper`` replicated and ZeRO-1, and ``train_step_fn``.
- A masked and an unmasked batch of one shape in one bundled fit each get
  their own bundle, each captured once (the card's path emulated), and the
  fit equals eager.
- ``InferenceEngine`` (sequence buckets) and ``ParallelInference``
  (sequential, batched, inplace) with graph masks equal
  ``output_single(masks=)`` within 1e-6 (padding rows change the CPU
  matmul's summation order, not the result beyond that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.nn.conf.graph_vertices as JV
import deeplearning4j_tpu.updaters as jupd
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.nn.conf.graph_vertices as TV
import deeplearning4j_tpu_torch.updaters as tupd
from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
from deeplearning4j_tpu_torch.data.iterators import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.parallel import ParallelInference, ParallelWrapper
from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine
from deeplearning4j_tpu_torch.train import pipeline as tpipe
from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection

D, T, B = 16, 10, 8
TOL = 1e-5        # forward, score and 3 fit steps against JAX, relative
SERVE_TOL = 1e-6  # the engines against output_single (batch padding)
JAX = (jconf, jlayers, jupd, JV)
PORT = (tconf, tlayers, tupd, TV)
CELLS = ["LSTM", "GravesLSTM"]


def config3(pkg, cell="LSTM", k=1, policy=None, remat=None):
    conf, layers, upd, V = pkg
    b = (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
         .weight_init("xavier"))
    if k > 1:
        b = b.steps_per_call(k)
    if policy is not None:
        b = b.fault_policy(policy)
    if remat is not None:
        b = b.remat_policy(remat)
    return (b.graph_builder().add_inputs("tokens")
            .add_layer("lstm", getattr(layers, cell)(n_out=16, activation="tanh"), "tokens")
            .add_vertex("last", V.LastTimeStepVertex(mask_input="tokens"), "lstm")
            .add_layer("out", layers.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                       "last")
            .set_outputs("out").set_input_types(conf.InputType.recurrent(D, T)).build())


def port_net(cell="LSTM", **kw):
    """The port's graph on the CPU with live biases and peepholes (a fresh
    GravesLSTM's are 0)."""
    net = TGraph(config3(PORT, cell, **kw)).init(device="cpu")
    gen = torch.Generator().manual_seed(11)
    p = net.params_["lstm"]
    for k in ("b", "pI", "pF", "pO"):
        if k in p:
            p[k] = p[k] + torch.randn(p[k].shape, generator=gen) * 0.3
    return net


def jax_twin(net, cell="LSTM"):
    j = JGraph(config3(JAX, cell))
    j.params_ = jax.tree_util.tree_map(jnp.asarray, interop.export_params(net))
    j.state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_state(net))
    j.opt_state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_opt_state(net))
    return j


def batch(seed, b=B, masked=True):
    """(x, y, mask): seeded sequences of lengths 1..T, one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, D)).astype(np.float32)
    lens = rng.integers(1, T + 1, b)
    lens[0] = 1
    m = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    return x, y, (m if masked else None)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_same(a, b):
    """Two port graphs hold the same bits: params, updater state, score."""
    for ta, tb in ((a.params_, b.params_), (a.opt_state_, b.opt_state_)):
        fa, fb = tpipe.tree_leaves(ta), tpipe.tree_leaves(tb)
        assert len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert torch.equal(torch.as_tensor(a.score_), torch.as_tensor(b.score_))
    assert a.iteration == b.iteration


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("cell", CELLS)
def test_forward_score_and_evaluate_match_jax(cell):
    net = port_net(cell)
    j = jax_twin(net, cell)
    x, y, m = batch(0)
    got = net.output_single(x, masks=[m])
    np.testing.assert_allclose(got, np.asarray(j.output_single(x, masks=[m])),
                               atol=TOL * np.abs(got).max(), rtol=0)
    assert _rel(net.output(x, masks=[m])[0], j.output(x, masks=[m])[0]) <= TOL
    assert _rel(net.output_single(x), got) > 1e-3  # the mask matters
    ts, js = net.score(TDS(x, y, m)), j.score(JDS(x, y, m))
    assert abs(ts - js) <= TOL * abs(js)
    tg, tsc = net.compute_gradient_and_score(TDS(x, y, m))
    jg, jsc = j.compute_gradient_and_score(JDS(x, y, m))
    assert abs(tsc - jsc) <= TOL * abs(jsc)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jg))
    for k, g in _flat({v: {n: t.numpy() for n, t in p.items()} for v, p in tg.items()}).items():
        assert _rel(g, jflat[k]) <= TOL, k
    te = net.evaluate(TDS(x, y, m))
    je = j.evaluate(JDS(x, y, m))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)


@pytest.mark.parametrize("cell", CELLS)
def test_three_fit_steps_match_jax(cell):
    net = port_net(cell)
    j = jax_twin(net, cell)
    for s in range(3):
        x, y, m = batch(10 + s)
        net.fit(TDS(x, y, m))
        j.fit(JDS(x, y, m))
    assert abs(net.score() - float(j.score_)) <= TOL * abs(float(j.score_))
    jp = _flat(jax.tree_util.tree_map(np.asarray, j.params_))
    for k, v in _flat(interop.export_params(net)).items():
        assert _rel(v, jp[k]) <= TOL, k
    jo = _flat(jax.tree_util.tree_map(np.asarray, j.opt_state_))
    for k, v in _flat(interop.export_opt_state(net)).items():
        assert _rel(v, jo[k]) <= TOL, k


# ------------------------------------------------------- every fit path
def _batches(n, masked=True, seed=20):
    return [TDS(*batch(seed + i, masked=masked)) for i in range(n)]


def _fit_each(net, data):
    for ds in data:
        net.fit(ExistingDataSetIterator([ds]))
    return net


@pytest.mark.parametrize("emulate", [False, True], ids=["cpu", "card_path"])
def test_bundled_equals_eager(emulate):
    data = _batches(4)
    eager = _fit_each(port_net(), data)
    bundled = port_net(k=2)
    if emulate:
        bundled._bundle_step(2, ((True,), (False,))).emulate = True
    bundled.fit(ExistingDataSetIterator(data))
    assert_same(bundled, eager)
    assert bundled._bundled.variant == ((True,), (False,))


def test_masked_and_unmasked_batches_get_their_own_bundles(monkeypatch):
    captures = []
    real = tpipe.BundledStep._capture
    monkeypatch.setattr(tpipe.BundledStep, "_capture",
                        lambda self, *a: captures.append(self.variant) or real(self, *a))
    masked, plain = _batches(4), _batches(2, masked=False, seed=40)
    data = masked[:2] + plain + masked[2:]
    eager = _fit_each(port_net(), data)
    net = port_net(k=2)
    for variant in (((True,), (False,)), None):
        net._bundle_step(2, variant).emulate = True
    net.fit(ExistingDataSetIterator(data))
    assert_same(net, eager)
    # masked, unmasked, masked again: the masked bundle is kept, not made anew
    assert captures == [((True,), (False,)), None]
    assert set(net._parked_bundles) == {None}
    assert net._bundled.variant == ((True,), (False,))


def test_guarded_fit_takes_masks():
    data = _batches(3)
    plain = _fit_each(port_net(), data)
    guarded = _fit_each(port_net(policy=FaultPolicy()), data)
    assert_same(guarded, plain)
    with fault_injection([1]):
        poisoned = _fit_each(port_net(policy=FaultPolicy()), data)
    kept = _fit_each(port_net(), [data[0], data[2]])
    for a, b in zip(tpipe.tree_leaves(poisoned.params_), tpipe.tree_leaves(kept.params_)):
        assert torch.equal(a, b)
    assert poisoned.bad_step_count == 1


def test_remat_equals_no_remat():
    data = _batches(2)
    assert_same(_fit_each(port_net(remat="nothing"), data), _fit_each(port_net(), data))


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "zero1"])
def test_one_rank_parallel_wrapper_equals_fit(sharded):
    data = _batches(3)
    eager = _fit_each(port_net(), data)
    net = port_net()
    ParallelWrapper.builder(net).workers(1).sharded_update(sharded).build().fit(
        ExistingDataSetIterator(data))
    assert_same(net, eager)


def test_train_step_fn_takes_masks():
    x, y, m = batch(30)
    a, b = port_net(), port_net()
    a.fit(TDS(x, y, m))
    step = b.train_step_fn()
    b._ensure_opt_state()
    f = lambda t: torch.from_numpy(t)  # noqa: E731
    params, opt, _, score = step(b.params_, b.opt_state_, b.state_, [f(x)], [f(y)], [f(m)],
                                 [None], None, 0, 0)
    for p, q in zip(tpipe.tree_leaves(params), tpipe.tree_leaves(a.params_)):
        assert torch.equal(p, q)
    assert torch.equal(score, a.score_)


# --------------------------------------------------------------- serving
def test_engine_and_parallel_inference_take_graph_masks():
    net = port_net("GravesLSTM")
    x, _, m = batch(50, b=5)
    want = net.output_single(x, masks=[m])
    engine = InferenceEngine(net, buckets=BucketPolicy(batch_buckets=[8], seq_buckets=[T]),
                             device="cpu")
    engine.warmup()
    assert _rel(engine.infer(x, m), want) <= SERVE_TOL
    # an unmasked request through sequence buckets gets a mask of ones
    assert _rel(engine.infer(x), net.output_single(x)) <= SERVE_TOL
    for mode in ("sequential", "inplace"):
        pi = ParallelInference(net, mode=mode, workers=2)
        assert np.array_equal(pi.output(x, m), want)
        pi.shutdown()
    pi = ParallelInference(net, mode="batched", batch_limit=8)
    got = pi.output(x, m, timeout=30)
    pi.shutdown()
    assert _rel(got, want) <= SERVE_TOL
