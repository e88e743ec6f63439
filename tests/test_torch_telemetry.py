"""In-graph training telemetry of the port against the JAX package's, on the
CPU.

The same fit (weights carried as arrays, numpy inputs from a seed), each
package with a listener recording every step's telemetry
(``telemetry_done``): the gradient's, params' and update's global norms and
the update ratio within 1e-6 relative of JAX's, step for step:

- eager, for a MultiLayerNetwork (with l2, so the update reads more than
  the gradient) and a ComputationGraph;
- bundled (k 4: one host fetch of the stacked telemetry a bundle), and the
  card's path emulated (static buffers written by the body);
- guarded: a clean step's norms are JAX's unguarded step's, a poisoned
  step reports ``update_norm`` 0, ``bad_count`` 1 and a NaN gradient norm;
- ``ParallelWrapper`` on one in-process rank, replicated and ZeRO-1, against
  JAX's wrapper on its CPU mesh.

``global_norm`` sums in f32 whatever the dtype; ``TelemetryConf`` JSON goes
both ways; the fit is the same bits with telemetry on or off.
"""

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
from deeplearning4j_tpu.obs import telemetry as jtel
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.obs import telemetry as ttel
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh
from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection

TEL_TOL = 1e-6
JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)
KEYS = ["grad_norm", "param_norm", "update_norm", "update_ratio"]


def mlp(pkg, steps=1):
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01)).l2(1e-3)
            .telemetry(True).steps_per_call(steps).list()
            .layer(layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(5)).build())


def graph(pkg):
    conf, layers, upd = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Nesterovs(0.05, 0.9))
          .telemetry(True).graph_builder().add_inputs("in")
          .set_input_types(conf.InputType.feed_forward(5)))
    gb.add_layer("dense", layers.DenseLayer(n_out=8, activation="relu"), "in")
    gb.add_layer("out", layers.OutputLayer(n_out=3, activation="softmax"), "dense")
    return gb.set_outputs("out").build()


def pair(kind="mlp", steps=1):
    if kind == "graph":
        jnet, tnet = JGraph(graph(JAX)).init(), TGraph(graph(PORT)).init(device="cpu")
    else:
        jnet, tnet = JNet(mlp(JAX, steps)).init(), TNet(mlp(PORT, steps)).init(device="cpu")
    interop.load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_),
                            jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def data(n=4, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


class Recorder:
    """Every step's telemetry (duck-typed: works with either package)."""

    def __init__(self):
        self.rows = []
        self.bundles = []

    def telemetry_done(self, model, it0, epoch, bt):
        host = bt.host()
        self.bundles.append(bt)
        for j in range(len(bt)):
            self.rows.append({k: float(np.asarray(v)[j]) for k, v in host.items()})

    def iteration_done(self, model, iteration, epoch):
        pass


def fit_recorded(net, batches, iterator, dataset, epochs=1):
    rec = Recorder()
    net.set_listeners(rec)
    net.fit(iterator([dataset(x, y) for x, y in batches]), epochs=epochs)
    return rec


def assert_rows(mine, theirs, keys=KEYS):
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b)
        for k in keys:
            assert a[k] == pytest.approx(b[k], rel=TEL_TOL), (k, a[k], b[k])


# ------------------------------------------------------------------ eager
@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_eager_telemetry_matches_jax(kind):
    jnet, tnet = pair(kind)
    plain = pair(kind)[1]
    plain.conf.global_conf.telemetry = None
    batches = data()
    mine = fit_recorded(tnet, batches, TExisting, TDataSet, epochs=2)
    theirs = fit_recorded(jnet, batches, JExisting, JDataSet, epochs=2)
    assert_rows(mine.rows, theirs.rows)
    assert sorted(mine.rows[0]) == KEYS
    plain.fit(TExisting([TDataSet(x, y) for x, y in batches]), epochs=2)
    np.testing.assert_array_equal(plain.params_flat(), tnet.params_flat())
    np.testing.assert_array_equal(plain.opt_state_flat(), tnet.opt_state_flat())


@pytest.mark.parametrize("emulate", [False, True], ids=["eager", "emulated"])
def test_bundled_telemetry_matches_jax_with_one_fetch(emulate):
    """k 4 over 8 batches: the stacked telemetry of each bundle is fetched
    once however many listeners read it, and equals JAX's bundled run's and
    the port's single steps'."""
    jnet, tnet = pair(steps=4)
    if emulate:
        tnet._bundle_step(4).emulate = True
    single = pair()[1]
    batches = data(8)
    second = Recorder()
    tnet.set_listeners(second)
    rec = Recorder()
    tnet.add_listeners(rec)
    before = ttel._host_fetches
    tnet.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    assert ttel._host_fetches - before == 2 and len(rec.bundles) == 2
    assert all(len(b) == 4 for b in rec.bundles)
    theirs = fit_recorded(jnet, batches, JExisting, JDataSet)
    assert_rows(rec.rows, theirs.rows)
    eager = fit_recorded(single, batches, TExisting, TDataSet)
    assert rec.rows == eager.rows


def test_guarded_telemetry_and_a_skipped_step():
    """Under the fault policy: clean steps report JAX's unguarded norms and
    ``bad_count`` 0; the poisoned step (iteration 1) reports a NaN gradient
    norm, ``update_norm`` 0 and ``bad_count`` 1, which the next clean step
    keeps."""
    jnet, tnet = pair()
    tnet.set_fault_policy(FaultPolicy())
    batches = data(3)
    with fault_injection(nan_grad_steps=[1]):
        mine = fit_recorded(tnet, batches, TExisting, TDataSet)
    theirs = fit_recorded(jnet, batches[:1], JExisting, JDataSet)
    assert [r["bad_count"] for r in mine.rows] == [0, 1, 1]
    assert_rows(mine.rows[:1], [dict(theirs.rows[0], bad_count=0)])
    skipped = mine.rows[1]
    assert np.isnan(skipped["grad_norm"]) and skipped["update_norm"] == 0.0
    assert skipped["update_ratio"] == 0.0
    assert skipped["param_norm"] == pytest.approx(mine.rows[2]["param_norm"], rel=1e-2)


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "zero1"])
def test_wrapper_telemetry_matches_jax(sharded):
    """One in-process rank, replicated and ZeRO-1, single steps and a bundle
    of 2: each step's telemetry equals JAX's wrapper's on its CPU mesh (the
    global gradient's norms)."""
    jnet, tnet = pair(steps=2)
    batches = data(3)
    trec, jrec = Recorder(), Recorder()
    tnet.set_listeners(trec)
    jnet.set_listeners(jrec)
    (ParallelWrapper(tnet, mesh=TrainingMesh(1, device="cpu"), sharded_update=sharded)
     .fit(TExisting([TDataSet(x, y) for x, y in batches])))
    JWrapper.builder(jnet).workers(2).sharded_update(sharded).build().fit(
        JExisting([JDataSet(x, y) for x, y in batches]))
    assert len(trec.bundles) == 2 and len(trec.bundles[0]) == 2
    assert_rows(trec.rows, jrec.rows)


# ------------------------------------------------------------------- units
def test_global_norm_and_step_telemetry_match_jax():
    rng = np.random.default_rng(4)
    tree = [{"W": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}, {}]
    new = [{k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in tree[0].items()}, {}]
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree[0].items()},
             {}]
    t = lambda tr: [{k: torch.from_numpy(v) for k, v in d.items()} for d in tr]  # noqa: E731
    j = lambda tr: [{k: jnp.asarray(v) for k, v in d.items()} for d in tr]  # noqa: E731
    fstate_t = {"bad_count": torch.tensor(2, dtype=torch.int32)}
    fstate_j = {"bad_count": jnp.asarray(2, jnp.int32)}
    mine = ttel.step_telemetry(ttel.TelemetryConf(), t(grads), t(tree), t(new),
                               fstate=fstate_t, scale=torch.tensor(128.0))
    theirs = jtel.step_telemetry(jtel.TelemetryConf(), j(grads), j(tree), j(new),
                                 fstate=fstate_j, scale=jnp.asarray(128.0))
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert float(mine[k]) == pytest.approx(float(theirs[k]), rel=TEL_TOL), k
    bf = torch.full((4096,), 300.0, dtype=torch.bfloat16)
    assert ttel.global_norm([bf]).dtype == torch.float32
    assert float(ttel.global_norm([bf])) == pytest.approx(300.0 * 64.0, rel=1e-6)
    assert float(ttel.global_norm([{}])) == 0.0
    partial = ttel.step_telemetry(ttel.TelemetryConf(param_norm=False, update_ratio=False),
                                  t(grads), t(tree), t(new))
    assert sorted(partial) == ["grad_norm"]


def test_telemetry_conf_json_both_ways():
    mine = ttel.TelemetryConf(grad_norm=True, param_norm=False, update_ratio=True,
                              loss_scale=False)
    theirs = jtel.TelemetryConf(grad_norm=True, param_norm=False, update_ratio=True,
                                loss_scale=False)
    assert mine.to_dict() == theirs.to_dict()
    conf = mlp(PORT)
    conf.global_conf.telemetry = mine
    back = type(conf).from_json(conf.to_json())
    assert back.global_conf.telemetry == mine
    jback = type(mlp(JAX)).from_json(conf.to_json())
    assert jback.global_conf.telemetry == theirs
    from_jax = type(conf).from_json(jback.to_json())
    assert from_jax.global_conf.telemetry == mine
    assert isinstance(mlp(PORT).global_conf.telemetry, ttel.TelemetryConf)
    net = TNet(mlp(PORT)).init(device="cpu")
    net.conf.global_conf.telemetry = {"@class": "TelemetryConf", "grad_norm": True,
                                      "param_norm": False, "update_ratio": False,
                                      "loss_scale": False}
    assert ttel.resolve(net) == ttel.TelemetryConf(True, False, False, False)
    net.conf.global_conf.telemetry = False
    assert ttel.resolve(net) is None
