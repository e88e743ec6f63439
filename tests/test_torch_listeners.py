"""Training listeners of the port against the JAX package's, on the CPU.

The same fit (weights carried as arrays, numpy inputs from a seed) of a
small MLP and of a small graph, each package with its own listeners:

- what ``CollectScoresIterationListener`` and ``ScoreIterationListener``
  collect (iterations and epochs exact, scores within 1e-6 relative), eager
  and in bundles of 4 (one host fetch of the scores a bundle);
- ``CheckpointListener``'s files under each ``keep_mode`` (the same names),
  and the last one restoring the fitted params;
- ``ParamAndGradientIterationListener``'s lines (per-parameter statistics
  of the params and the introspected gradients: the header exactly, the
  values to their 6 printed digits);
- ``EvaluativeListener``'s evaluations and ``model_saving_callback``'s
  files; ``ProfilerListener``'s window (closed by its length, at the end
  of the fit, and when the fit raises);
- attaching listeners, introspection included, leaves the params
  ``torch.equal`` to the run without them; ``bundling_blockers`` decides
  the clamp to single steps.
"""

import os

import jax
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
from deeplearning4j_tpu.train import listeners as jl
from deeplearning4j_tpu.train import pipeline as jpipeline
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train import listeners as tl
from deeplearning4j_tpu_torch.train import pipeline as tpipeline
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

SCORE_TOL = 1e-6
JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def mlp(pkg, steps=1):
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
            .steps_per_call(steps).list()
            .layer(layers.DenseLayer(n_out=7, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(5)).build())


def graph(pkg):
    conf, layers, upd = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
          .graph_builder().add_inputs("in").set_input_types(conf.InputType.feed_forward(5)))
    gb.add_layer("dense", layers.DenseLayer(n_out=7, activation="tanh"), "in")
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


def data(n=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


def its(batches):
    return (JExisting([JDataSet(x, y) for x, y in batches]),
            TExisting([TDataSet(x, y) for x, y in batches]))


def fit_both(jnet, tnet, batches, epochs=2):
    jit, tit = its(batches)
    jnet.fit(jit, epochs=epochs)
    tnet.fit(tit, epochs=epochs)


def assert_scores(mine, theirs):
    assert [i for i, _ in mine] == [i for i, _ in theirs]
    np.testing.assert_allclose([s for _, s in mine], [s for _, s in theirs],
                               rtol=SCORE_TOL, atol=0)


# ------------------------------------------------------------------ scores
@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_score_listeners_collect_what_jax_collects(kind):
    jnet, tnet = pair(kind)
    jc, tc = jl.CollectScoresIterationListener(2), tl.CollectScoresIterationListener(2)
    jlines, tlines = [], []
    jnet.set_listeners(jc, jl.ScoreIterationListener(3, jlines.append))
    tnet.set_listeners(tc, tl.ScoreIterationListener(3, tlines.append))

    class Epochs(tl.TrainingListener):
        def __init__(self):
            self.events = []

        def on_epoch_start(self, model):
            self.events.append(("start", model.epoch, model.iteration))

        def on_epoch_end(self, model):
            self.events.append(("end", model.epoch, model.iteration))

        def on_fit_end(self, model):
            self.events.append(("fit_end", model.epoch, model.iteration))

    epochs = Epochs()
    tnet.add_listeners(epochs)
    fit_both(jnet, tnet, data())
    assert_scores(tc.scores, jc.scores)
    assert [s.split(" is ")[0] for s in tlines] == [s.split(" is ")[0] for s in jlines]
    assert len(tlines) == 2
    assert epochs.events == [("start", 0, 0), ("end", 1, 3), ("start", 1, 3), ("end", 2, 6),
                             ("fit_end", 2, 6)]
    assert tnet.iteration == jnet.iteration == 6 and tnet.epoch == jnet.epoch == 2


def test_bundles_fetch_scores_once_and_match_jax():
    """k 4 over 8 batches: two bundles, the bundle-aware listeners share one
    host fetch a bundle; what they collect is JAX's (k 4 too) and the
    eager run's bit for bit."""
    jnet, tnet = pair(steps=4)
    eager = pair()[1]
    jc, tc, ec = (jl.CollectScoresIterationListener(), tl.CollectScoresIterationListener(),
                  tl.CollectScoresIterationListener())
    lines = []
    jnet.set_listeners(jc)
    tnet.set_listeners(tc, tl.ScoreIterationListener(2, lines.append), tl.PerformanceListener(2))
    eager.set_listeners(ec)
    batches = data(8)
    before = tpipeline._host_fetches
    fit_both(jnet, tnet, batches, epochs=1)
    assert tpipeline._host_fetches - before == 2
    assert tnet.bundle_scores_ is not None and tnet.last_batch_size == 8
    eager.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    assert tc.scores == ec.scores and len(lines) == 4
    assert_scores(tc.scores, jc.scores)
    assert jpipeline.bundling_blockers(jnet.listeners) == \
        tpipeline.bundling_blockers(tnet.listeners) == []


def test_bundling_clamp_follows_the_blockers():
    """Per-step hooks and ``requires_per_step_state`` clamp k to 1, with the
    reasons JAX gives; the telemetry mode of the gradient listener and an
    epoch checkpoint keep k."""
    def reasons(mod, lst):
        return mod.bundling_blockers(lst)

    for make in (lambda m, d: [m.ParamAndGradientIterationListener(output_to_console=False)],
                 lambda m, d: [m.CheckpointListener(d, save_every_n_iterations=2)],
                 lambda m, d: [m.EvaluativeListener(None, invocation="iteration_end")],
                 lambda m, d: [m.ComposableIterationListener(
                     m.ParamAndGradientIterationListener(output_to_console=False))],
                 lambda m, d: [m.ParamAndGradientIterationListener(
                     gradients="telemetry", output_to_console=False),
                     m.CheckpointListener(d, save_every_n_epochs=1)]):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            mine, theirs = reasons(tpipeline, make(tl, d)), reasons(jpipeline, make(jl, d))
            assert mine == theirs
            net = TNet(mlp(PORT, 4)).init(device="cpu")
            net.set_listeners(*make(tl, d))
            assert tpipeline.resolve_steps_per_call(net) == (1 if mine else 4)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("mode,last,every", [("all", 1, 0), ("last", 2, 0),
                                             ("last_and_every", 1, 3)])
def test_checkpoint_files_and_retention_match_jax(tmp_path, mode, last, every):
    jnet, tnet = pair()
    jd, td = tmp_path / "jax", tmp_path / "port"
    jnet.set_listeners(jl.CheckpointListener(str(jd), save_every_n_iterations=1,
                                             keep_mode=mode, keep_last=last, keep_every=every))
    tck = tl.CheckpointListener(str(td), save_every_n_iterations=1, keep_mode=mode,
                                keep_last=last, keep_every=every)
    tnet.set_listeners(tck)
    fit_both(jnet, tnet, data())
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    assert len(tck.checkpoints) == {"all": 6, "last": 2, "last_and_every": 2}[mode]
    back = ModelSerializer.restore_multi_layer_network(tck.checkpoints[-1], device="cpu")
    np.testing.assert_array_equal(back.params_flat(), tnet.params_flat())
    assert back.iteration == 6
    # a reopened directory numbers on after the checkpoints it holds
    again = tl.CheckpointListener(str(td), save_every_n_epochs=1)
    assert again._counter == 6


def test_orbax_checkpoints_are_refused_typed(tmp_path):
    with pytest.raises(tl.SerializerNotPortedError, match="ROADMAP § A8"):
        tl.CheckpointListener(str(tmp_path), save_every_n_epochs=1, serializer="orbax")
    with pytest.raises(ValueError, match="serializer must be"):
        tl.CheckpointListener(str(tmp_path), serializer="pickle")


# ------------------------------------------------------- params, gradients
def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_param_and_gradient_lines_match_jax(tmp_path, kind):
    jnet, tnet = pair(kind)
    jf, tf = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    jnet.set_listeners(jl.ParamAndGradientIterationListener(2, output_to_console=False, file=jf))
    tnet.set_listeners(tl.ParamAndGradientIterationListener(2, output_to_console=False, file=tf))
    fit_both(jnet, tnet, data())
    mine, theirs = _rows(tf), _rows(jf)
    assert mine[0] == theirs[0] and len(mine) == len(theirs) == 4
    assert any(c.startswith("g_") for c in mine[0])
    for a, b in zip(mine[1:], theirs[1:]):
        assert a[0] == b[0]
        np.testing.assert_allclose([float(v) for v in a[1:]], [float(v) for v in b[1:]],
                                   rtol=2e-5, atol=1e-7)


def test_introspected_gradients_are_the_steps_and_change_nothing():
    """The introspection pass hands over the step's own gradients (the
    gradients ``compute_gradient_and_score`` gives before the step), and a
    fit with every listener attached leaves the params ``torch.equal`` to
    the fit without them."""
    class Grabs(tl.TrainingListener):
        def __init__(self):
            self.grads, self.acts = [], []

        def on_forward_pass(self, model, activations):
            self.acts.append(activations)

        def on_gradient_calculation(self, model, gradients):
            self.grads.append(gradients)

    batches = data(2)
    plain = TNet(mlp(PORT)).init(device="cpu")
    net = TNet(mlp(PORT)).init(device="cpu")
    want, _ = net.compute_gradient_and_score(TDataSet(*batches[0]))
    want_out = net.output(batches[0][0])
    grabs = Grabs()
    net.set_listeners(grabs, tl.ScoreIterationListener(1, lambda s: None),
                      tl.CollectScoresIterationListener(), tl.PerformanceListener(1),
                      tl.ParamAndGradientIterationListener(output_to_console=False),
                      tl.TimeIterationListener(4, 1, lambda s: None),
                      tl.SleepyTrainingListener(0.0, 0.0))
    net.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    plain.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    for a, b in zip(plain.params_, net.params_):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert len(grabs.grads) == 2 and len(grabs.acts[0]) == 2
    for layer_got, layer_want in zip(grabs.grads[0], want):
        for k in layer_want:
            np.testing.assert_array_equal(layer_got[k], layer_want[k].numpy())
    np.testing.assert_allclose(grabs.acts[0][1], want_out, rtol=0, atol=1e-7)


# ----------------------------------------------------------------- evaluate
def test_evaluative_listener_matches_jax(tmp_path):
    jnet, tnet = pair()
    ev_data = data(1, b=16, seed=9)[0]
    jev = jl.EvaluativeListener(JExisting([JDataSet(*ev_data)]), printer=lambda s: None)
    saves = tmp_path / "saves"
    saves.mkdir()
    tev = tl.EvaluativeListener(TExisting([TDataSet(*ev_data)]), printer=lambda s: None,
                                callback=tl.model_saving_callback(str(saves), "m_%d.zip"))
    jnet.set_listeners(jev)
    tnet.set_listeners(tev)
    fit_both(jnet, tnet, data())
    assert len(tev.evaluations) == len(jev.evaluations) == 2
    for a, b in zip(tev.evaluations, jev.evaluations):
        assert a.accuracy() == pytest.approx(b.accuracy(), abs=1e-12)
        assert a.f1() == pytest.approx(b.f1(), abs=1e-9)
    assert sorted(os.listdir(saves)) == ["m_1.zip", "m_2.zip"]
    with pytest.raises(ValueError, match="existing directory"):
        tl.model_saving_callback(str(tmp_path / "none"), "x")


# ----------------------------------------------------------------- profiler
def test_profiler_window_closes(tmp_path):
    """A window of 2 iterations closes by its length; one longer than the
    fit closes at the fit's end; one open when the fit raises closes too."""
    batches = data(3)
    net = TNet(mlp(PORT)).init(device="cpu")
    short = tl.ProfilerListener(str(tmp_path / "a"), start_iteration=1, num_iterations=2)
    net.set_listeners(short)
    net.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    assert short.completed and os.path.isfile(short.trace_path)
    net = TNet(mlp(PORT)).init(device="cpu")
    long = tl.ProfilerListener(str(tmp_path / "b"), start_iteration=1, num_iterations=100)
    net.set_listeners(long)
    net.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    assert long.completed and not long._active and os.path.isfile(long.trace_path)

    class Boom(tl.TrainingListener):
        def iteration_done(self, model, iteration, epoch):
            if iteration == 2:
                raise RuntimeError("boom")

    net = TNet(mlp(PORT)).init(device="cpu")
    raised = tl.ProfilerListener(str(tmp_path / "c"), start_iteration=1, num_iterations=100)
    net.set_listeners(raised, Boom())
    with pytest.raises(RuntimeError, match="boom"):
        net.fit(TExisting([TDataSet(x, y) for x, y in batches]))
    assert raised.completed and not raised._active
    assert tl.ProfilerListener.requires_per_step_state


def test_composable_listener_delegates():
    jnet, tnet = pair(steps=4)
    inner = tl.CollectScoresIterationListener()
    tnet.set_listeners(tl.ComposableIterationListener([inner]))
    jinner = jl.CollectScoresIterationListener()
    jnet.set_listeners(jl.ComposableIterationListener([jinner]))
    before = tpipeline._host_fetches
    fit_both(jnet, tnet, data(4), epochs=1)
    assert tpipeline._host_fetches - before == 1
    assert_scores(inner.scores, jinner.scores)
