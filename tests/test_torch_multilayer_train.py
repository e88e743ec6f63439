"""``MultiLayerNetwork`` training and updater-state checkpoints of the port
against the JAX package, on the CPU.

Weights, layer state, updater slots and the iteration move between the
packages as arrays (``interop``) or through a checkpoint zip, never by
seed; inputs are made with numpy from a seed and handed to both.

Tolerances (float32):
- ``fit`` over 3 steps: params, updater slots and scores within FIT_TOL
  (1e-5, absolute). Both compute the same f32 operations; only the order
  of the sums differs (matmul, conv, BN's batch means), which moves a
  gradient by a few ulps and Adam's or Nesterovs' update by as much.
- ``score`` (eval mode): within 1e-6 relative. ``compute_gradient_and_score``
  (train mode): the score within 1e-5 relative and each gradient within
  1e-4 relative to its norm: train-mode BN normalizes by the batch's own
  variance, over 10 x 12 x 12 values here, whose f32 summation order
  differs between the packages (measured: score 1.4e-6 relative).
- The regression zips' goldens: atol 1e-6, the reference's own bound
  (``tests/test_regression_format.py``).
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

FIT_TOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regression")

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def dense(pkg):
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
            .list()
            .layer(layers.DenseLayer(n_out=7, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(5))
            .build())


def conv_bn(pkg):
    """A narrow LeNet-like net: conv, BN, pool, conv, pool, dense, output."""
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(4)
            .updater(upd.Nesterovs(1e-3, 0.9)).l2(1e-4)
            .list()
            .layer(layers.ConvolutionLayer(n_out=4, kernel_size=3, convolution_mode="same",
                                           activation="relu"))
            .layer(layers.BatchNormalization())
            .layer(layers.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(layers.ConvolutionLayer(n_out=6, kernel_size=3, activation="relu"))
            .layer(layers.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(layers.DenseLayer(n_out=16, activation="relu"))
            .layer(layers.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.convolutional(12, 12, 1))
            .build())


NETS = {"dense": (dense, (5,), 3), "conv_bn": (conv_bn, (12, 12, 1), 5)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(name):
    """(JAX net, port net on the CPU) with the same params, state and
    (zero) updater slots."""
    build = NETS[name][0]
    jnet = JNet(build(JAX)).init()
    tnet = TNet(build(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return jnet, tnet


def data(name, n, seed):
    _, shape, classes = NETS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def assert_tracks(jnet, tnet, tol=FIT_TOL):
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=tol)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0, atol=tol)
    for mine, theirs in zip(interop.export_state(tnet), numpy_tree(jnet.state_)):
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=tol, err_msg=k)
    assert tnet.iteration == jnet.iteration and tnet.epoch == jnet.epoch


@pytest.mark.parametrize("name", sorted(NETS))
def test_fit_tracks_jax_over_three_steps(name):
    jnet, tnet = pair(name)
    x, y = data(name, 24, seed=1)
    scores = []
    for _ in range(3):
        jnet.fit(JDataSet(x, y), batch_size=8, epochs=1)
        tnet.fit(TDataSet(x, y), batch_size=8, epochs=1)
        scores.append((float(jnet.score()), tnet.score()))
    assert jnet.iteration == 9
    assert_tracks(jnet, tnet)
    for sj, st in scores:
        assert abs(sj - st) <= FIT_TOL, scores


def test_fit_takes_arrays_and_iterators():
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator, ListDataSetIterator

    x, y = data("dense", 16, seed=2)
    nets = [pair("dense")[1] for _ in range(3)]
    nets[0].fit(x, y, batch_size=8)
    nets[1].fit(ListDataSetIterator(TDataSet(x, y), 8))
    nets[2].fit(ExistingDataSetIterator([TDataSet(x[:8], y[:8]), TDataSet(x[8:], y[8:])]))
    for other in nets[1:]:
        np.testing.assert_array_equal(other.params_flat(), nets[0].params_flat())
        assert other.iteration == 2 and other.epoch == 1


@pytest.mark.parametrize("name", sorted(NETS))
def test_score_and_gradients_match_jax(name):
    jnet, tnet = pair(name)
    x, y = data(name, 10, seed=3)
    assert tnet.score(TDataSet(x, y)) == pytest.approx(
        jnet.score(JDataSet(x, y)), rel=1e-6)
    jg, js = jnet.compute_gradient_and_score(JDataSet(x, y))
    tg, ts = tnet.compute_gradient_and_score(TDataSet(x, y))
    assert ts == pytest.approx(js, rel=1e-5)
    for i, (mine, theirs) in enumerate(zip(tg, numpy_tree(jg))):
        assert set(mine) == set(theirs)
        for k in theirs:
            ref = theirs[k]
            err = np.linalg.norm(mine[k].numpy() - ref) / max(np.linalg.norm(ref), 1e-30)
            assert err <= 1e-4, (i, k, err)
    # nothing was updated
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    assert tnet.iteration == 0


def test_fit_refusals():
    """What ``fit`` refused is ported: a telemetry fit is the same bits as
    one without it, and ``set_listeners`` takes listeners that ``fit``
    calls."""
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresIterationListener

    conf = dense(PORT)
    conf.global_conf.telemetry = True
    net = TNet(conf).init(device="cpu")
    plain = TNet(dense(PORT)).init(device="cpu")
    x, y = data("dense", 4, seed=0)
    net.fit(x, y)
    collect = CollectScoresIterationListener()
    plain.set_listeners(collect)
    plain.fit(x, y)
    np.testing.assert_array_equal(net.params_flat(), plain.params_flat())
    assert net.step_telemetry_ is not None and collect.scores == [(1, plain.score())]


def test_fit_ignores_the_sharded_update_knob():
    """``sharded_update`` is the wrapper's knob; ``fit`` trains as without
    it (the reference's ``fit`` never reads it)."""
    conf = dense(PORT)
    conf.global_conf.sharded_update = True
    a = TNet(conf).init(device="cpu")
    b = pair("dense")[1]
    a.set_params_flat(b.params_flat())
    x, y = data("dense", 8, seed=5)
    a.fit(x, y)
    b.fit(x, y)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())


# ------------------------------------------------------------- checkpoints
def test_cnn_bn_adam_zip_restores_with_updater_state_and_tracks_jax():
    path = os.path.join(FIXTURES, "cnn_bn_adam_v1.zip")
    tnet = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    jnet = JSer.restore_multi_layer_network(path)
    g = np.load(os.path.join(FIXTURES, "cnn_bn_adam_v1_golden.npz"))
    np.testing.assert_allclose(tnet.output(g["x"]), g["y"], atol=1e-6)
    assert tnet.iteration == int(g["iteration"])
    flat = tnet.opt_state_flat()
    assert flat.size > 0 and np.abs(flat).max() > 0
    np.testing.assert_array_equal(flat, jnet.opt_state_flat())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    jnet.fit(JDataSet(x, y), epochs=1, batch_size=8)
    tnet.fit(TDataSet(x, y), epochs=1, batch_size=8)
    assert tnet.iteration == int(g["iteration"]) + 3
    assert_tracks(jnet, tnet)


def test_fused_block_zip_restores_with_updater_state_and_tracks_jax():
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMulti

    path = os.path.join(FIXTURES, "fused_block_adam_v4.zip")
    tnet = ModelSerializer.restore_computation_graph(path, device="cpu")
    jnet = JSer.restore_computation_graph(path)
    g = np.load(os.path.join(FIXTURES, "fused_block_adam_v4_golden.npz"))
    np.testing.assert_allclose(tnet.output_single(g["x"]), g["y"], atol=1e-6)
    assert tnet.iteration == int(g["iteration"])
    np.testing.assert_array_equal(tnet.opt_state_flat(), jnet.opt_state_flat())
    assert np.abs(tnet.opt_state_flat()).max() > 0
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 8, 8, 16)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jnet.fit(JMulti([x], [y]))
        tnet.fit(TDataSet(x, y), batch_size=8)
    assert tnet.iteration == jnet.iteration == int(g["iteration"]) + 3
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)


def test_write_model_saves_the_updater_state_by_default(tmp_path):
    """The reference's default is ``save_updater=True``: a trained model's
    zip carries ``updaterState.bin``, which restores in JAX and in the
    port, and both resume from it as from the original."""
    jnet, tnet = pair("conv_bn")
    x, y = data("conv_bn", 16, seed=6)
    tnet.fit(TDataSet(x, y), batch_size=8)
    jnet.fit(JDataSet(x, y), batch_size=8)
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(tnet, path)
    assert "updaterState.bin" in zipfile.ZipFile(path).namelist()
    meta = json.loads(zipfile.ZipFile(path).read("meta.json"))
    assert meta["iteration"] == 2 and meta["epoch"] == 1
    back = JSer.restore_multi_layer_network(path)
    np.testing.assert_array_equal(back.opt_state_flat(), tnet.opt_state_flat())
    mine = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(mine.opt_state_flat(), tnet.opt_state_flat())
    for net, ds in ((back, JDataSet(x, y)), (jnet, JDataSet(x, y))):
        net.fit(ds, batch_size=8)
    for net in (mine, tnet):
        net.fit(TDataSet(x, y), batch_size=8)
    np.testing.assert_allclose(back.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_array_equal(mine.params_flat(), tnet.params_flat())
    assert_tracks(jnet, tnet)
    ModelSerializer.write_model(tnet, str(tmp_path / "bare.zip"), save_updater=False)
    assert "updaterState.bin" not in zipfile.ZipFile(tmp_path / "bare.zip").namelist()


def test_interop_carries_mln_updater_state_both_ways():
    jnet, tnet = pair("dense")
    x, y = data("dense", 8, seed=8)
    jnet.fit(JDataSet(x, y))
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    assert tnet.iteration == 1
    for mine, theirs in zip(interop.export_opt_state(tnet), numpy_tree(jnet.opt_state_)):
        for k in theirs:
            for s in theirs[k]:
                np.testing.assert_array_equal(mine[k][s], theirs[k][s])
    torch.testing.assert_close(torch.from_numpy(tnet.opt_state_flat()),
                               torch.from_numpy(jnet.opt_state_flat()), rtol=0, atol=0)
