"""The port's MultiLayerNetwork against the JAX package on the CPU.

- Configuration: a JSON written by either package loads in the other, and
  the inserted preprocessors (list and graph builder) are the reference's.
- Eval forward with weights carried across (LeNet and a narrow VGG-shaped
  network): f32 outputs equal JAX's within 1e-5 (f32 summation order);
  under ``compute_dtype="bfloat16"`` within twice JAX's own bf16-vs-f32
  distance, as in ``test_torch_resnet50.py``.
- Checkpoints: the regression fixture ``cnn_bn_adam_v1.zip`` restored by
  the port matches its golden at atol 1e-6, the reference's own bound
  (``test_regression_format.py:22-29``); a port-written zip restores in JAX
  with the same outputs (1e-6: the same weights and the same f32 program);
  a graph round-trips through the port's zip.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import VGG16, ZOO, AlexNet, ModelSelector
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train.model_serializer import (
    ModelGuesser,
    ModelSerializer,
)
from tests.torch_mln_pairs import CONFS, JAX, PORT, inputs, numpy_tree, pair, small_graph

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regression")


# ---------------------------------------------------------------- configuration
@pytest.mark.parametrize("name", sorted(CONFS))
def test_conf_dict_is_the_references(name):
    j, t = CONFS[name](JAX), CONFS[name](PORT)
    assert t.to_dict() == j.to_dict()
    assert t.preprocessors == {k: CnnToFeedForwardPreProcessor(
        p.height, p.width, p.channels) for k, p in j.preprocessors.items()}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_json_loads_in_both_directions(name):
    j, t = CONFS[name](JAX, "bfloat16"), CONFS[name](PORT, "bfloat16")
    from_jax = TConf.from_json(j.to_json())
    from_port = JConf.from_json(t.to_json())
    assert from_jax == t and from_jax.to_json() == j.to_json()
    assert from_port == j and from_port.to_json() == t.to_json()


def test_vgg16_conf_and_size():
    conf = VGG16().conf()
    assert len(conf.layers) == 21 and set(conf.preprocessors) == {18}
    p = conf.preprocessors[18]
    assert (p.height, p.width, p.channels) == (7, 7, 512)
    types = conf.layer_types()
    assert types[18].size == 25088 and types[-1].size == 1000
    heads = [(layer.n_in, layer.n_out) for layer in conf.layers[18:]]
    assert heads == [(25088, 4096), (4096, 4096), (4096, 1000)]
    n = sum(layer.kernel_size[0] * layer.kernel_size[1] * layer.n_in * layer.n_out
            + layer.n_out for layer in conf.layers if hasattr(layer, "has_bias"))
    n += sum(a * b + b for a, b in heads)
    assert n == 138_357_544


def test_graph_builder_inserts_the_references_preprocessor():
    j, t = small_graph(JAX), small_graph(PORT)
    assert t.to_dict() == j.to_dict()
    assert t.vertices["dense"].preprocessor == CnnToFeedForwardPreProcessor(4, 4, 3)
    assert t.vertices["dense"].layer.n_in == 48


def test_unported_zoo_names_and_features_raise():
    """Every reference zoo name is ported (the zoo's own tests are in
    ``test_torch_zoo.py``); in-graph telemetry is ported too: a LeNet fit
    with it leaves its telemetry dict."""
    assert sorted(ZOO) == ["alexnet", "darknet19", "facenetnn4small2", "googlenet",
                           "inceptionresnetv1", "lenet", "resnet50", "simplecnn",
                           "textgenlstm", "tinyyolo", "vgg16", "vgg19", "yolo2"]
    assert isinstance(ModelSelector.select("alexnet"), AlexNet)
    conf = CONFS["lenet"](PORT)
    conf.global_conf.telemetry = True
    net = TNet(conf).init(device="cpu")
    net.fit(inputs("lenet", 2), np.eye(10, dtype=np.float32)[:2])
    assert np.isfinite(float(net.step_telemetry_["grad_norm"]))


# -------------------------------------------------------------------- forward
@pytest.mark.parametrize("name", sorted(CONFS))
def test_eval_forward_matches_jax_f32(name):
    jnet, tnet = pair(name)
    x = inputs(name, 5, seed=1)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.shape == want.shape == (5, 10)
    assert 0.05 < float(want.max(1).mean()) < 0.95  # an unsaturated softmax
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert tnet.num_params() == jnet.num_params()
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())


@pytest.mark.parametrize("name", sorted(CONFS))
def test_eval_forward_matches_jax_bf16(name):
    jnet, tnet = pair(name, compute_dtype="bfloat16")
    j32, _ = pair(name)
    x = inputs(name, 5, seed=2)
    want = np.asarray(jnet.output(x), np.float32)
    noise = float(np.abs(want - np.asarray(j32.output(x))).max())
    got = tnet.output(x)
    assert got.dtype == np.float32 and noise > 0
    assert float(np.abs(got - want).max()) <= 2 * noise


def test_stop_before_gives_the_first_heads_input():
    jnet, tnet = pair("narrow_vgg")
    x = inputs("narrow_vgg", 3)
    with torch.inference_mode():
        h, _, _ = tnet._forward(tnet.params_, tnet.state_, torch.from_numpy(x),
                                stop_before=5)
    hj, _, _, _, _ = jnet._forward(jnet.params_, jnet.state_, x, train=False,
                                   rng=None, stop_before=5)
    assert tuple(h.shape) == (3, 4 * 4 * 16)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=1e-5)


def test_summary_and_flat_params_round_trip():
    _, tnet = pair("lenet")
    text = tnet.summary()
    assert "Total parameters: 1,256,080" in text and "OutputLayer" in text
    vec = tnet.params_flat()
    other = TNet(CONFS["lenet"](PORT)).init(device="cpu")
    other.set_params_flat(vec)
    np.testing.assert_array_equal(other.params_flat(), vec)
    with pytest.raises(ValueError):
        other.set_params_flat(vec[:-1])


# ---------------------------------------------------------------- checkpoints
def test_regression_fixture_matches_its_golden():
    path = os.path.join(FIXTURES, "cnn_bn_adam_v1.zip")
    net = ModelSerializer.restore_multi_layer_network(path, load_updater=False,
                                                      device="cpu")
    g = np.load(os.path.join(FIXTURES, "cnn_bn_adam_v1_golden.npz"))
    np.testing.assert_allclose(net.output(g["x"]), g["y"], atol=1e-6)
    assert net.iteration == int(g["iteration"])
    assert net.opt_state_ is None
    assert isinstance(ModelGuesser.load_model_guess(path, device="cpu"), TNet)
    # the updater state restores by default, as in the reference
    with_updater = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    flat = with_updater.opt_state_flat()
    assert flat.size > 0 and np.abs(flat).max() > 0
    np.testing.assert_array_equal(with_updater.params_flat(), net.params_flat())


def test_port_written_zip_restores_in_jax(tmp_path):
    jnet, tnet = pair("narrow_vgg")
    tnet.iteration, tnet.epoch = 7, 2
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(tnet, path)
    # no train step yet, so no updater state to write
    assert tnet.opt_state_ is None
    assert sorted(zipfile.ZipFile(path).namelist()) == [
        "coefficients.bin", "configuration.json", "meta.json", "state.bin"]
    meta = json.loads(zipfile.ZipFile(path).read("meta.json"))
    assert meta["model_type"] == "MultiLayerNetwork" and meta["iteration"] == 7
    back = JSer.restore_multi_layer_network(path)
    x = inputs("narrow_vgg", 4, seed=3)
    np.testing.assert_allclose(np.asarray(back.output(x)), tnet.output(x),
                               rtol=0, atol=1e-6)
    assert back.iteration == 7 and back.epoch == 2
    mine = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(mine.output(x), tnet.output(x))


def test_jax_written_zip_restores_in_the_port(tmp_path):
    jnet, _ = pair("lenet")
    path = str(tmp_path / "jax.zip")
    JSer.write_model(jnet, path)
    net = ModelGuesser.load_model_guess(path, device="cpu")
    x = inputs("lenet", 3, seed=4)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-5)


def test_graph_round_trips_through_the_port_zip(tmp_path):
    jg = JGraph(small_graph(JAX)).init()
    tg = TGraph(small_graph(PORT)).init(device="cpu")
    load_jax_params(tg, numpy_tree(jg.params_), numpy_tree(jg.state_))
    path = str(tmp_path / "graph.zip")
    ModelSerializer.write_model(tg, path)
    back = JSer.restore_computation_graph(path)
    x = np.random.default_rng(5).standard_normal((2, 6, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(back.output_single(x)),
                               tg.output_single(x), rtol=0, atol=1e-6)
    mine = ModelGuesser.load_model_guess(path, device="cpu")
    assert isinstance(mine, TGraph)
    np.testing.assert_array_equal(mine.output_single(x), tg.output_single(x))
