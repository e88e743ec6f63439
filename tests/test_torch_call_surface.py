"""Call-surface repairs of the port (ROADMAP § C, C8-C12): each call that
works in the JAX package works in the port with the same arguments, on the
CPU.

- C8: the package namespaces re-export the ported names the reference's
  ``train``, ``serving`` and ``obs`` packages export.
- C9: ``InferenceServer.predict(x, mask=None, timeout_s=None)``: a
  positional mask binds to the mask, in the reference's order.
- C10: ``init_weights(gen, shape, fan_in, fan_out, scheme, distribution,
  dtype)``: a positional distribution is the distribution.
- C11: ``ZooModel.serving_input_shape()`` and ``serving_bucket_policy(
  max_batch=32, batch_buckets=None)`` equal JAX's.
- C12: ``Layer.clone()``, ``DenseLayer.pre_output``, ``name=`` on
  ``serving_matmul`` and ``quantize_layer_params``, ``to_dict``/``from_dict``
  of the updaters, ``RegularizationConf`` and ``Distribution`` (JAX's dicts
  both ways), ``ComputationGraphConfiguration.vertex_types()``,
  ``copy_conf=`` on both networks, ``device_put=`` on ``BatchBundle.stack``
  and ``iter_bundled``, and the networks' ``init(rng=)`` with a seed or a
  generator.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.initializers as jinit
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.regularization as jreg
import deeplearning4j_tpu.updaters as jupd
import deeplearning4j_tpu_torch.initializers as tinit
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.regularization as treg
import deeplearning4j_tpu_torch.updaters as tupd
from deeplearning4j_tpu.data import iterators as jit_
from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.ops import int8_matmul as jim
from deeplearning4j_tpu.serving.server import InferenceServer as JServer
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.ops import int8_matmul as tim
from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine, InferenceServer


# ------------------------------------------------------------------- C8
@pytest.mark.parametrize("module, names", [
    ("train", ["ModelSerializer", "ModelGuesser", "FaultPolicy", "TrainingDivergedError",
               "fault_injection", "validate_checkpoint", "latest_valid_checkpoint"]),
    ("serving", ["GenerationEngine", "GenerationRequest", "GenerationMemoryError",
                 "DecodeStalledError", "GenerationMetrics", "InferenceRequest"]),
    ("obs", ["Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry"]),
])
def test_package_namespaces_export_the_ported_names(module, names):
    import importlib

    jmod = importlib.import_module(f"deeplearning4j_tpu.{module}")
    tmod = importlib.import_module(f"deeplearning4j_tpu_torch.{module}")
    for name in names:
        assert hasattr(jmod, name), name
        mine = getattr(tmod, name)
        owner = importlib.import_module(mine.__module__)
        assert getattr(owner, name) is mine and owner.__name__.startswith(
            "deeplearning4j_tpu_torch."), name


def test_train_namespace_imports_first_in_a_fresh_interpreter():
    import subprocess
    import sys

    code = ("from deeplearning4j_tpu_torch.train import ModelSerializer, FaultPolicy; "
            "import sys; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ------------------------------------------------------------------- C9
def _params_of(sig):
    return [p for p in inspect.signature(sig).parameters if p != "self"]


def test_predict_takes_the_mask_second():
    assert _params_of(InferenceServer.predict)[:3] == _params_of(JServer.predict)[:3] == [
        "x", "mask", "timeout_s"]
    conf = (tconf.NeuralNetConfiguration.builder().seed(1).list()
            .layer(tlayers.LSTM(n_out=4))
            .layer(tlayers.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(tconf.InputType.recurrent(2)).build())
    net = TNet(conf).init(device="cpu")
    engine = InferenceEngine(net, buckets=BucketPolicy(batch_buckets=[2], seq_buckets=[4]),
                             device="cpu")
    server = InferenceServer(engine, port=0)
    try:
        x = np.random.default_rng(0).standard_normal((2, 4, 2)).astype(np.float32)
        m = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
        out, version = server.predict(x, m)
        np.testing.assert_array_equal(out, engine.infer(x, m))
        assert version == 0 and np.abs(out[0, 2:]).max() == 0.0
    finally:
        server.shutdown()


# ------------------------------------------------------------------ C10
def test_init_weights_takes_the_distribution_before_the_dtype():
    assert _params_of(tinit.init_weights)[4:] == _params_of(jinit.init_weights)[4:] == [
        "scheme", "distribution", "dtype"]
    gen = torch.Generator().manual_seed(0)
    w = tinit.init_weights(gen, (3, 4), 3, 4, "distribution",
                           tinit.Distribution("constant", value=0.25), torch.float32)
    want = jinit.init_weights(jax.random.PRNGKey(0), (3, 4), 3, 4, "distribution",
                              jinit.Distribution("constant", value=0.25), jnp.float32)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))
    assert w.dtype == torch.float32


# ------------------------------------------------------------------ C11
@pytest.mark.parametrize("name, kwargs", [("LeNet", {}), ("TextGenerationLSTM", {}),
                                          ("VGG16", {"num_classes": 10})])
def test_zoo_model_serving_hints(name, kwargs):
    from deeplearning4j_tpu import models as jmodels
    from deeplearning4j_tpu_torch import models as tmodels

    jm, tm = getattr(jmodels, name)(**kwargs), getattr(tmodels, name)(**kwargs)
    assert isinstance(tm, tzoo.ZooModel) and isinstance(jm, jzoo.ZooModel)
    assert tm.serving_input_shape() == jm.serving_input_shape()
    for args in ((), (8,), (16, [1, 4])):
        tp, jp = tm.serving_bucket_policy(*args), jm.serving_bucket_policy(*args)
        assert tp.batch_buckets == jp.batch_buckets and tp.seq_buckets == jp.seq_buckets
    tp = tm.serving_bucket_policy(max_batch=4, batch_buckets=[2])
    assert isinstance(tp, BucketPolicy) and tp.batch_buckets == [2, 4]


# ------------------------------------------------------------------ C12
def test_layer_clone_and_dense_pre_output():
    for layers in (jlayers, tlayers):
        d = layers.DenseLayer(n_in=3, n_out=2, activation="tanh", weight_init="relu")
        c = d.clone()
        assert c == d and c is not d
    rng = np.random.default_rng(1)
    p = {"W": rng.standard_normal((3, 2)).astype(np.float32),
         "b": rng.standard_normal(2).astype(np.float32)}
    x = rng.standard_normal((4, 3)).astype(np.float32)
    want = np.asarray(jlayers.DenseLayer(n_in=3, n_out=2, activation="tanh").pre_output(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tlayers.DenseLayer(n_in=3, n_out=2, activation="tanh").pre_output(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_serving_matmul_and_quantize_take_a_name():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    for route in ("f32", "int8"):
        jp, tp = {"Wq": jnp.asarray(w)}, {"Wq": torch.from_numpy(w)}
        if route == "int8":
            jp, tp = jim.quantize_layer_params(jp, name="Wq"), tim.quantize_layer_params(
                tp, name="Wq")
            assert sorted(tp) == sorted(jp) == ["Wq_q8", "Wq_scale"]
            np.testing.assert_array_equal(tp["Wq_q8"].numpy(), np.asarray(jp["Wq_q8"]))
        want = np.asarray(jim.serving_matmul(jp, jnp.asarray(x), name="Wq"))
        got = tim.serving_matmul(tp, torch.from_numpy(x), name="Wq")
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    no_weight = {"b": torch.zeros(2)}
    assert tim.quantize_layer_params(no_weight, name="Wq") is no_weight


@pytest.mark.parametrize("name", ["Sgd", "Adam", "Nesterovs", "AdaGrad", "RmsProp", "AdaDelta",
                                  "AdaMax", "Nadam", "AMSGrad", "NoOp"])
def test_updater_dicts_both_ways(name):
    j, t = getattr(jupd, name)(), getattr(tupd, name)()
    assert t.to_dict() == j.to_dict()
    assert tupd.Updater.from_dict(j.to_dict()) == t
    assert jupd.Updater.from_dict(t.to_dict()) == j
    assert type(tupd.Updater.from_dict(t.to_dict())) is type(t)


def test_regularization_and_distribution_dicts_both_ways():
    j, t = (jreg.RegularizationConf(l1=0.1, l2=2e-4, l2_bias=1e-5),
            treg.RegularizationConf(l1=0.1, l2=2e-4, l2_bias=1e-5))
    assert t.to_dict() == j.to_dict()
    assert treg.RegularizationConf.from_dict(j.to_dict()) == t
    assert jreg.RegularizationConf.from_dict(t.to_dict()) == j
    for kind, kw in (("normal", {"mean": 0.1, "std": 2.0}), ("uniform", {"lower": -1.0}),
                     ("orthogonal", {"gain": 0.5})):
        jd, td = jinit.Distribution(kind, **kw), tinit.Distribution(kind, **kw)
        assert td.to_dict() == jd.to_dict()
        assert tinit.Distribution.from_dict(jd.to_dict()) == td
        assert jinit.Distribution.from_dict(td.to_dict()) == jd


def _graph(conf, layers):
    gb = (conf.NeuralNetConfiguration.builder().seed(4).graph_builder().add_inputs("a", "b")
          .set_input_types(conf.InputType.feed_forward(3), conf.InputType.feed_forward(4)))
    gb.add_layer("d1", layers.DenseLayer(n_out=3), "a")
    gb.add_layer("d", layers.DenseLayer(n_out=5), "d1", "b")
    gb.add_layer("out", layers.OutputLayer(n_out=2, activation="softmax"), "d")
    return gb.set_outputs("out").build()


def test_vertex_types_match_jax():
    j, t = _graph(jconf, jlayers), _graph(tconf, tlayers)
    jt, tt = j.vertex_types(), t.vertex_types()
    assert list(tt) == list(jt)
    assert {k: v.to_dict() for k, v in tt.items()} == {k: v.to_dict() for k, v in jt.items()}


def test_networks_take_copy_conf():
    for conf, cls in ((_graph(tconf, tlayers), TGraph),
                      ((tconf.NeuralNetConfiguration.builder().list()
                        .layer(tlayers.OutputLayer(n_out=2, activation="softmax"))
                        .set_input_type(tconf.InputType.feed_forward(3)).build()), TNet)):
        assert cls(conf).conf is not conf
        assert cls(conf, copy_conf=False).conf is conf
        assert cls(conf, copy_conf=True).conf == conf


def test_init_takes_a_seed_or_a_generator():
    conf = _graph(tconf, tlayers)
    base = TGraph(conf).init(device="cpu")
    by_seed = TGraph(conf).init(4, device="cpu")
    by_gen = TGraph(conf).init(rng=torch.Generator().manual_seed(4), device="cpu")
    other = TGraph(conf).init(rng=5, device="cpu")
    assert np.array_equal(base.params_flat(), by_seed.params_flat())
    assert np.array_equal(base.params_flat(), by_gen.params_flat())
    assert not np.array_equal(base.params_flat(), other.params_flat())
    mconf = (tconf.NeuralNetConfiguration.builder().seed(9).list()
             .layer(tlayers.OutputLayer(n_out=2, activation="softmax"))
             .set_input_type(tconf.InputType.feed_forward(3)).build())
    assert np.array_equal(TNet(mconf).init(9, device="cpu").params_flat(),
                          TNet(mconf).init(device="cpu").params_flat())


def test_bundles_take_device_put():
    rng = np.random.default_rng(3)
    data = [(rng.standard_normal((2, 3)).astype(np.float32),
             rng.standard_normal((2, 2)).astype(np.float32)) for _ in range(4)]
    jb = jit_.BatchBundle.stack([JDS(x, y) for x, y in data], device_put=True)
    tb = tit.BatchBundle.stack([TDS(x, y) for x, y in data], device_put="cpu")
    assert isinstance(tb.features, torch.Tensor) and tb.features.device.type == "cpu"
    np.testing.assert_array_equal(tb.features.numpy(), np.asarray(jb.features))
    assert tb.features_mask is None and tb.k == jb.k == 4
    host = tit.BatchBundle.stack([TDS(x, y) for x, y in data])
    assert isinstance(host.features, np.ndarray)
    got = list(tit.iter_bundled([TDS(x, y) for x, y in data], 2, device_put="cpu"))
    want = list(jit_.iter_bundled([JDS(x, y) for x, y in data], 2, device_put=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
    if not torch.cuda.is_available():
        from deeplearning4j_tpu_torch import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            tit.BatchBundle.stack([TDS(x, y) for x, y in data], device_put=True)
