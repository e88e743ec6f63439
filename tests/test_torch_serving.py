"""The port's InferenceEngine on the CPU against the JAX ComputationGraph.

A narrow ResNet-style graph (stem, pool, bottlenecks, avgpool, softmax
output) is built by the same builder calls in both packages; the port gets
the JAX weights through ``load_jax_params``. Requests of 1, 3 and 5 rows
pad to buckets [2, 4, 8] and must return the reference's
``output_single`` rows: float32 throughout, so the tolerance is 1e-5 on
probabilities (f32 summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine


def _conf(conf_pkg, layers):
    gb = (conf_pkg.NeuralNetConfiguration.builder().seed(3).weight_init("relu")
          .graph_builder().add_inputs("input")
          .set_input_types(conf_pkg.InputType.convolutional(12, 12, 3)))
    gb.add_layer("stem_conv", layers.ConvolutionLayer(
        n_out=8, kernel_size=3, stride=1, convolution_mode="same",
        activation="identity", has_bias=False), "input")
    gb.add_layer("stem_bn", layers.BatchNormalization(), "stem_conv")
    gb.add_layer("stem_relu", layers.ActivationLayer(activation="relu"), "stem_bn")
    gb.add_layer("stem_pool", layers.SubsamplingLayer(
        kernel_size=3, stride=2, convolution_mode="same"), "stem_relu")
    gb.add_layer("b0", layers.FusedResNetBottleneck(width=4, project=True), "stem_pool")
    gb.add_layer("b1", layers.FusedResNetBottleneck(width=4), "b0")
    gb.add_layer("avgpool", layers.GlobalPoolingLayer(pooling_type="avg"), "b1")
    gb.add_layer("output", layers.OutputLayer(n_out=7, activation="softmax",
                                              loss="mcxent"), "avgpool")
    gb.set_outputs("output")
    return gb.build()


@pytest.fixture(scope="module")
def models():
    jg = JGraph(_conf(jconf, jlayers)).init()
    rng = np.random.default_rng(0)
    state = {v: {k: (rng.uniform(0.5, 1.5, a.shape) if k.startswith("var")
                     else rng.standard_normal(a.shape) * 0.1).astype(np.float32)
                 for k, a in d.items()} for v, d in jg.state_.items()}
    jg.state_ = {v: {k: jnp.asarray(a) for k, a in d.items()} for v, d in state.items()}
    params = {v: {k: np.array(a) for k, a in d.items()} for v, d in jg.params_.items()}
    tg = TGraph(_conf(tconf, tlayers)).init(device="cpu")
    load_jax_params(tg, params, state)
    return jg, tg


def test_engine_answers_like_the_reference(models):
    jg, tg = models
    engine = InferenceEngine(tg, buckets=[2, 4, 8], device="cpu")
    assert engine.example_shape() == (12, 12, 3)
    report = engine.warmup()
    assert report["shapes"] == 3 and report["seconds"] >= 0
    rng = np.random.default_rng(1)
    for n in (1, 3, 5):
        x = rng.standard_normal((n, 12, 12, 3)).astype(np.float32)
        y, version = engine.infer_versioned(x)
        assert version == 0 and y.shape == (n, 7) and y.dtype == np.float32
        np.testing.assert_allclose(y, jg.output_single(x), rtol=0, atol=1e-5)
        np.testing.assert_allclose(y.sum(1), 1.0, atol=1e-5)
    d = engine.describe()
    assert d["warm"] and d["device"] == "cpu" and d["num_params"] == tg.num_params()
    assert d["buckets"] == repr(BucketPolicy(batch_buckets=[2, 4, 8]))


def test_padding_never_leaks_into_rows(models):
    """A row's answer does not depend on the bucket it was padded into."""
    _, tg = models
    engine = InferenceEngine(tg, buckets=BucketPolicy(batch_buckets=[1, 8]),
                             device="cpu")
    x = np.random.default_rng(2).standard_normal((5, 12, 12, 3)).astype(np.float32)
    alone = np.concatenate([engine.infer(x[i:i + 1]) for i in range(5)])
    np.testing.assert_allclose(engine.infer(x), alone, rtol=0, atol=1e-6)


def test_oversized_request_grows_a_bucket(models):
    _, tg = models
    engine = InferenceEngine(tg, buckets=[2, 4], device="cpu")
    x = np.zeros((6, 12, 12, 3), np.float32)
    assert engine.infer(x).shape == (6, 7)
    assert engine.buckets.batch_buckets == [2, 4, 8]


def test_engine_defaults_to_the_card(models, monkeypatch):
    """No device named: the engine wants CUDA, and without a card it says so
    with the typed error."""
    _, tg = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(deeplearning4j_tpu_torch.DeviceUnavailableError, match="cuda"):
        InferenceEngine(tg)
    with pytest.raises(deeplearning4j_tpu_torch.DeviceUnavailableError):
        TGraph(_conf(tconf, tlayers)).init()


@pytest.mark.parametrize("kw", [dict(batch_buckets=[2, 4, 8]), dict(max_batch=12),
                                dict(batch_buckets=[3, 5], max_batch=16)],
                         ids=["explicit", "pow2", "union"])
def test_bucket_policy_matches_the_reference(kw):
    from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBucketPolicy

    mine, ref = BucketPolicy(**kw), JBucketPolicy(**kw)
    assert mine.batch_buckets == ref.batch_buckets
    for n in (1, 2, 3, 5, 9, 17, 40):
        assert mine.bucket_for(n) == ref.bucket_for(n)
        x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        (xp, rows), (xr, _, rows_r) = mine.pad_batch(x), ref.pad_batch(x)
        assert rows == rows_r == n
        np.testing.assert_array_equal(xp, xr)
    assert mine.batch_buckets == ref.batch_buckets
