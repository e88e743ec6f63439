"""``ParallelInference``, ``clone`` and the engine that shares a dispatch
over several devices, against the JAX package on the CPU.

The networks are ``tests/test_data_parallel.py``'s small MLP and the zoo's
LeNet (``tests/torch_mln_pairs.py``), with the JAX package's weights carried
into the port by array. Tolerance 1e-6 on f32 outputs: the reference's own
(``test_data_parallel.py:187-251``); the two packages compute the same f32
operations, in other summation orders. ``cli serve --workers`` runs as a
subprocess, as a user runs it.
"""

import os
import subprocess
import sys
import threading
import warnings

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
import torch_mln_pairs as pairs
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import ParallelInference as JParallelInference
from deeplearning4j_tpu.parallel.mesh import TrainingMesh as JMesh
from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBuckets
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine
from deeplearning4j_tpu_torch.serving.batcher import (
    RequestDeadlineExceeded,
    ServerOverloadedError,
)

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def mlp(pkg):
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Sgd(0.1))
            .list()
            .layer(layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(4))
            .build())


def mlp_pair():
    jnet = JNet(mlp(JAX)).init()
    tnet = TNet(mlp(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, pairs.numpy_tree(jnet.params_), pairs.numpy_tree(jnet.state_))
    return jnet, tnet


def blobs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, 4)) * 3
    cls = rng.integers(0, 3, n)
    return (centers[cls] + rng.standard_normal((n, 4)) * 0.3).astype(np.float32)


def mesh2():
    """JAX's two-device data mesh on the first two virtual CPU devices
    (``tests/conftest.py`` makes eight)."""
    return JMesh(data=2, devices=jax.devices()[:2])


def concurrently(fn, n):
    results = {}

    def call(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return results


# ------------------------------------------------------------------ modes
def test_batched_coalesces_and_matches_jax():
    """8 threads x 8 rows into one batched ParallelInference (batch_limit
    64): each caller gets its rows of the whole batch's output, as JAX's
    ParallelInference gives them; the dispatches carry more than one
    request; output after shutdown raises."""
    jnet, tnet = mlp_pair()
    x = blobs(64)
    jpi = JParallelInference.builder(jnet).batch_limit(64).build()
    pi = ParallelInference.builder(tnet).batch_limit(64).max_wait_ms(50).build()
    mine = concurrently(lambda i: pi.output(x[i * 8:(i + 1) * 8]), 8)
    theirs = concurrently(lambda i: jpi.output(x[i * 8:(i + 1) * 8]), 8)
    ref = tnet.output(x)
    for i in range(8):
        np.testing.assert_allclose(mine[i], np.asarray(theirs[i]), rtol=0, atol=TOL)
        np.testing.assert_allclose(mine[i], ref[i * 8:(i + 1) * 8], rtol=0, atol=TOL)
    snap = pi.metrics.snapshot()
    assert snap["dispatches"] < 8 and snap["requests"] == 8
    pi.shutdown()
    jpi.shutdown()
    with pytest.raises(RuntimeError):
        pi.output(x[:8])


@pytest.mark.parametrize("mode", ["sequential", "batched", "inplace"])
def test_modes_match_jax(mode):
    jnet, tnet = mlp_pair()
    x = blobs(32)
    jpi = JParallelInference.builder(jnet).inference_mode(mode).workers(3).build()
    pi = ParallelInference.builder(tnet).inference_mode(mode).workers(3).build()
    np.testing.assert_allclose(pi.output(x), np.asarray(jpi.output(x)), rtol=0, atol=TOL)
    np.testing.assert_allclose(pi.output(x), tnet.output(x), rtol=0, atol=TOL)
    pi.shutdown()
    jpi.shutdown()
    with pytest.raises(RuntimeError):
        pi.output(x)


def test_inplace_replicas_under_concurrent_callers():
    """``inplace`` with 4 replicas: replica 0 is the caller's model, the
    rest are clones with their own locks; 16 concurrent callers (more than
    the cores, the interpreter switching threads every microsecond) each get
    their own rows, equal to the model's output bit for bit."""
    jnet, tnet = pairs.pair("lenet")
    x = pairs.inputs("lenet", 32)
    pi = ParallelInference.builder(tnet).inference_mode("inplace").workers(4).build()
    assert len(pi._replicas) == 4 and pi._replicas[0] is tnet
    assert all(r is not tnet for r in pi._replicas[1:])
    assert len({id(lock) for lock in pi._replica_locks}) == 4
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = concurrently(lambda i: pi.output(x[i * 2:(i + 1) * 2]), 16)
    finally:
        sys.setswitchinterval(switch)
    assert sorted(out) == list(range(16))
    for i in range(16):
        rows = x[i * 2:(i + 1) * 2]
        assert np.array_equal(out[i], tnet.output(rows))
        np.testing.assert_allclose(out[i], np.asarray(jnet.output(rows)), rtol=0, atol=TOL)
    pi.shutdown()
    with pytest.raises(RuntimeError):
        pi.output(x[:4])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="inference mode"):
        ParallelInference(mlp_pair()[1], mode="spooky")


def test_batched_full_queue_and_timeout_are_typed():
    """While a dispatch is busy, a full queue raises ServerOverloadedError
    at once, and a caller's ``timeout`` raises RequestDeadlineExceeded;
    buckets=False pads nothing; the busy request is served after."""
    _, tnet = mlp_pair()
    ref = tnet.output(blobs(2))
    gate, started = threading.Event(), threading.Event()
    real = tnet.output

    def slow(x, mask=None):
        started.set()
        gate.wait(10)
        return real(x, mask=mask)

    tnet.output = slow
    pi = ParallelInference(tnet, mode="batched", batch_limit=2, queue_limit=1,
                           max_wait_ms=0.0, buckets=False)
    first = pi._batcher.submit(blobs(2))
    assert started.wait(10)  # the worker holds the first request
    queued = pi._batcher.submit(blobs(2))  # fills the one-slot queue
    with pytest.raises(ServerOverloadedError):
        pi.output(blobs(2))
    gate.set()
    np.testing.assert_allclose(first.result(10), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(queued.result(10), ref, rtol=0, atol=TOL)
    assert pi.metrics.snapshot()["dispatches"] == 2
    gate.clear()
    with pytest.raises(RequestDeadlineExceeded):
        pi.output(blobs(2), timeout=0.05)
    gate.set()
    pi.shutdown()


# ------------------------------------------------------------------ clone
def test_multilayer_clone_is_a_deep_copy():
    """The clone's output and params equal the source's; training the clone
    leaves the source untouched; counters and updater state carry over."""
    jnet, src = pairs.pair("lenet")
    x = pairs.inputs("lenet", 8)
    y = np.eye(10, dtype=np.float32)[np.arange(8) % 10]
    src.fit(TDataSet(x, y))
    c = src.clone()
    assert c.conf == src.conf and c.conf is not src.conf
    assert (c.iteration, c.epoch) == (src.iteration, src.epoch) == (1, 1)
    assert np.array_equal(c.params_flat(), src.params_flat())
    assert np.array_equal(c.opt_state_flat(), src.opt_state_flat())
    assert np.array_equal(c.output(x), src.output(x))
    before = src.params_flat().copy(), src.opt_state_flat().copy()
    c.fit(TDataSet(x, y), epochs=2)
    assert np.array_equal(src.params_flat(), before[0])
    assert np.array_equal(src.opt_state_flat(), before[1])
    assert not np.array_equal(c.params_flat(), before[0])


def test_graph_clone_is_a_deep_copy():
    conf = pairs.small_graph(PORT)
    g = TGraph(conf).init(device="cpu")
    x = np.random.default_rng(1).standard_normal((6, 6, 6, 2)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(6) % 4]
    g.fit(TDataSet(x, y))
    c = g.clone()
    assert (c.iteration, c.epoch) == (g.iteration, g.epoch)
    assert np.array_equal(c.params_flat(), g.params_flat())
    assert np.array_equal(c.opt_state_flat(), g.opt_state_flat())
    assert np.array_equal(c.output_single(x), g.output_single(x))
    before = g.params_flat().copy()
    c.fit(TDataSet(x, y))
    assert np.array_equal(g.params_flat(), before)
    assert not np.array_equal(c.params_flat(), before)
    assert TGraph(conf).clone().params_ is None


# -------------------------------------------------------- the shared engine
def test_two_device_engine_matches_jax_mesh_engine():
    """``devices=["cpu", "cpu"]`` against JAX's engine with
    ``TrainingMesh(data=2)``: the same bucket filter (bucket 1 dropped with
    a warning) and outputs within TOL at every bucket, ragged requests
    included; the dispatch is cut into two row blocks."""
    jnet, tnet = pairs.pair("lenet")
    x = pairs.inputs("lenet", 23, seed=4)
    with pytest.warns(UserWarning, match=r"dropping batch buckets \[1\]") as mine_w:
        eng = InferenceEngine(tnet, devices=["cpu", "cpu"])
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        jeng = JEngine(jnet, mesh=mesh2())
    assert eng.buckets.batch_buckets == jeng.buckets.batch_buckets == [2, 4, 8, 16, 32]
    assert str(mine_w[0].message) .replace("the 2 devices", "the mesh data axis (2)") == \
        str(theirs_w[0].message)
    blocks = []
    real = eng._forward_block
    eng._forward_block = lambda *a: blocks.append(a[3].shape[0]) or real(*a)
    for n in (1, 3, 8, 23):
        np.testing.assert_allclose(eng.infer(x[:n]), np.asarray(jeng.infer(x[:n])),
                                   rtol=0, atol=TOL)
    assert blocks == [1, 1, 2, 2, 4, 4, 16, 16]
    one = InferenceEngine(tnet, device="cpu")
    np.testing.assert_allclose(eng.infer(x), one.infer(x), rtol=0, atol=TOL)
    assert eng.describe()["devices"] == ["cpu", "cpu"]
    assert eng.warmup()["shapes"] == 5


def test_two_device_engine_refuses_buckets_it_cannot_split():
    jnet, tnet = mlp_pair()
    with pytest.raises(ValueError, match="divisible"):
        InferenceEngine(tnet, buckets=BucketPolicy(batch_buckets=[3, 5]), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        JEngine(jnet, buckets=JBuckets(batch_buckets=[3, 5]), mesh=mesh2())
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(tnet, device="cpu", devices=["cpu"])


def test_two_device_engine_reloads_and_serves_int8_on_every_replica(tmp_path):
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    _, tnet = pairs.pair("lenet")
    x = pairs.inputs("lenet", 8, seed=5)
    eng = InferenceEngine(tnet, buckets=[2, 8], devices=["cpu", "cpu"], int8_serving=True)
    one = InferenceEngine(tnet, buckets=[2, 8], device="cpu", int8_serving=True)
    np.testing.assert_allclose(eng.infer(x), one.infer(x), rtol=0, atol=TOL)
    assert all("W_q8" in rep[0][-1] for rep in eng._snap.replicas)
    path = str(tmp_path / "m.zip")
    tnet.params_[-1]["b"] = tnet.params_[-1]["b"] + 1.0
    ModelSerializer.write_model(tnet, path)
    assert eng.reload(path)["reloaded"] and one.reload(path)["reloaded"]
    np.testing.assert_allclose(eng.infer(x), one.infer(x), rtol=0, atol=TOL)


# ------------------------------------------------------------------- cli
def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                           "--model", "lenet", "--port", "0", "--smoke", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def test_cli_serve_workers_on_the_cpu():
    r = _cli("--workers", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "smoke: HTTP 200 ok" in r.stdout
    assert "on [cpu, cpu]" in r.stdout


def test_cli_serve_workers_without_enough_cards_is_typed():
    """``--workers 2`` on the default device (the card) where there is none:
    the typed error naming both counts, before any model loads."""
    r = _cli("--workers", "2", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "NotEnoughDevicesError" in r.stderr
    assert "2 workers need 2 CUDA cards" in r.stderr and "has 0" in r.stderr
    assert "serving" not in r.stdout
