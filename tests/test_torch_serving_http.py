"""The port's serving stack on the CPU against the JAX package's:
checkpoints into the engine, hot reload, ``InferenceServer`` over HTTP and
``cli serve``.

Answers are compared in f32 at 1e-5 on probabilities (f32 summation order
only; int8 heads run the same quantized weights in both packages). The
overload and deadline tests are driven by events and the observed queue
depth, never by sleeps: a dispatch held inside the engine fills the queue
deterministically.
"""

import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBuckets
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu.serving.server import InferenceServer as JServer
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import InferenceEngine, InferenceServer
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer
from tests.torch_mln_pairs import PORT, inputs, pair, small_graph

REPO = Path(__file__).resolve().parents[1]


def _http(port, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body)
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = dict(resp.getheaders())
        try:
            return resp.status, json.loads(raw), hdrs
        except ValueError:
            return resp.status, raw, hdrs
    finally:
        conn.close()


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


# ---------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def lenet_zips(tmp_path_factory):
    """Two JAX-written LeNet checkpoints (different weights) in one dir."""
    d = tmp_path_factory.mktemp("ckpts")
    nets = []
    for i, scale in enumerate((4.0, 2.0)):
        jnet, _ = pair("lenet", head_scale=scale)
        path = str(d / f"checkpoint_{i}.zip")
        JSer.write_model(jnet, path)
        os.utime(path, (1_000_000 + i, 1_000_000 + i))  # mtime order = age
        nets.append((jnet, path))
    return d, nets


def test_jax_zip_serves_int8_like_the_jax_engine(lenet_zips):
    _, nets = lenet_zips
    jnet, path = nets[0]
    x = inputs("lenet", 3, seed=11)
    want = JEngine.from_checkpoint(path, buckets=JBuckets(batch_buckets=[4]),
                                   int8_serving=True).infer(x)
    eng = InferenceEngine.from_checkpoint(path, buckets=[4], int8_serving=True,
                                          device="cpu")
    np.testing.assert_allclose(eng.infer(x), want, rtol=0, atol=1e-5)
    desc = eng.describe()
    assert desc["source"] == path and desc["checkpoint_fingerprint"] is not None
    assert desc["int8_report"]["layers_quantized"] == 2
    # the model object keeps its f32 weights
    assert "W" in eng.model.params_[4] and "W_q8" not in eng.model.params_[4]


def test_directory_with_a_truncated_decoy_serves_the_valid_zip(lenet_zips, tmp_path):
    d, nets = lenet_zips
    ckdir = tmp_path / "dir"
    ckdir.mkdir()
    good = ckdir / "checkpoint_a.zip"
    good.write_bytes(Path(nets[1][1]).read_bytes())
    os.utime(good, (1_000_000, 1_000_000))
    decoy = ckdir / "checkpoint_b.zip"
    data = Path(nets[0][1]).read_bytes()
    decoy.write_bytes(data[: len(data) // 2])  # newer, truncated
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        eng = InferenceEngine.from_checkpoint(str(ckdir), buckets=[4], device="cpu")
    assert eng.describe()["source"] == str(good)
    assert eng.checkpoint_dir == str(ckdir)
    # an explicit invalid zip falls back to its newest valid sibling
    with pytest.warns(UserWarning):
        eng2 = InferenceEngine.from_checkpoint(str(decoy), buckets=[4], device="cpu")
    assert eng2.describe()["source"] == str(good)
    x = inputs("lenet", 2, seed=12)
    np.testing.assert_allclose(eng.infer(x), np.asarray(nets[1][0].output(x)),
                               rtol=0, atol=1e-5)


def test_reload_is_a_noop_when_unchanged_and_swaps_otherwise(lenet_zips, tmp_path):
    _, nets = lenet_zips
    path = str(tmp_path / "live.zip")
    Path(path).write_bytes(Path(nets[0][1]).read_bytes())
    eng = InferenceEngine.from_checkpoint(path, buckets=[4], int8_serving=True,
                                          device="cpu")
    eng.warmup()
    x = inputs("lenet", 2, seed=13)
    before = eng.infer(x)
    assert eng.reload(path) == {"reloaded": False, "version": 0, "path": path,
                                "reason": "unchanged"}
    Path(path + ".new").write_bytes(Path(nets[1][1]).read_bytes())
    os.replace(path + ".new", path)
    rep = eng.reload(path)
    assert rep["reloaded"] and rep["version"] == 1 and rep["same_arch"]
    after = eng.infer(x)
    assert float(np.abs(after - before).max()) > 1e-3
    np.testing.assert_allclose(after, JEngine.from_checkpoint(
        nets[1][1], buckets=JBuckets(batch_buckets=[4]), int8_serving=True).infer(x),
        rtol=0, atol=1e-5)
    assert eng.metrics.reloads == 1
    # a different architecture builds (and warms) a new snapshot
    other = str(tmp_path / "vgg.zip")
    JSer.write_model(pair("narrow_vgg")[0], other)
    rep = eng.reload(other)
    assert rep["version"] == 2 and not rep["same_arch"]
    assert eng.infer(inputs("narrow_vgg", 2)).shape == (2, 10)


def test_int8_reload_of_a_graph_is_refused_and_keeps_serving(tmp_path, lenet_zips):
    _, nets = lenet_zips
    eng = InferenceEngine.from_checkpoint(nets[0][1], buckets=[4], int8_serving=True,
                                          device="cpu")
    g = ComputationGraph(small_graph(PORT)).init(device="cpu")
    path = str(tmp_path / "graph.zip")
    ModelSerializer.write_model(g, path)
    with pytest.raises(TypeError, match="MultiLayerNetwork"):
        eng.reload(path)
    assert eng.model_version == 0
    assert eng.infer(inputs("lenet", 1)).shape == (1, 10)


# ---------------------------------------------------------------------- HTTP
@pytest.fixture
def servers():
    """The port's server and the JAX server over the same LeNet weights,
    both with int8 heads."""
    jnet, tnet = pair("lenet")
    js = JServer(JEngine(jnet, buckets=JBuckets(batch_buckets=[1, 8]), int8_serving=True),
                 port=0).start()
    ts = InferenceServer(InferenceEngine(tnet, buckets=[1, 8], device="cpu",
                                         int8_serving=True), port=0).start()
    yield js, ts
    ts.shutdown()
    js.shutdown()


def test_predict_routes_answer_like_the_jax_server(servers):
    js, ts = servers
    x = inputs("lenet", 5, seed=14)
    for path, body in (("/predict", {"inputs": x[:1].tolist()}),
                       ("/predict_npy", _npy(x))):
        answers = []
        for port in (js.port, ts.port):
            code, out, _ = _http(port, "POST", path, body)
            assert code == 200, out
            answers.append(np.asarray(out["outputs"]) if isinstance(out, dict)
                           else np.load(io.BytesIO(out)))
        np.testing.assert_allclose(answers[1], answers[0], rtol=0, atol=1e-5)
    code, out, _ = _http(ts.port, "POST", "/predict", {"inputs": x[:2].tolist()})
    assert code == 200 and out["model_version"] == 0 and len(out["outputs"]) == 2


def test_healthz_and_metrics(servers):
    _, ts = servers
    x = inputs("lenet", 3, seed=15)
    for _ in range(2):
        assert _http(ts.port, "POST", "/predict_npy", _npy(x))[0] == 200
    code, h, _ = _http(ts.port, "GET", "/healthz")
    assert code == 200 and h["status"] == "ok" and h["int8_serving"] is True
    assert h["int8_report"]["layers_quantized"] == 2 and h["snapshot_version"] == 0
    assert h["model_type"] == "MultiLayerNetwork" and h["device"] == "cpu"
    code, m, _ = _http(ts.port, "GET", "/metrics")
    assert code == 200 and m["requests"] == 2 and m["examples"] == 6
    assert m["bucket_hits"] == {"8": 2} and m["pad_waste"]["8"]["real"] == 6
    code, text, hdrs = _http(ts.port, "GET", "/metrics",
                             headers={"Accept": "text/plain"})
    assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
    assert b"serving_requests_total 2" in text


def test_bad_payloads_are_400_and_unported_routes_404(servers):
    _, ts = servers
    assert _http(ts.port, "POST", "/predict", b"not json")[0] == 400
    assert _http(ts.port, "POST", "/predict", {"x": 1})[0] == 400
    assert _http(ts.port, "POST", "/predict_npy", b"junk")[0] == 400
    code, body, _ = _http(ts.port, "POST", "/predict", {"inputs": [[1.0, 2.0]]})
    assert code == 400 and "(28, 28, 1)" in body["message"]
    for method, path in (("GET", "/alerts"), ("GET", "/trace"),
                         ("GET", "/debug/flight"), ("POST", "/models/m/predict")):
        code, body, _ = _http(ts.port, method, path)
        assert code == 404 and "ROADMAP" in body["message"]
    # the server was started without a generation engine
    code, body, _ = _http(ts.port, "POST", "/generate", {"prompt": [1]})
    assert code == 409 and "--gen-slots" in body["message"]
    assert _http(ts.port, "GET", "/nowhere")[0] == 404


def _held(engine):
    """Wrap ``engine.infer_versioned`` so a dispatch blocks inside the
    engine until released; returns (entered, release)."""
    entered, release = threading.Event(), threading.Event()
    real = engine.infer_versioned

    def blocking(x):
        entered.set()
        assert release.wait(30)
        return real(x)

    engine.infer_versioned = blocking
    return entered, release


def test_overload_is_503_with_retry_after():
    _, tnet = pair("lenet")
    eng = InferenceEngine(tnet, buckets=[1], device="cpu")
    srv = InferenceServer(eng, port=0, batch_limit=1, max_wait_ms=0,
                          queue_limit=1).start()
    entered, release = _held(eng)
    x = inputs("lenet", 1).tolist()
    codes = []
    held = [threading.Thread(target=lambda: codes.append(
        _http(srv.port, "POST", "/predict", {"inputs": x})[0])) for _ in range(2)]
    try:
        held[0].start()
        assert entered.wait(30)  # the worker is blocked inside the dispatch
        held[1].start()
        deadline = time.monotonic() + 30
        while srv.queue_depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.queue_depth() == 1
        code, body, hdrs = _http(srv.port, "POST", "/predict", {"inputs": x})
        assert code == 503 and body["error"] == "ServerOverloadedError"
        assert int(hdrs["Retry-After"]) >= 1
    finally:
        release.set()
        for t in held:
            t.join(timeout=30)
        srv.shutdown()
    assert codes == [200, 200] and eng.metrics.rejects == 1


def test_deadline_is_504():
    _, tnet = pair("lenet")
    eng = InferenceEngine(tnet, buckets=[1], device="cpu")
    srv = InferenceServer(eng, port=0, batch_limit=1, max_wait_ms=0).start()
    entered, release = _held(eng)
    try:
        code, body, _ = _http(srv.port, "POST", "/predict",
                              {"inputs": inputs("lenet", 1).tolist(), "timeout_ms": 50})
        assert entered.is_set()
        assert code == 504 and body["error"] == "RequestDeadlineExceeded"
    finally:
        release.set()
        srv.shutdown()


def test_reload_over_http(lenet_zips, tmp_path):
    _, nets = lenet_zips
    path = str(tmp_path / "live.zip")
    Path(path).write_bytes(Path(nets[0][1]).read_bytes())
    srv = InferenceServer(InferenceEngine.from_checkpoint(path, buckets=[1], device="cpu"),
                          port=0).start()
    try:
        x = {"inputs": inputs("lenet", 1, seed=16).tolist()}
        a = _http(srv.port, "POST", "/predict", x)[1]
        code, rep, _ = _http(srv.port, "POST", "/reload", {"path": nets[1][1]})
        assert code == 200 and rep["reloaded"] and rep["version"] == 1
        b = _http(srv.port, "POST", "/predict", x)[1]
        assert b["model_version"] == 1
        assert np.abs(np.asarray(a["outputs"]) - np.asarray(b["outputs"])).max() > 1e-3
        assert _http(srv.port, "POST", "/reload", {"path": str(tmp_path / "no.zip")})[0] == 409
    finally:
        srv.shutdown()


# ------------------------------------------------------------------------ CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                           *args], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=240)


def test_cli_serve_smoke_on_the_cpu(lenet_zips):
    r = _cli("--model", "lenet", "--device", "cpu", "--port", "0", "--smoke",
             "--int8-serving")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "smoke: HTTP 200 ok" in r.stdout and "layers_quantized" in r.stdout
    d, _ = lenet_zips
    r = _cli("--model", str(d), "--device", "cpu", "--port", "0", "--smoke",
             "--buckets", "1,2", "--no-warmup")
    assert r.returncode == 0 and "smoke: HTTP 200 ok" in r.stdout, r.stderr[-2000:]


def test_cli_refuses_int8_for_a_zoo_model_that_declares_it_intolerant(monkeypatch, capsys):
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models import LeNet

    monkeypatch.setattr(LeNet, "serving_int8", False)
    with pytest.raises(SystemExit) as e:
        cli.serve_main(["--model", "lenet", "--device", "cpu", "--int8-serving",
                        "--port", "0", "--smoke"])
    assert e.value.code == 2 and "serving_int8=False" in capsys.readouterr().err


def test_cli_refuses_unported_flags_and_the_default_device_without_a_card():
    r = _cli("--model", "lenet", "--mesh", "2x4")
    assert r.returncode == 2 and "ROADMAP" in r.stderr
    r = _cli("--model", "lenet", "--port", "0", "--smoke")
    assert r.returncode != 0 and "DeviceUnavailableError" in r.stderr
