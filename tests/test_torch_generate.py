"""The port's generation path against the JAX package on the CPU: the
sampler, the continuous-batching ``GenerationEngine`` on a narrow
TextGenerationLSTM (12 classes, 16 units, weights carried from JAX), the
seq-bucketed ``InferenceEngine``, ``POST /generate`` and ``cli serve
--gen-slots``.

- ``_filter_logits``: temperature and top-k equal JAX's (the same f32
  divide and compares); top-p may differ only where a cutoff falls on a tie
  (``transformer_lm.py:310-315``), asserted as such.
- Greedy tokens are identical to JAX's ``GenerationEngine`` and to a host
  loop of full forwards (``test_generate.py:547-574``).
- Sampled tokens are not compared with JAX: JAX's threefry key stream cannot
  be reproduced in torch. Each slot draws from its own counter-based
  generator on the device, seeded from the request's seed, so the same seed
  gives the same tokens, and a slot decoded among others equals the same
  request decoded alone, greedy and sampled.
- The seq-bucketed engine and its int8 heads equal JAX's engines within
  1e-5 (f32 order).
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.models.textgen_lstm import TextGenerationLSTM as JTextGen
from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBuckets
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu.serving.generate import GenerationEngine as JGenEngine
from deeplearning4j_tpu.serving.generate import generation_memory_report as j_mem
from deeplearning4j_tpu_torch.interop import export_serving_params, load_jax_params
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from deeplearning4j_tpu_torch.models import transformer_lm as tlm
from deeplearning4j_tpu_torch.serving import (
    BucketPolicy,
    InferenceEngine,
    InferenceServer,
    RequestDeadlineExceeded,
    ServerOverloadedError,
    ServerShutdownError,
)
from deeplearning4j_tpu_torch.serving.generate import (
    GenerationEngine,
    GenerationNotPortedError,
    generation_memory_report,
)
from tests.torch_mln_pairs import numpy_tree, pair

REPO = Path(__file__).resolve().parents[1]
V, UNITS = 12, 16


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net on the CPU) with the same weights: seeded, with
    live peepholes and biases, a stronger recurrence and a spread softmax, so
    greedy sequences do not collapse to one repeated token."""
    jnet = JTextGen(num_classes=V, units=UNITS).init()
    params = numpy_tree(jnet.params_)
    rng = np.random.default_rng(4)
    for p in params[:2]:
        p["Wh"] = p["Wh"] * np.float32(3.0)
        for k in ("b", "pI", "pF", "pO"):
            p[k] = (p[k] + rng.standard_normal(p[k].shape) * 0.5).astype(np.float32)
    params[-1]["W"] = params[-1]["W"] * np.float32(4.0)
    jnet.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TextGenerationLSTM(num_classes=V, units=UNITS).init(device="cpu")
    load_jax_params(tnet, params, numpy_tree(jnet.state_))
    return jnet, tnet


def _cases(n, seed, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (int(rng.integers(lo, hi)),)).astype(np.int32),
             int(rng.integers(3, 12))) for _ in range(n)]


def _engine(net, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_length", 64)
    kw.setdefault("prefill_buckets", [8, 16, 32])
    kw.setdefault("default_timeout_s", 90.0)
    return GenerationEngine(net, **kw)


def _host_greedy(net, prompt, max_new):
    """The oracle: a full forward over the whole sequence per token."""
    seq = [int(t) for t in prompt]
    for _ in range(max_new):
        y = net.output(np.eye(V, dtype=np.float32)[seq][None])
        seq.append(int(np.asarray(y)[0, -1].argmax()))
    return np.asarray(seq, np.int32)


# ---------------------------------------------------------------- the sampler
def _logits(b=6, seed=0):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((b, 20)).astype(np.float32) * 2
    lg[1, 3] = lg[1, 7]  # a tie
    return lg


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, top_k=0, top_p=0.0), dict(temperature=1.0, top_k=5, top_p=0.0),
    dict(temperature=1.3, top_k=1, top_p=0.0), dict(temperature=0.0, top_k=0, top_p=0.0),
    dict(temperature=[0.5, 1.0, 2.0, 0.0, 1.0, 0.8], top_k=[0, 3, 20, 0, 7, 2],
         top_p=[0.0] * 6)], ids=["temp", "topk", "top1", "greedy", "per-row"])
def test_filter_logits_equals_jax(knobs):
    lg = _logits()
    jk = {k: jnp.asarray(v) for k, v in knobs.items()}
    tk = {k: torch.as_tensor(v) for k, v in knobs.items()}
    got = tlm._filter_logits(torch.from_numpy(lg), **tk).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlm._filter_logits(jnp.asarray(lg), **jk)))


@pytest.mark.parametrize("top_p", [0.3, 0.9, [0.5, 0.95, 0.1, 1.0, 0.7, 0.2]])
def test_filter_logits_top_p_differs_only_at_cutoff_ties(top_p):
    lg = _logits(seed=1)
    t = np.full(6, 0.9, np.float32)
    got = tlm._filter_logits(torch.from_numpy(lg), torch.from_numpy(t), torch.zeros(6, dtype=torch.int64),
                             torch.as_tensor(top_p, dtype=torch.float32)).numpy()
    want = np.asarray(jlm._filter_logits(jnp.asarray(lg), jnp.asarray(t), jnp.zeros(6, jnp.int32),
                                         jnp.asarray(top_p, jnp.float32)))
    kept, kept_j = np.isfinite(got), np.isfinite(want)
    np.testing.assert_array_equal(got[kept & kept_j], want[kept & kept_j])
    for r in np.nonzero((kept != kept_j).any(1))[0]:
        # a differing row keeps the same count, and the swapped entries tie
        assert kept[r].sum() == kept_j[r].sum()
        vals = (lg[r] / t[r])
        assert set(vals[kept[r] & ~kept_j[r]]) == set(vals[kept_j[r] & ~kept[r]])


def test_sampler_rows_are_independent_and_seeded():
    lg = torch.from_numpy(_logits(b=5, seed=2))
    lg[4] = lg[1]
    t = torch.tensor([0.0, 0.8, 1.0, 1.5, 0.8])
    k = torch.tensor([0, 20, 4, 0, 20])
    p = torch.tensor([0.0, 0.95, 0.0, 0.9, 0.95])
    keys = torch.stack([tlm.new_key(s) for s in (7, 8, 9, 10, 8)])
    a, ka = tlm.sample_next_rows(lg, t, k, p, keys)
    b, _ = tlm.sample_next_rows(lg, t, k, p, keys)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(ka[:, 1], keys[:, 1] + 1) and torch.equal(ka[:, 0], keys[:, 0])
    assert int(a[0]) == int(lg[0].argmax())  # greedy row
    assert int(a[1]) == int(a[4])  # same seed, same row, same policy
    for s in range(5):
        solo, key = tlm.sample_next_device(lg[s:s + 1], t[s], k[s], p[s], keys[s])
        assert int(solo[0]) == int(a[s]) and torch.equal(key, ka[s])
    top4 = set(torch.topk(lg[2], 4).indices.tolist())
    draws = set()
    key = keys[2]
    for _ in range(200):
        tok, key = tlm.sample_next_device(lg[2:3], 1.0, 4, 0.0, key)
        draws.add(int(tok[0]))
    assert draws <= top4 and len(draws) > 1


@pytest.mark.parametrize("max_length,hint", [(256, None), (64, (8, 16, 32, 64)),
                                             (100, (16, 200, 32)), (8, None), (5, (8,))])
def test_prefill_bucket_lengths_equal_jax(max_length, hint):
    assert tlm.prefill_bucket_lengths(max_length, hint) == \
        jlm.prefill_bucket_lengths(max_length, hint)


# ----------------------------------------------------------------- the engine
def test_greedy_tokens_equal_jax_engine_and_host_loop(nets):
    jnet, tnet = nets
    cases = _cases(6, seed=2)
    je = JGenEngine(jnet, n_slots=3, max_length=64, prefill_buckets=[8, 16, 32],
                    default_timeout_s=90.0)
    te = _engine(tnet)
    try:
        want = [je.submit(p, max_new=m).result(90) for p, m in cases]
        reqs = [te.submit(p, max_new=m) for p, m in cases]
        got = [r.result(90) for r in reqs]
    finally:
        je.shutdown()
        te.shutdown()
    distinct = set()
    for (p, m), g, w in zip(cases, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _host_greedy(tnet, p, m))
        distinct |= set(g[len(p):].tolist())
    assert len(distinct) > 2  # the sequences are not one repeated token
    assert te.backend.cell_path and te.backend.kind == "recurrent"


def _run(engine, cases, **kw):
    try:
        reqs = [engine.submit(p, max_new=m, **kw) for p, m in cases]
        return [r.result(90) for r in reqs]
    finally:
        engine.shutdown()


SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.95, seed=3)


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_cell_path_equals_the_forward_path(nets, knobs):
    _, tnet = nets
    cases = _cases(5, seed=6)
    cell = _engine(tnet)
    legacy = _engine(tnet)
    legacy.backend.cell_path = False  # the path of a stack the cell path refuses
    assert cell.backend.cell_path
    a = _run(cell, cases, **knobs)
    b = _run(legacy, cases, **knobs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_slot_among_others_equals_the_request_alone(nets, knobs):
    _, tnet = nets
    cases = _cases(7, seed=9)
    crowd = _run(_engine(tnet, n_slots=4), cases, **knobs)
    for (p, m), c in zip(cases, crowd):
        alone = _run(_engine(tnet, n_slots=1), [(p, m)], **knobs)[0]
        np.testing.assert_array_equal(c, alone)
    if knobs:  # another seed draws other tokens
        other = _run(_engine(tnet), cases, **{**knobs, "seed": 4})
        assert any(not np.array_equal(a, b) for a, b in zip(crowd, other))


def test_stream_warmup_describe_and_metrics(nets):
    _, tnet = nets
    eng = _engine(tnet, n_slots=2)
    try:
        rep = eng.warmup()
        assert rep["buckets"] == [8, 16, 32, 64]
        req = eng.submit(np.array([1, 2, 3]), max_new=5)
        assert list(req.stream(timeout=60)) == req.tokens and len(req.tokens) == 5
        d = eng.describe()
        assert d["backend"] == "recurrent" and d["decode_cell_path"] is True
        assert d["n_slots"] == 2 and d["prefill_buckets"] == [8, 16, 32, 64]
        snap = eng.metrics.snapshot()
        assert snap["tokens"] == 5 and snap["prefills"] == 1 and snap["decode_steps"] == 4
    finally:
        eng.shutdown()
    assert eng.inflight() == 0


def _hold(engine):
    """Hold the engine's device lock once its worker has parked the queued
    request at the lock; returns the lock's release."""
    engine._dev_lock.acquire()
    return engine._dev_lock.release


def _wait_depth(engine, n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if engine.queue_depth() == n:
            time.sleep(0.1)
            if engine.queue_depth() == n:
                return
        time.sleep(0.01)
    raise AssertionError(f"queue depth {engine.queue_depth()} != {n}")


def test_typed_errors(nets):
    jnet, tnet = nets
    eng = _engine(tnet, n_slots=1, queue_limit=1, max_length=32)
    release = _hold(eng)
    try:
        first = eng.submit([1, 2], max_new=3)
        _wait_depth(eng, 1)
        with pytest.raises(ServerOverloadedError) as e:
            eng.submit([1, 2], max_new=3)
        assert e.value.retry_after_s >= 1.0 and eng.metrics.rejects == 1
    finally:
        release()
    assert len(first.result(60)) == 5
    with pytest.raises(tlm.ContextWindowExceeded) as w:
        eng.submit(np.zeros(30, np.int32), max_new=3)
    assert (w.value.prompt_len, w.value.max_new, w.value.max_length) == (30, 3, 32)
    for bad in (dict(prompt_ids=[]), dict(prompt_ids=[1], max_new=0),
                dict(prompt_ids=[V]), dict(prompt_ids=[1], top_k=3)):
        with pytest.raises(ValueError):
            eng.submit(**{"max_new": 2, **bad})
    # a deadline that passes while queued, and one mid-decode
    release = _hold(eng)
    try:
        late = eng.submit([1], max_new=3, timeout=0.05)
        time.sleep(0.2)
    finally:
        release()
    with pytest.raises(RequestDeadlineExceeded):
        late.result(60)
    decode = eng.backend.decode

    def slow_decode(*args):
        time.sleep(0.05)
        return decode(*args)

    eng.backend.decode = slow_decode
    slow = eng.submit([1], max_new=30, timeout=0.3)
    with pytest.raises(RequestDeadlineExceeded):
        slow.result(60)
    assert 0 < len(slow.tokens) < 30  # it died mid-decode
    assert eng.metrics.deadline_exceeded >= 1
    eng.shutdown()
    with pytest.raises(ServerShutdownError):
        eng.submit([1], max_new=2)
    # shutdown without drain fails what is active and queued
    eng2 = _engine(tnet, n_slots=1)
    release = _hold(eng2)
    queued = eng2.submit([1], max_new=5)
    release()
    eng2.shutdown(drain=False)
    with pytest.raises(ServerShutdownError):
        queued.result(60)


def test_unsupported_models_and_features_are_refused(nets):
    _, tnet = nets
    _, lenet = pair("lenet")
    with pytest.raises(TypeError, match="incremental-decode"):
        GenerationEngine(lenet, n_slots=1)
    # a TransformerLM decodes through the KV-cache backend
    # (test_torch_generate_transformer.py); its MoE form is not ported
    with pytest.raises(GenerationNotPortedError, match="ROADMAP"):
        GenerationEngine(tlm.TransformerLM(vocab_size=16, d_model=16, n_heads=2, n_layers=1,
                                           n_experts=2), n_slots=1)
    with pytest.raises(TypeError, match="incremental-decode"):  # the reference's model
        GenerationEngine(jlm.TransformerLM(vocab_size=16, d_model=16, n_heads=2, n_layers=1),
                         n_slots=1)
    with pytest.raises(GenerationNotPortedError, match="ROADMAP"):
        _engine(tnet, spec_decode_k=2)
    with pytest.raises(GenerationNotPortedError, match="ROADMAP"):
        _engine(tnet, prefix_cache_mb=1.0)
    with pytest.raises(Exception, match="budget"):
        _engine(tnet, memory_limit_bytes=1000)


@pytest.mark.parametrize("n_slots,max_length", [(1, None), (32, 256), (7, 40)])
def test_memory_report_equals_jax(nets, n_slots, max_length):
    jnet, tnet = nets
    assert generation_memory_report(tnet, n_slots, max_length) == \
        j_mem(jnet, n_slots, max_length)
    full_j = JTextGen().init()
    full_t = TextGenerationLSTM().init(device="cpu")
    assert generation_memory_report(full_t, n_slots, max_length) == \
        j_mem(full_j, n_slots, max_length)
    # the training estimate too (RmsProp's one slot per param)
    from deeplearning4j_tpu.nn.conf.memory import memory_report_mln as j_report
    from deeplearning4j_tpu_torch.nn.conf.memory import memory_report_mln

    assert memory_report_mln(full_t.conf).total_memory_bytes(n_slots) == \
        j_report(full_j.conf).total_memory_bytes(n_slots)


# ---------------------------------------------------- seq-bucketed /predict
SEQ = [4, 8]


def _seq_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]
            for b, t in ((1, 3), (2, 8), (3, 5), (1, 11))]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_seq_bucketed_engine_equals_jax(nets, int8):
    jnet, tnet = nets
    buckets = dict(batch_buckets=[1, 4], seq_buckets=SEQ)
    te = InferenceEngine(tnet, buckets=BucketPolicy(**buckets), device="cpu",
                         int8_serving=int8)
    je = JEngine(jnet, buckets=JBuckets(**buckets), int8_serving=int8)
    if int8:
        assert te.int8_report == je.int8_report and te.int8_report["layers_quantized"] == 1
        heads = export_serving_params(te)[-1]
        assert set(heads) == {"W_q8", "W_scale", "b"}
        np.testing.assert_array_equal(heads["W_q8"], np.asarray(je._snap.params[-1]["W_q8"]))
    for x in _seq_inputs():
        got = te.infer(x)
        assert got.shape == x.shape[:2] + (V,)
        np.testing.assert_allclose(got, np.asarray(je.infer(x)), rtol=0, atol=1e-5)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0
    x = _seq_inputs()[1]
    np.testing.assert_allclose(te.infer(x, mask), np.asarray(je.infer(x, mask)),
                               rtol=0, atol=1e-5)
    if not int8:  # padding to the bucket changes nothing: 3 steps padded to 4, masked
        np.testing.assert_allclose(te.infer(x[:1, :3]), tnet.output(x[:1, :3]),
                                   rtol=0, atol=1e-6)
    # the 11-step request grew a seq bucket of 16
    assert te.buckets.seq_buckets == [4, 8, 16] and te.warmup()["shapes"] == 6
    with pytest.raises(ValueError, match="sequences"):
        te.infer(np.zeros((1, 3, V + 1), np.float32))


def test_seq_bucket_policy_matches_the_reference():
    mine, ref = BucketPolicy(max_batch=4, seq_buckets=SEQ), JBuckets(max_batch=4, seq_buckets=SEQ)
    for b, t in ((1, 3), (3, 4), (4, 9), (2, 20)):
        x = np.ones((b, t, 2), np.float32)
        for mask in (None, np.ones((b, t), np.float32)):
            got, want = mine.pad_batch(x, mask), ref.pad_batch(x, mask)
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g, w)
            assert got[2] == want[2]
    assert mine.seq_buckets == ref.seq_buckets and mine.warmup_shapes((1, 2)) == \
        ref.warmup_shapes((1, 2))


# ------------------------------------------------------------------------ HTTP
def _http(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else (body if isinstance(body, bytes)
                                          else json.dumps(body).encode())
        conn.request(method, path, data)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, dict(resp.getheaders())
    finally:
        conn.close()


@pytest.fixture
def server(nets):
    _, tnet = nets
    eng = InferenceEngine(tnet, buckets=BucketPolicy(batch_buckets=[1, 4], seq_buckets=SEQ),
                          device="cpu")
    gen = _engine(tnet, n_slots=2, queue_limit=1)
    srv = InferenceServer(eng, port=0, generation=gen).start()
    yield srv
    srv.shutdown()


def test_generate_over_http(server, nets):
    _, tnet = nets
    p = [3, 1, 4, 1, 5]
    want = _run(_engine(tnet), [(p, 6)])[0]
    code, raw, _ = _http(server.port, "POST", "/generate",
                         {"prompt": p, "max_new": 6, "stream": False})
    body = json.loads(raw)
    assert code == 200 and body["sequence"] == want.tolist() and body["prompt_len"] == 5
    code, raw, hdrs = _http(server.port, "POST", "/generate", {"prompt": p, "max_new": 6})
    lines = [json.loads(line) for line in raw.decode().splitlines() if line]
    assert code == 200 and hdrs["Content-Type"] == "application/x-ndjson"
    assert [d["token"] for d in lines[:-1]] == want[5:].tolist() and lines[-1]["done"]
    h = json.loads(_http(server.port, "GET", "/healthz")[1])
    assert h["generation"]["backend"] == "recurrent" and h["generation_inflight"] == 0
    m = json.loads(_http(server.port, "GET", "/metrics")[1])
    assert m["generation"]["tokens"] == 12 and m["generation"]["requests"] == 2


def test_generate_http_errors(server):
    assert _http(server.port, "POST", "/generate", b"not json")[0] == 400
    assert _http(server.port, "POST", "/generate", {"max_new": 2})[0] == 400
    code, raw, _ = _http(server.port, "POST", "/generate",
                         {"prompt": [1] * 60, "max_new": 10, "stream": False})
    assert code == 400 and json.loads(raw)["error"] == "ContextWindowExceeded"
    release = _hold(server.generation)
    codes = []
    t = threading.Thread(target=lambda: codes.append(_http(
        server.port, "POST", "/generate", {"prompt": [1], "max_new": 2, "stream": False})[0]))
    try:
        t.start()
        _wait_depth(server.generation, 1)
        code, raw, hdrs = _http(server.port, "POST", "/generate",
                                {"prompt": [1], "max_new": 2, "stream": False})
        assert code == 503 and json.loads(raw)["error"] == "ServerOverloadedError"
        assert int(hdrs["Retry-After"]) >= 1
    finally:
        release()
        t.join(timeout=60)
    assert codes == [200]
    code, raw, _ = _http(server.port, "POST", "/generate",
                         {"prompt": [1], "max_new": 40, "timeout_ms": 1, "stream": False})
    assert code == 504


def test_generate_without_an_engine_is_409(nets):
    _, tnet = nets
    srv = InferenceServer(InferenceEngine(tnet, buckets=[1], device="cpu"), port=0).start()
    try:
        code, raw, _ = _http(srv.port, "POST", "/generate", {"prompt": [1]})
        assert code == 409 and json.loads(raw)["error"] == "NoGenerationEngine"
    finally:
        srv.shutdown()


def test_seq_bucketed_predict_over_http_equals_engine_infer(server):
    x = _seq_inputs(seed=3)[2]
    code, raw, _ = _http(server.port, "POST", "/predict", {"inputs": x.tolist()})
    assert code == 200
    np.testing.assert_array_equal(np.asarray(json.loads(raw)["outputs"], np.float32),
                                  server.engine.infer(x))
    mask = np.ones(x.shape[:2], np.float32)
    mask[0, 2:] = 0
    code, raw, _ = _http(server.port, "POST", "/predict",
                         {"inputs": x.tolist(), "mask": mask.tolist()})
    np.testing.assert_array_equal(np.asarray(json.loads(raw)["outputs"], np.float32),
                                  server.engine.infer(x, mask))


def test_cli_serve_textgenlstm_with_gen_slots_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                        "--model", "textgenlstm", "--device", "cpu", "--gen-slots", "2",
                        "--port", "0", "--smoke"], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "smoke: HTTP 200 ok" in r.stdout and "smoke: generate HTTP 200 ok" in r.stdout
    assert "seq=[8, 16, 32, 64]" in r.stdout
    r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                        "--model", "textgenlstm", "--device", "cpu", "--gen-slots", "2",
                        "--spec-decode-k", "2"], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 2 and "ROADMAP" in r.stderr
