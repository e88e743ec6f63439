"""TransformerLM generation and serving in the port against the JAX package
on the CPU: a TransformerLM of vocab 64, d 32, 4 heads, 2 layers,
max_length 256, f32, params carried from JAX (the head scaled so the
softmax is spread).

- ``GenerationEngine`` greedy tokens on a mixed-length storm (prompts of 1
  to 200 tokens, buckets below and above 128) equal JAX's engine's
  (``tests/test_generate.py:190-209`` is the oracle) and ``generate_cached``.
- Sampled tokens are the port's own (a counter-based generator per slot):
  the same seed gives the same tokens, and a slot among others equals the
  request alone.
- ``generation_memory_report`` equals JAX's; ``describe()`` names the
  backend; typed refusals.
- ``POST /generate`` over HTTP equals ``engine.submit``; ``/predict`` of
  token ids equals the engine, and ``InferenceEngine(TransformerLM)`` equals
  JAX's engine within 1e-5.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBuckets
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu.serving.generate import GenerationEngine as JGenEngine
from deeplearning4j_tpu.serving.generate import generation_memory_report as j_mem
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.models.transformer_lm import ContextWindowExceeded
from deeplearning4j_tpu_torch.serving import InferenceEngine, InferenceServer
from deeplearning4j_tpu_torch.serving.generate import (
    GenerationEngine,
    GenerationNotPortedError,
    generation_memory_report,
)

V = 64
CONF = dict(vocab_size=V, d_model=32, n_heads=4, n_layers=2, max_length=256)


@pytest.fixture(scope="module")
def lms():
    jm = jlm.TransformerLM(**CONF).init()
    params = jax.tree_util.tree_map(np.asarray, jm.params_)
    params["head"] = params["head"] * np.float32(3.0)
    jm.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tm = TransformerLM(**CONF).init(device="cpu")
    load_jax_params(tm, params, None)
    return jm, tm


def _cases(n, seed):
    rng = np.random.default_rng(seed)
    lengths = [1, 5, 17, 127, 128, 129, 200][:n]
    return [(rng.integers(0, V, int(t)).astype(np.int32), int(rng.integers(3, 12)))
            for t in lengths]


def _engine(model, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("default_timeout_s", 120.0)
    return GenerationEngine(model, **kw)


def _run(engine, cases, **kw):
    try:
        reqs = [engine.submit(p, max_new=m, **kw) for p, m in cases]
        return [r.result(120) for r in reqs]
    finally:
        engine.shutdown()


def test_greedy_storm_equals_jax_engine_and_generate_cached(lms):
    jm, tm = lms
    cases = _cases(7, seed=1)
    je = JGenEngine(jm, n_slots=3, default_timeout_s=300.0)
    try:
        want = [je.submit(p, max_new=m).result(300) for p, m in cases]
    finally:
        je.shutdown()
    got = _run(_engine(tm), cases)
    distinct = set()
    for (p, m), g, w in zip(cases, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tm.generate_cached(p[None], max_new=m)[0])
        distinct |= set(g[len(p):].tolist())
    assert len(distinct) > 3


@pytest.mark.parametrize("knobs", [{}, dict(temperature=0.8, top_k=8, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_slot_among_others_equals_the_request_alone(lms, knobs):
    _, tm = lms
    cases = _cases(5, seed=2)
    crowd = _run(_engine(tm, n_slots=4), cases, seed=7, **knobs)
    for (p, m), c in zip(cases, crowd):
        alone = _run(_engine(tm, n_slots=1), [(p, m)], seed=7, **knobs)[0]
        np.testing.assert_array_equal(c, alone)
    if knobs:
        other = _run(_engine(tm), cases, seed=8, **knobs)
        assert any(not np.array_equal(a, b) for a, b in zip(crowd, other))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("n_slots,max_length", [(1, None), (32, 128), (7, 1000)])
def test_memory_report_equals_jax(n_slots, max_length, cd):
    jm = jlm.TransformerLM(compute_dtype=cd, **CONF).init()
    tm = TransformerLM(compute_dtype=cd, **CONF).init(device="cpu")
    assert generation_memory_report(tm, n_slots, max_length) == j_mem(jm, n_slots, max_length)


def test_describe_warmup_and_refusals(lms):
    _, tm = lms
    eng = _engine(tm, n_slots=2, max_length=200, prefill_buckets=[16, 128])
    try:
        d = eng.describe()
        assert d["backend"] == "transformer" and d["decode_cell_path"] is None
        assert d["max_length"] == 200 and d["prefill_buckets"] == [16, 128, 200]
        # K and V, 2 layers, 2 slots, 4 heads, 200 positions, head dim 8, f32
        assert d["memory"]["cache_bytes"] == eng.backend.cache_bytes == 2 * 2 * 2 * 4 * 200 * 8 * 4
        assert eng.warmup()["buckets"] == [16, 128, 200]
        with pytest.raises(ContextWindowExceeded):
            eng.submit(np.zeros(190, np.int32), max_new=20)
        with pytest.raises(ValueError, match="token ids"):
            eng.submit([V], max_new=2)
    finally:
        eng.shutdown()
    with pytest.raises(GenerationNotPortedError, match="ROADMAP"):
        _engine(tm, spec_decode_k=2)
    with pytest.raises(GenerationNotPortedError, match="ROADMAP"):
        _engine(tm, prefix_cache_mb=1.0)
    with pytest.raises(Exception, match="budget"):
        _engine(tm, memory_limit_bytes=1000)


# ---------------------------------------------------------------- /predict
def test_inference_engine_equals_jax_engine(lms):
    jm, tm = lms
    je = JEngine(jm, buckets=JBuckets(batch_buckets=[1, 4]))
    te = InferenceEngine(tm, buckets=[1, 4], device="cpu")
    rng = np.random.default_rng(3)
    for b, t in ((3, 40), (1, 128), (2, 7)):
        x = rng.integers(0, V, (b, t))
        got, want = te.infer(x), je.infer(x)
        assert got.shape == (b, t, V) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert te.warmup(example_shape=(16,))["shapes"] == 2
    assert te.describe()["model_type"] == "TransformerLM"
    with pytest.raises(ValueError, match="warmup"):
        te.warmup()
    for bad in (np.zeros((2, 3, 4)), np.zeros((1, 300)), np.full((1, 4), V),
                np.full((1, 2), 0.5)):
        with pytest.raises(ValueError):
            te.infer(bad)
    with pytest.raises(TypeError, match="int8"):
        InferenceEngine(tm, device="cpu", int8_serving=True)


def test_inference_engine_model_surface(lms):
    """The engine serves a model without ``_forward`` through the model's
    own ``serving_rows``/``serving_forward``; it refuses a feature mask for
    it and a model with neither surface."""
    _, tm = lms
    te = InferenceEngine(tm, buckets=[2], device="cpu")
    assert te.example_shape() is None
    assert te._snap.conf_json == tm.conf_json() == tm.cfg.to_json()
    x = np.asarray([[1, 2, 3]])
    with pytest.raises(ValueError, match="mask"):
        te.infer(x, mask=np.ones((1, 3), np.float32))
    with torch.inference_mode():
        want = tm.serving_forward(tm.compute_params(), torch.from_numpy(x))
    np.testing.assert_array_equal(te.infer(x), want.numpy())

    class Opaque:
        params_ = {}
        state_ = None

    with pytest.raises(TypeError, match="cannot be served"):
        InferenceEngine(Opaque(), device="cpu")


# -------------------------------------------------------------------- HTTP
def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, None if body is None else json.dumps(body).encode())
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_generate_and_predict_over_http(lms):
    _, tm = lms
    p = [3, 1, 4, 1, 5, 9, 2, 6]
    want = _run(_engine(tm), [(np.asarray(p, np.int32), 6)])[0]
    eng = InferenceEngine(tm, buckets=[1, 2], device="cpu")
    srv = InferenceServer(eng, port=0, generation=_engine(tm, n_slots=2)).start()
    try:
        code, raw = _http(srv.port, "POST", "/generate",
                          {"prompt": p, "max_new": 6, "stream": False})
        assert code == 200 and json.loads(raw)["sequence"] == want.tolist()
        code, raw = _http(srv.port, "POST", "/predict", {"inputs": [p]})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(json.loads(raw)["outputs"], np.float32),
                                      eng.infer(np.asarray([p])))
        code, raw = _http(srv.port, "POST", "/predict", {"inputs": [[V + 1]]})
        assert code == 400
        h = json.loads(_http(srv.port, "GET", "/healthz")[1])
        assert h["generation"]["backend"] == "transformer"
    finally:
        srv.shutdown()
