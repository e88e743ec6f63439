"""The port's int8 weight-only matmul against the JAX package on the CPU.

- ``quantize_int8`` and ``quantize_model_params``: bit-equal ``q`` and
  scales, equal byte report.
- ``int8_matmul_plain`` (the CPU path of ``int8_matmul``) against JAX
  ``int8_matmul(..., interpret=True)``, the Pallas kernel run by its
  interpreter: per element ``|t - j| <= 2*K*2^-24*(|x|.|q|)*s``, the f32
  summation-order difference; for bf16 plus one bf16 step of ``|j|`` for
  the output and one for the scale (JAX rounds once, the plain version
  rounds the product and then the scaled result). The rank-3 head of
  ``test_fused_kernels.py:543`` likewise.
- The int8 engines: the port's ``InferenceEngine(int8_serving=True)`` on
  the CPU against JAX's on the same weights (1e-5 in f32, f32 summation
  order; twice JAX's own int8 bf16-vs-f32 distance under bf16), its
  snapshot against JAX's ``quantize_model_params``, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.ops.int8_matmul as jim
import deeplearning4j_tpu_torch.nn.ops.int8_matmul as tim
from deeplearning4j_tpu.serving.buckets import BucketPolicy as JBuckets
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu_torch.interop import export_serving_params
from deeplearning4j_tpu_torch.nn.ops import launch
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from tests.torch_mln_pairs import PORT, inputs, pair, small_graph

BF16_STEP = 2.0 ** -7


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((64, 32), 0), ((777, 130), 1), ((5, 3), 2)])
def test_quantize_is_bit_equal(shape, seed):
    w = _rand(shape, seed, 0.1)
    w[:, 0] = 0.0  # an all-zero channel dequantizes to exact zeros
    qj, sj = jim.quantize_int8(w)
    qt, st = tim.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    assert qt.dtype == np.int8 and st.dtype == np.float32
    # round half to even, as np.rint
    assert tim.quantize_int8(np.array([[0.5, -2.5], [127.0, 127.0]], np.float32))[0].tolist() \
        == [[0, -2], [127, 127]]


def _bound(x, q, s, dtype_is_bf16, want):
    mag = (np.abs(x.astype(np.float32)) @ np.abs(q.astype(np.float32))) * s
    tol = 2 * x.shape[-1] * 2.0 ** -24 * mag
    if dtype_is_bf16:
        tol = tol + 2 * BF16_STEP * np.abs(want)
    return tol


CASES = [(8, 100, 40), (3, 777, 130), (1, 2450, 500), (5, 500, 10)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k,n", CASES, ids=[f"{b}x{k}x{n}" for b, k, n in CASES])
def test_plain_matches_the_pallas_kernel(b, k, n, bf16):
    x = _rand((b, k), b * 1000 + k)
    q, s = jim.quantize_int8(_rand((k, n), n, 0.2))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = np.asarray(jim.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s),
                                      interpret=True), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    before = dict(launch.launch_counts)
    got = tim.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(s))
    assert dict(launch.launch_counts) == before  # the CPU path launches nothing
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, n)
    xq = xt.float().numpy()
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bound(xq, q, s, bf16, want)).all(), float(err.max())


def test_rank3_head_matches_jax():
    x = _rand((2, 5, 16), 0)
    q, s = jim.quantize_int8(_rand((16, 9), 1))
    want = np.asarray(jim.serving_matmul(
        {"W_q8": jnp.asarray(q), "W_scale": jnp.asarray(s)}, jnp.asarray(x)))
    got = tim.serving_matmul({"W_q8": torch.from_numpy(q), "W_scale": torch.from_numpy(s)},
                             torch.from_numpy(x))
    assert tuple(got.shape) == (2, 5, 9)
    err = np.abs(got.numpy() - want)
    assert (err <= _bound(x.reshape(10, 16), q, s, False, want.reshape(10, 9))
            .reshape(2, 5, 9)).all()


def test_f32_route_promotes_like_jax():
    x = torch.randn(3, 4, dtype=torch.bfloat16)
    w = torch.randn(4, 2)
    y = tim.serving_matmul({"W": w}, x)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w)


@pytest.mark.parametrize("name", ["lenet", "narrow_vgg"])
def test_quantize_model_params_is_the_references(name):
    jnet, tnet = pair(name)
    jq, jrep = jim.quantize_model_params(jnet)
    tq, trep = tim.quantize_model_params(tnet)
    assert trep == jrep and trep["layers_quantized"] == 2 + (name == "narrow_vgg")
    for a, b in zip(tq, jq):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    # the model keeps its f32 weights
    assert "W" in tnet.params_[-1] and "W_q8" not in tnet.params_[-1]


@pytest.mark.parametrize("name", ["lenet", "narrow_vgg"])
def test_int8_engine_matches_jax(name):
    jnet, tnet = pair(name)
    x = inputs(name, 3, seed=7)
    want = JEngine(jnet, buckets=JBuckets(batch_buckets=[4]), int8_serving=True).infer(x)
    eng = InferenceEngine(tnet, buckets=[4], device="cpu", int8_serving=True)
    got = eng.infer(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    desc = eng.describe()
    assert desc["int8_serving"] is True
    assert desc["int8_report"] == jim.quantize_model_params(jnet)[1]
    # the snapshot holds W_q8/W_scale, not the f32 W, of the quantized layers
    snap = export_serving_params(eng)
    jq, _ = jim.quantize_model_params(jnet)
    for mine, ref in zip(snap, jq):
        assert sorted(mine) == sorted(ref)
        if "W_q8" in mine:
            np.testing.assert_array_equal(mine["W_q8"], np.asarray(ref["W_q8"]))
            np.testing.assert_array_equal(mine["W_scale"], np.asarray(ref["W_scale"]))
    # and the f32 engine differs from it by the quantization error only
    f32 = InferenceEngine(tnet, buckets=[4], device="cpu").infer(x)
    assert 0 < float(np.abs(f32 - got).max()) < 0.05


def test_int8_engine_bf16_matches_jax():
    jnet, tnet = pair("narrow_vgg", compute_dtype="bfloat16")
    j32, _ = pair("narrow_vgg")
    x = inputs("narrow_vgg", 3, seed=8)
    buckets = JBuckets(batch_buckets=[4])
    want = JEngine(jnet, buckets=buckets, int8_serving=True).infer(x)
    noise = float(np.abs(want - JEngine(j32, buckets=buckets, int8_serving=True)
                         .infer(x)).max())
    eng = InferenceEngine(tnet, buckets=[4], device="cpu", int8_serving=True)
    got = eng.infer(x)
    assert noise > 0 and float(np.abs(got - want).max()) <= 2 * noise
    # under compute_dtype the hidden heads' scales are cast, the output's not
    snap = eng._snap.params
    assert snap[5]["W_q8"].dtype == torch.int8 and snap[5]["W_scale"].dtype == torch.bfloat16
    assert snap[7]["W_scale"].dtype == torch.float32


def test_int8_engine_refuses_a_graph():
    g = ComputationGraph(small_graph(PORT)).init(device="cpu")
    with pytest.raises(TypeError, match="MultiLayerNetwork"):
        InferenceEngine(g, device="cpu", int8_serving=True)
    InferenceEngine(g, device="cpu")  # f32 serving of a graph stays


def test_kernel_route_refuses_what_it_does_not_take():
    """The CUDA route checks its arguments before it builds or launches."""
    x = torch.zeros(2, 3, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tim._kernel(x, torch.zeros(3, 4, dtype=torch.int8), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tim._kernel(torch.zeros(2, 3), torch.zeros(3, 4, dtype=torch.int8), torch.ones(4))
    # the depth split depends on K, N and the SM count, never on the rows
    assert tim.int8_split(25088, 4096, 132, 512) == (384, 66)
    assert tim.int8_split(500, 10, 132, 512) == (128, 4)
