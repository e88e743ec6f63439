"""The port's flash-attention forward (``nn/ops/flash_attention.py``) against
the JAX package's Pallas kernel on the CPU.

- ``flash_attention_plain`` (the kernel's plain version, which the port's
  CPU path takes) against JAX's ``flash_attention(..., interpret=True)``
  for ``o`` and ``_fwd_impl(..., interpret=True)`` for ``lse`` (lane 0 of
  its lane-broadcast layout), on the same numpy inputs. f32: within 1e-5.
  bf16: both round ``p`` to bf16 (JAX per 128-row tile, relative to the
  running max; the port relative to the final max) and ``o`` once, so each
  is one rounding of ``p`` and one of ``o`` from the exact result; the
  port's is held to JAX's within the limit of ``chip_smoke.py`` phase 2e,
  ``2^-8 (P @ |v|) + 2^-8 |o| + 1e-5`` per element.
- The validation errors carry JAX's messages.
- ``_flash_attention_route`` is false for CPU tensors, padding masks,
  attention dropout, T < 128, T % 128 != 0 and unequal q/kv lengths; true
  for the same shapes on "cuda" (``tests/test_attention.py:318-339``),
  head dims over 128 and f16 included: the kernel's argument checks, not
  the route, refuse those, so nothing on the card falls back.
- A call on a non-CPU tensor that would record a gradient raises before any
  kernel is reached (the backward kernels come with the training slice).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf.layers.attention import _flash_attention_route
from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa

# the module (the package re-exports its function under the same name)
jfa = importlib.import_module("deeplearning4j_tpu.nn.ops.flash_attention")
F32_TOL = 1e-5


def _inputs(b, h, T, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, T, hd)).astype(np.float32) for _ in range(3)]


def _segments(b, T):
    seg = np.zeros((b, T), np.int32)
    seg[:, T // 3:] = 1
    seg[:, T // 3 + 77:] = 2
    seg[-1, T // 2:] = 3  # rows differ
    return seg


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _limit(q, k, v, causal, scale, seg):
    """Phase 2e's per-element bf16 limit, from the plain version in f32."""
    t = [torch.from_numpy(a) for a in (q, k, v)]
    s = None if seg is None else torch.from_numpy(seg)
    o_ref, _ = fa.flash_attention_plain(*t, causal, scale, s)
    p = torch.softmax(fa.masked_scores(t[0], t[1], causal, scale, s), -1)
    return (2.0 ** -8 * (p @ t[2].abs()) + 2.0 ** -8 * o_ref.abs() + 1e-5).numpy()


CASES = [  # (b, h, T, hd, causal, segmented)
    (1, 2, 128, 64, True, False),
    (2, 2, 256, 64, False, False),
    (1, 3, 256, 32, True, False),
    (2, 1, 128, 40, False, True),
    (2, 2, 256, 40, True, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,T,hd,causal,segmented", CASES)
def test_plain_equals_the_pallas_kernel(b, h, T, hd, causal, segmented, dtype):
    q, k, v = _inputs(b, h, T, hd, seed=T + hd + b)
    if dtype == "bfloat16":
        q, k, v = (_bf16(a) for a in (q, k, v))
    seg = _segments(b, T) if segmented else None
    scale = hd ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    o_j = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal, segment_ids=seg,
                                         interpret=True).astype(jnp.float32))
    # lse from the kernel's own entry, on lane-padded (bh, T, 128) operands
    pad = [jfa._pad_head(a)[0].reshape(b * h, T, -1) for a in (jq, jk, jv)]
    _, lse_j = jfa._fwd_impl(*pad, None if seg is None else jnp.asarray(seg), causal, scale,
                             True)
    lse_j = np.asarray(lse_j)[:, :, 0]

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o_t, lse_t = fa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                        None if seg is None else torch.from_numpy(seg))
    assert o_t.dtype == tdt and o_t.shape == (b, h, T, hd) and lse_t.shape == (b * h, T)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=0, atol=F32_TOL)
    err = np.abs(o_t.float().numpy() - o_j)
    if dtype == "float32":
        assert err.max() <= F32_TOL
    else:
        lim = _limit(q, k, v, causal, scale, seg)
        assert (err <= lim).all(), f"max err/limit {(err / lim).max()}"
    # the public function takes the same path
    o_pub = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=seg)
    assert torch.equal(o_pub, o_t)


def test_plain_rounds_p_to_the_operand_dtype():
    """``p`` is rounded to v's dtype before ``p @ v``, as the reference
    kernel does: bf16 operands give another ``o`` than their f32 widening."""
    q, k, v = (torch.from_numpy(_bf16(a)) for a in _inputs(1, 2, 128, 16, seed=3))
    o16, lse16 = fa.flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), True, 0.25)
    o32, lse32 = fa.flash_attention_plain(q, k, v, True, 0.25)
    assert torch.equal(lse16, lse32)
    assert not torch.equal(o16.float(), o32.bfloat16().float())


def test_sm_scale_override_matches_jax():
    q, k, v = _inputs(1, 1, 128, 16, seed=5)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                          sm_scale=0.3, interpret=True))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("shapes,seg", [
    (((1, 2, 128, 16), (1, 2, 256, 16), (1, 2, 256, 16)), None),
    (((1, 2, 100, 16),) * 3, None),
    (((1, 1, 4224, 8),) * 3, None),
    (((2, 2, 128, 16),) * 3, np.zeros((2, 64), np.int32)),
])
def test_validation_errors_match_jax(shapes, seg):
    def messages(mod, make):
        with pytest.raises(ValueError) as e:
            mod.flash_attention(*[make(np.zeros(s, np.float32)) for s in shapes],
                                causal=True, segment_ids=seg)
        return str(e.value)

    assert messages(fa, torch.from_numpy) == messages(jfa, jnp.asarray)


def test_route_predicate():
    q = torch.zeros(2, 4, 512, 64)
    route = _flash_attention_route
    assert not route(q, q, True, None, 0.0)                       # CPU tensors
    assert route(q, q, True, None, 0.0, device_type="cuda")
    assert route(q, q, False, None, 0.0, torch.zeros(2, 512, dtype=torch.int32),
                 device_type="cuda")
    assert route(q.bfloat16(), q.bfloat16(), True, None, 0.0, device_type="cuda")
    assert not route(q, q, True, torch.ones(2, 512), 0.0, device_type="cuda")
    assert not route(q, q, True, None, 0.1, device_type="cuda")
    for T in (64, 100, 200):
        qb = torch.zeros(2, 4, T, 64)
        assert not route(qb, qb, True, None, 0.0, device_type="cuda")
    assert not route(q, torch.zeros(2, 4, 256, 64), True, None, 0.0, device_type="cuda")
    qb = torch.zeros(1, 1, 4096 + 128, 64)
    assert not route(qb, qb, True, None, 0.0, device_type="cuda")  # over MAX_SEQ_LEN
    # what the kernel does not take still routes to it (and is refused there)
    qb = torch.zeros(1, 1, 128, 160)
    assert route(qb, qb, True, None, 0.0, device_type="cuda")      # head dim over 128
    assert route(q.half(), q.half(), True, None, 0.0, device_type="cuda")


@pytest.mark.parametrize("shape,dtype,err", [
    ((1, 2, 128, 160), torch.float32, ValueError),    # head dim over 128
    ((1, 2, 128, 64), torch.float16, TypeError),
    ((1, 2, 96, 64), torch.bfloat16, ValueError),      # T not a multiple of 64
])
def test_kernel_argument_checks_refuse_off_the_cpu(shape, dtype, err):
    """A tensor off the CPU (here "meta", which reaches the kernel's wrapper
    without a card) outside the kernel's range raises before any build or
    launch, naming ROADMAP; there is no fallback to the plain version."""
    q = torch.zeros(shape, dtype=dtype, device="meta")
    n0 = fa.launch_counts[fa.OP]
    with pytest.raises(err, match="ROADMAP" if shape[2] % 64 == 0 else "multiple of 64"):
        fa.flash_attention_fwd(q, q, q, True, 0.125)
    assert fa.launch_counts[fa.OP] == n0


def test_constants_match_jax():
    assert fa.MAX_SEQ_LEN == jfa.MAX_SEQ_LEN and fa._LANE == jfa._LANE
    assert fa._NEG_INF == jfa._NEG_INF


def test_a_gradient_call_off_the_cpu_raises_before_the_kernel():
    q = torch.zeros(1, 1, 128, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention_fwd(q, q, q, True, 0.25)
