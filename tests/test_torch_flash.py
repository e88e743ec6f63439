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
- A call that records a gradient goes through ``FlashAttention``: off the
  CPU to the kernel, on the CPU through the plain versions (their gradients
  against JAX's are in ``test_torch_flash_bwd.py``).
- The forward wrapper's host logic, on CPU and "meta" tensors with the
  launch stubbed: which operands TMA reads as they are (``tma_ready``) and
  which go through the padded layout copy, the T rule (a multiple of 128,
  the reference's), and the aligned lse and segment-id bases.
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
    ((1, 2, 96, 64), torch.bfloat16, ValueError),      # T not a multiple of 128
    ((1, 2, 192, 64), torch.bfloat16, ValueError),     # a multiple of 64, not of 128
])
def test_kernel_argument_checks_refuse_off_the_cpu(shape, dtype, err):
    """A tensor off the CPU (here "meta", which reaches the kernel's wrapper
    without a card) outside the kernel's range raises before any build or
    launch, naming ROADMAP; there is no fallback to the plain version."""
    q = torch.zeros(shape, dtype=dtype, device="meta")
    n0 = fa.launch_counts[fa.OP]
    with pytest.raises(err, match="ROADMAP" if shape[2] % 128 == 0 else "multiple of 128"):
        fa.flash_attention_fwd(q, q, q, True, 0.125)
    assert fa.launch_counts[fa.OP] == n0


def test_constants_match_jax():
    assert fa.MAX_SEQ_LEN == jfa.MAX_SEQ_LEN and fa._LANE == jfa._LANE
    assert fa._NEG_INF == jfa._NEG_INF


def test_a_gradient_call_off_the_cpu_raises_before_the_kernel(monkeypatch):
    """A call that records a gradient is no longer refused. Off the CPU it
    goes through ``FlashAttention`` to the kernel: here the kernel library's
    loader, stubbed to raise, shows that it got there, before any launch. On
    the CPU it runs the plain versions and carries a gradient."""

    class Reached(Exception):
        pass

    def reached():
        raise Reached

    monkeypatch.setattr(fa._LIB, "get", reached)
    q = torch.zeros(1, 1, 128, 16, device="meta", requires_grad=True)
    n0 = dict(fa.launch_counts)
    with pytest.raises(Reached):
        fa.flash_attention_fwd(q, q, q, True, 0.25)
    assert dict(fa.launch_counts) == n0
    qc = torch.randn(1, 1, 128, 16, requires_grad=True)
    o, lse = fa.flash_attention_fwd(qc, qc, qc, True, 0.25)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward" and not lse.requires_grad
    o.sum().backward()
    assert qc.grad is not None and bool(torch.isfinite(qc.grad).all())


# ---------------------------------------------------------------- host logic
def _qkv_split(b, T, h, hd, dtype=torch.bfloat16):
    """q, k, v as the fused qkv projection's head split makes them."""
    x = torch.zeros(b, T, 3, h, hd, dtype=dtype)
    return [x[:, :, i].transpose(1, 2) for i in range(3)]


def _views():
    dense = torch.zeros(2, 3, 256, 64, dtype=torch.bfloat16)
    heads = torch.zeros(2, 256, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    wide = torch.zeros(2, 3, 256, 66, dtype=torch.bfloat16)
    return {
        "dense": (dense, True),
        "head-split (b, T, h, hd)": (heads, True),
        "fused qkv split": (_qkv_split(2, 256, 3, 64)[1], True),
        "hd 40": (torch.zeros(1, 3, 256, 40, dtype=torch.bfloat16), True),
        "hd 32": (torch.zeros(1, 3, 256, 32, dtype=torch.bfloat16), True),
        "ragged hd 20": (torch.zeros(1, 3, 256, 20, dtype=torch.bfloat16), False),
        "misaligned base": (wide[..., 1:65], False),
        "expanded (stride 0)": (torch.zeros(1, 1, 1, 1, dtype=torch.bfloat16).expand(2, 3, 256, 64),
                                False),
        "size-1 dims, odd strides": (torch.zeros(1, 1, 256, 64, dtype=torch.bfloat16).as_strided(
            (1, 1, 256, 64), (3, 5, 64, 1)), True),
        "meta": (torch.zeros(2, 256, 3, 64, dtype=torch.bfloat16, device="meta").transpose(1, 2),
                 True),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_tma_ready(name):
    """TMA reads an operand as it is when its base is 16-byte aligned and
    every batch/head/time stride of a dimension longer than 1 is a positive
    multiple of 16 bytes; the model's head-split views qualify."""
    t, want = _views()[name]
    assert fa.tma_ready(t) is want


def test_padded_operand_is_the_layout_copy():
    x = torch.randn(1, 3, 128, 20).bfloat16()
    p = fa.padded_operand(x)
    assert p.shape == (1, 3, 128, 24) and p.is_contiguous() and fa.tma_ready(p)
    assert torch.equal(p[..., :20], x) and not p[..., 20:].any()
    y = torch.randn(1, 3, 128, 66).bfloat16()[..., 1:65]
    assert torch.equal(fa.padded_operand(y), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_aligned_vector_copies_only_a_misaligned_base(offset, dtype):
    """lse, D and segment ids reach the kernels' bulk copies at a 16-byte
    aligned base: one that is already aligned passes as it is, any other is
    copied (the same values)."""
    t = torch.arange(40).to(dtype)[offset:offset + 32]
    out = fa.aligned_vector(t)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, t)
    assert (out is t) == (t.data_ptr() % 16 == 0)
    assert fa.aligned_vector(None) is None


class _Recorded:
    """Stands in for the kernel library: records the launch's arguments."""

    tile = {"m": 128, "n": 128, "d": 128}

    def __init__(self):
        self.args = None

    def launch(self, fn, op, args):
        self.args = args
        fa.launch_counts[op] += 1


def _stub_launch(monkeypatch, lib):
    import contextlib

    rec = _Recorded()
    monkeypatch.setattr(lib, "get", lambda: type("H", (), {
        "dl4j_flash_fwd": None, "dl4j_flash_bwd_dkv": None, "dl4j_flash_bwd_dq": None})())
    monkeypatch.setattr(lib, "tile", {"m": 128 if lib is fa._LIB else 64, "n": 128, "d": 128})
    monkeypatch.setattr(fa, "launch", rec.launch)
    monkeypatch.setattr(fa.torch.cuda, "device", lambda d: contextlib.nullcontext())
    return rec


@pytest.mark.parametrize("hd,causal,split", [(64, True, True), (20, True, False),
                                               (40, False, True), (128, True, False)])
def test_forward_wrapper_hands_the_kernel_tma_operands(monkeypatch, hd, causal, split):
    """On "meta" tensors (off the CPU, no card): the forward hands the
    kernel its operands' own strides where TMA can read them, the padded
    copy's where it cannot (hd 20), and their last dims."""
    rec = _stub_launch(monkeypatch, fa._LIB)
    T, h = 256, 3
    if split:
        q, k, v = (t.to("meta") for t in _qkv_split(2, T, h, hd))
    else:
        q = k = v = torch.zeros(2, h, T, hd, dtype=torch.bfloat16, device="meta")
    o, lse = fa.flash_attention_fwd(q, k, v, causal, 0.125)
    a = rec.args
    ints = a[6:6 + 21]
    assert ints[:6] == (2, h, T, hd, int(causal), 1)
    hd8 = -(-hd // 8) * 8
    want = q.stride()[:3] if fa.tma_ready(q) else (h * T * hd8, T * hd8, hd8)
    assert ints[6:9] == want and ints[18:21] == (hd if hd % 8 == 0 else hd8,) * 3
    assert ints[15:18] == o.stride()[:3] and o.transpose(1, 2).is_contiguous()
    assert o.shape == (2, h, T, hd) and lse.shape == (2 * h, T)
