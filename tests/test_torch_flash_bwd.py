"""The port's flash-attention backward (``nn/ops/flash_attention.py``) against
the JAX package's Pallas kernels on the CPU.

- ``FlashAttention`` (what ``flash_attention`` records where a gradient is
  wanted; on CPU tensors the plain forward and backward) against
  ``jax.grad`` of ``flash_attention(..., interpret=True)``, the reference's
  custom VJP through its ``_dq_kernel``/``_dkv_kernel`` in the Pallas
  interpreter, on the same numpy inputs and cotangent. f32: rtol 1e-4, atol
  5e-5, the reference's own gradient test (``tests/test_flash_kernel.py:33-50``).
  bf16: each side rounds ``p``/``ds`` and its outputs once (and its forward
  ``o``, which enters ``D``), so each is within the card tests' limit of the
  f32 result (``2^-8`` of the terms' magnitudes + ``2^-8 |ref|`` + 1e-5 per
  element); the two are held to each other within twice that limit.
- ``flash_attention_bwd_plain`` on the reference's formulas: against JAX's
  ``_bwd_impl(..., interpret=True)`` fed the same ``q, k, v, o, lse, dO``
  (f32 within 1e-5; bf16 within one bf16 step of the larger magnitude, as
  both round the same f32 ``p`` and ``ds`` and may part at a tie), and in
  f32 against float64 autograd of dense softmax attention (within 1e-5).
- Under ``no_grad`` or ``inference_mode`` the forward records nothing.
- The dK/dV wrapper's host logic, on "meta" tensors with the launch
  stubbed: TMA-readable operands pass with their own strides, the others
  (an expanded dO, a ragged hd) through the padded layout copy; the
  backward's T rule stays a multiple of 64 (the forward's is 128), so the
  last 128-key block may hang past T.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa

jfa = importlib.import_module("deeplearning4j_tpu.nn.ops.flash_attention")
F32_RTOL, F32_ATOL = 1e-4, 5e-5
PLAIN_F32_TOL = 1e-5


def _inputs(b, h, T, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, T, hd)).astype(np.float32) for _ in range(4)]


def _segments(b, T):
    """Cuts at 50 and 77 (inside the reference's 128-row blocks and off the
    port's 64-row tiles); the last row differs."""
    seg = np.zeros((b, T), np.int32)
    seg[:, 50:] = 1
    seg[:, 77:] = 2
    seg[-1, T // 2:] = 3
    return seg


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _limit(q, k, v, do, causal, scale, seg):
    """Per-element bf16 limits of (dq, dk, dv) from the f32 result:
    2^-8 (terms) + 2^-8 |ref| + 1e-5 (one rounding of ds or p, one of the
    output, each allowed twice)."""
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    s = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_attention_plain(*t[:3], causal, scale, s)
    ref = fa.flash_attention_bwd_plain(*t[:3], o, lse, t[3], causal, scale, s)
    b, h, T, _ = q.shape
    p = torch.exp(fa.masked_scores(t[0], t[1], causal, scale, s) - lse.reshape(b, h, T, 1))
    ds = p * (t[3] @ t[2].transpose(-1, -2) - fa.row_dot(o, t[3]).reshape(b, h, T, 1)) * scale
    terms = (ds.abs() @ t[1].abs(), ds.abs().transpose(-1, -2) @ t[0].abs(),
             p.transpose(-1, -2) @ t[3].abs())
    return [(2.0 ** -8 * m + 2.0 ** -8 * r.abs() + 1e-5).numpy() for r, m in zip(ref, terms)]


CASES = [  # (b, h, T, hd, causal, segmented)
    (1, 2, 128, 32, True, False),
    (2, 2, 128, 32, False, False),
    (2, 1, 256, 48, True, True),
    (1, 2, 256, 16, False, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,T,hd,causal,segmented", CASES)
def test_function_gradients_equal_the_pallas_backward(b, h, T, hd, causal, segmented, dtype):
    q, k, v, do = _inputs(b, h, T, hd, seed=T + hd + b)
    if dtype == "bfloat16":
        q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    seg = _segments(b, T) if segmented else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal, segment_ids=seg, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, (0, 1, 2))(jq, jk, jv)]

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=seg)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    assert all(g.dtype == tdt and g.shape == (b, h, T, hd) for g in got)
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)
    else:
        lims = _limit(q, k, v, do, causal, hd ** -0.5, seg)
        for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, lims):
            err = np.abs(g - w)
            assert (err <= 2 * lim).all(), f"{name}: max err/limit {(err / (2 * lim)).max()}"


PLAIN_CASES = [  # (b, h, T, hd, causal, segmented, dtype)
    (1, 2, 128, 32, True, False, "float32"),
    (2, 1, 256, 48, False, True, "float32"),
    (1, 2, 256, 40, True, True, "bfloat16"),
    (2, 1, 128, 64, False, False, "bfloat16"),
]


@pytest.mark.parametrize("b,h,T,hd,causal,segmented,dtype", PLAIN_CASES)
def test_plain_backward_is_the_references(b, h, T, hd, causal, segmented, dtype):
    """``flash_attention_bwd_plain`` and JAX's ``_bwd_impl`` on the same
    ``q, k, v, o, lse, dO`` (the reference's lane-padded layouts on its side);
    in f32 also the float64 gradient of dense softmax attention."""
    q, k, v, do = _inputs(b, h, T, hd, seed=3 * T + hd)
    if dtype == "bfloat16":
        q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    seg = _segments(b, T) if segmented else None
    tseg = None if seg is None else torch.from_numpy(seg)
    scale = hd ** -0.5
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal, scale, tseg)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal, scale, tseg)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pad = [jfa._pad_head(jnp.asarray(a.float().numpy()).astype(jdt))[0].reshape(b * h, T, -1)
           for a in (tq, tk, tv, o, tdo)]
    jlse = jnp.broadcast_to(jnp.asarray(lse.numpy())[:, :, None], (b * h, T, 128))
    want = jfa._bwd_impl(*pad[:3], None if seg is None else jnp.asarray(seg), pad[3], jlse,
                         pad[4], causal, scale, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        w = np.asarray(w.astype(jnp.float32))[:, :, :hd].reshape(b, h, T, hd)
        g = g.float().numpy()
        tol = PLAIN_F32_TOL if dtype == "float32" else \
            2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) + 1e-6
        assert (np.abs(g - w) <= tol).all(), f"{name}: max err {np.abs(g - w).max()}"

    if dtype == "float32":
        q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v))
        live = fa.masked_scores(q64.detach(), k64.detach(), causal, scale, tseg) > -1e29
        s = torch.where(live, torch.matmul(q64, k64.transpose(-1, -2)) * scale, -1e30)
        ref = torch.autograd.grad(torch.softmax(s, -1) @ v64, (q64, k64, v64),
                                  torch.from_numpy(do).double())
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=PLAIN_F32_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_nothing_is_recorded_without_grad(mode):
    q = torch.randn(1, 1, 128, 16, requires_grad=True)
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        o, lse = fa.flash_attention_fwd(q, q, q, True, 0.25)
        o2 = fa.flash_attention(q, q, q, causal=True)
    assert o.grad_fn is None and o2.grad_fn is None and not o.requires_grad
    o3, _ = fa.flash_attention_fwd(q, q, q, True, 0.25)
    assert torch.equal(o, o3.detach()) and o3.grad_fn is not None


# ---------------------------------------------------------------- host logic
class _Recorded:
    def __init__(self):
        self.args = {}

    def launch(self, fn, op, args):
        self.args[op] = args
        fa.launch_counts[op] += 1


def _stub(monkeypatch):
    import contextlib

    rec = _Recorded()
    monkeypatch.setattr(fa._BWD_LIB, "get", lambda: type("H", (), {
        "dl4j_flash_bwd_dkv": None, "dl4j_flash_bwd_dq": None})())
    monkeypatch.setattr(fa._BWD_LIB, "tile", {"m": 64, "n": 64, "d": 128})
    monkeypatch.setattr(fa, "launch", rec.launch)
    monkeypatch.setattr(fa.torch.cuda, "device", lambda d: contextlib.nullcontext())
    return rec


def _meta(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("T,hd,causal,expanded", [(512, 64, True, False), (192, 64, True, True),
                                                  (256, 20, False, False),
                                                  (128, 128, True, False)])
def test_dkv_wrapper_hands_the_kernel_tma_operands(monkeypatch, T, hd, causal, expanded):
    rec = _stub(monkeypatch)
    b, h = 2, 3
    q = k = v = _meta((b, h, T, hd))
    do = (_meta((1, 1, 1, hd)).expand(b, h, T, hd) if expanded
          else _meta((b, T, h, hd)).transpose(1, 2))
    lse = dcap = _meta((b * h, T), torch.float32)
    dk, dv = fa.flash_attention_dkv(q, k, v, lse, do, dcap, causal, 0.125)
    ints = rec.args[fa.OP_DKV][9:9 + 28]
    hd8 = -(-hd // 8) * 8
    assert ints[:6] == (b, h, T, hd, int(causal), 1)
    dense = (h * T * hd8, T * hd8, hd8)
    want_q = q.stride()[:3] if fa.tma_ready(q) else dense
    want_do = do.stride()[:3] if fa.tma_ready(do) else dense
    assert ints[6:9] == want_q and ints[15:18] == want_do
    assert fa.tma_ready(do) is not (expanded or hd % 8 != 0)
    assert ints[24:28] == ((hd if hd % 8 == 0 else hd8),) * 3 + (
        hd if fa.tma_ready(do) else hd8,)
    assert dk.shape == dv.shape == (b, h, T, hd) and dk.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("T,hd,causal,expanded", [(512, 64, True, False), (192, 64, True, True),
                                                  (256, 20, False, False),
                                                  (128, 128, True, False)])
def test_dq_wrapper_hands_the_kernel_tma_operands(monkeypatch, T, hd, causal, expanded):
    """The bf16 dq kernel reads q, k, v and dO by TMA: an operand TMA cannot
    read (a ragged hd, an expanded dO) reaches it as its padded copy, with
    its own last dim; lse, D and the segment ids 16-byte aligned."""
    rec = _stub(monkeypatch)
    b, h = 2, 3
    q = k = v = _meta((b, h, T, hd))
    do = (_meta((1, 1, 1, hd)).expand(b, h, T, hd) if expanded
          else _meta((b, T, h, hd)).transpose(1, 2))
    lse = dcap = _meta((b * h, T), torch.float32)
    seg = torch.zeros((b, T), dtype=torch.int32, device="meta")
    dq = fa.flash_attention_dq(q, k, v, lse, do, dcap, causal, 0.125, seg)
    args = rec.args[fa.OP_DQ]
    ints = args[8:8 + 25]
    hd8 = -(-hd // 8) * 8
    assert ints[:6] == (b, h, T, hd, int(causal), 1)
    dense = (h * T * hd8, T * hd8, hd8)
    want_q = q.stride()[:3] if fa.tma_ready(q) else dense
    want_do = do.stride()[:3] if fa.tma_ready(do) else dense
    assert ints[6:9] == want_q and ints[15:18] == want_do
    assert fa.tma_ready(do) is not (expanded or hd % 8 != 0)
    assert ints[21:25] == ((hd if hd % 8 == 0 else hd8),) * 3 + (
        hd if fa.tma_ready(do) else hd8,)
    assert len(args) == 8 + 25 + 1 and isinstance(args[-1], float)
    assert all(p % fa._TMA_ALIGN == 0 for p in args[4:7])
    assert dq.shape == (b, h, T, hd) and dq.transpose(1, 2).is_contiguous()


def test_backward_t_rule_is_a_multiple_of_64(monkeypatch):
    """dq and dkv take T 192, which the forward refuses (a multiple of 128,
    the reference's rule); f32 operands pass as they are (no padded copy)."""
    rec = _stub(monkeypatch)
    q = _meta((1, 2, 192, 20), torch.float32)
    lse = _meta((2, 192), torch.float32)
    fa.flash_attention_dq(q, q, q, lse, q, lse, True, 0.25)
    fa.flash_attention_dkv(q, q, q, lse, q, lse, True, 0.25)
    assert rec.args[fa.OP_DQ][8 + 21:8 + 25] == (20,) * 4
    assert rec.args[fa.OP_DKV][9 + 24:9 + 28] == (20,) * 4
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention_fwd(_meta((1, 2, 192, 64)), _meta((1, 2, 192, 64)),
                               _meta((1, 2, 192, 64)), True, 0.125)
    with pytest.raises(ValueError, match="multiple of 64"):
        fa.flash_attention_dkv(*(_meta((1, 2, 96, 64)),) * 3, _meta((2, 96), torch.float32),
                               _meta((1, 2, 96, 64)), _meta((2, 96), torch.float32), True, 0.1)
