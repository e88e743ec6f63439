"""The port's attention layers and TransformerLM against the JAX package on
the CPU, with params carried from JAX through ``interop``.

- ``_layer_norm``, ``dense_attention`` (the einsum path and, at T 1024, the
  query-blocked path) and the eval forward of ``SelfAttentionLayer``,
  ``TransformerBlock`` and ``PositionalEmbeddingLayer`` (configs carried
  through the serde dicts): f32 within 1e-5; bf16 einsum attention within
  one bf16 step (equal wherever both GEMMs sum in one order), as the port
  repeats JAX's dtype flow op for op; the bf16 blocked path within
  two roundings of ``p`` and one of ``o``: JAX's scanned body fuses its
  softmax, where the port rounds ``exp`` and the quotient.
- A TransformerLM of vocab 64, d 32, 4 heads, 2 layers, max_length 256:
  ``forward``, ``prefill_cache`` with ``length=``, ``decode_step`` with a
  scalar and a per-row ``pos`` (the clip-mode position gather and the
  clamped per-row write), ``generate_cached`` greedy tokens for prompts of
  5, 127, 128, 129 and 200 tokens, ``perplexity``. f32: logits within 1e-5,
  tokens identical. bf16: torch's tanh-gelu rounds once where JAX's rounds
  op by op, so logits agree within 4 bf16 steps (4 * 2^-7) of the largest
  |logit|, and tokens are identical up to the first step whose JAX top-2
  gap is within twice the measured logit difference.
- The typed refusals: MoE, ``decode_steps``, manual parallelism;
  ``fit_batch`` and ``lm_loss``'s gradients, refused before training was
  ported, now run (their parity with JAX is in
  ``test_torch_transformer_train.py``), and so do attention dropout and the
  attention layers' train mode (``test_torch_attention_train.py``).
- ``compute_params``' cache follows replaced and trained params (a freed
  tensor's ``id`` reused by a new one served a stale cast before).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import attention as jatt
from deeplearning4j_tpu_torch.interop import export_params, load_jax_params
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.models import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.layers import attention as tatt

F32_TOL = 1e-5
BF16_STEPS = 4 * 2.0 ** -7
CONF = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_length=256)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ----------------------------------------------------------------- the layers
def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, g, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 16), (16,), (16,)))
    want = np.asarray(jatt._layer_norm(x, g, b))
    np.testing.assert_allclose(tatt._layer_norm(_t(x), _t(g), _t(b)).numpy(), want,
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,causal,masked,segmented", [
    (20, True, False, False), (20, False, True, False), (24, True, False, True),
    (1024, True, False, False), (1024, False, True, True)])
def test_dense_attention_matches_jax(T, causal, masked, segmented, dtype):
    """The einsum path below T 1024 and the blocked path at 1024 (a tiny
    head dim keeps the CPU cost low), with padding masks and segments."""
    rng = np.random.default_rng(T)
    b, h, hd = 2, 2, 4
    q, k, v = (rng.standard_normal((b, h, T, hd)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((b, T), np.float32)
        mask[1, T // 2:] = 0
    seg = None
    if segmented:
        seg = np.zeros((b, T), np.int32)
        seg[:, T // 3:] = 1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _np(jatt.dense_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                    causal=causal, mask=mask, segment_ids=seg))
    got = tatt.dense_attention(*(_t(a, tdt) for a in (q, k, v)), causal=causal,
                               mask=None if mask is None else _t(mask),
                               segment_ids=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=F32_TOL)
    elif T < tatt.BLOCKED_ATTENTION_MIN_T:  # the same bf16 ops in the same order:
        # equal up to one bf16 step where a GEMM sums in another order
        assert (np.abs(_np(got) - want) <= 2.0 ** -7 * np.abs(want) + 1e-30).all()
    else:  # JAX's scanned body fuses exp and the division: 2 roundings of p apart
        tq, tk, tv = (_t(a, tdt) for a in (q, k, v))
        p = tatt._softmax(tatt._masked(
            tatt._scores(tq, tk, hd ** -0.5), causal, None if mask is None else _t(mask),
            None if seg is None else torch.from_numpy(seg))).float()
        lim = (2 * 2.0 ** -8 * (p @ tv.float().abs())).numpy() + 2.0 ** -8 * np.abs(want)
        assert (np.abs(_np(got) - want) <= lim).all()


def _layer_pair(jlayer, n_in, T=None):
    """The JAX layer initialized at (n_in, T), its params as numpy, and the
    port's layer decoded from the JAX layer's serde dict."""
    it = JInputType.recurrent(n_in, T)
    jlayer.initialize(it)
    params = jax.tree_util.tree_map(np.asarray,
                                    jlayer.init_params(jax.random.PRNGKey(3), it))
    tlayer = serde.decode(json.loads(json.dumps(jserde.encode(jlayer))))
    assert type(tlayer).__name__ == type(jlayer).__name__
    return params, tlayer


@pytest.mark.parametrize("jlayer,masked", [
    (jatt.SelfAttentionLayer(n_in=16, n_heads=4, causal=True), False),
    (jatt.SelfAttentionLayer(n_in=16, n_out=8, n_heads=2), True),
    (jatt.TransformerBlock(n_in=16, n_heads=4), False),
    (jatt.TransformerBlock(n_in=16, n_heads=2, causal=False, mlp_ratio=2), True),
    (jatt.PositionalEmbeddingLayer(max_length=32), False),
    (jatt.PositionalEmbeddingLayer(mode="sinusoidal"), False),
    (jatt.LayerNormalization(), False),
], ids=["sa-causal", "sa-masked", "block", "block-masked", "pos-learned", "pos-sin", "ln"])
def test_attention_layers_eval_forward_matches_jax(jlayer, masked):
    params, tlayer = _layer_pair(jlayer, 16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 12), np.float32)
        mask[0, 7:] = 0
    want, _ = jlayer.apply(params, jnp.asarray(x), mask=None if mask is None
                           else jnp.asarray(mask))
    got, _ = tlayer.apply({k: _t(v) for k, v in params.items()}, _t(x),
                          mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_attention_layers_refuse_training():
    """No longer refused: a TransformerBlock trains with its eval forward,
    and ``dense_attention`` with a dropout rate drops entries of ``p`` (the
    mask fed in: all kept gives the undropped result; all dropped, zeros)."""
    from deeplearning4j_tpu_torch.nn.conf.dropouts import FedNoise

    params, tlayer = _layer_pair(jatt.TransformerBlock(n_in=8, n_heads=2), 8)
    tp = {k: _t(v) for k, v in params.items()}
    x = _t(np.random.default_rng(2).standard_normal((1, 4, 8)))
    assert torch.equal(tlayer.apply(tp, x, train=True)[0], tlayer.apply(tp, x)[0])
    q = _t(np.random.default_rng(3).standard_normal((1, 1, 8, 4)))
    plain = tatt.dense_attention(q, q, q, causal=True)
    kept = tatt.dense_attention(q, q, q, causal=True, dropout_rate=0.5,
                                dropout_rng=FedNoise([np.ones((1, 1, 8, 8), bool)]))
    torch.testing.assert_close(kept, 2 * plain, rtol=0, atol=F32_TOL)
    dropped = tatt.dense_attention(q, q, q, causal=True, dropout_rate=0.5,
                                   dropout_rng=FedNoise([np.zeros((1, 1, 8, 8), bool)]))
    assert not dropped.any()


def test_gelu_is_the_tanh_approximation():
    from deeplearning4j_tpu import activations as jact
    from deeplearning4j_tpu_torch import activations as tact

    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(tact.get("gelu")(_t(x)).numpy(), np.asarray(jact.gelu(x)),
                               rtol=0, atol=1e-6)


# --------------------------------------------------------------- TransformerLM
@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def lms(request):
    """(JAX model, port model on the CPU) with the same params; the head is
    scaled so the softmax is spread (greedy tokens are then not one token)."""
    cd = request.param
    jm = jlm.TransformerLM(compute_dtype=cd, **CONF).init()
    params = jax.tree_util.tree_map(np.asarray, jm.params_)
    params["head"] = params["head"] * np.float32(3.0)
    jm.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tm = TransformerLM(compute_dtype=cd, **CONF).init(device="cpu")
    load_jax_params(tm, params, None)
    return jm, tm, params


def _close(got, want, cd):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = F32_TOL if cd is None else BF16_STEPS * float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    return float(np.abs(got - want).max())


def test_config_params_and_interop_round_trip(lms):
    jm, tm, params = lms
    assert tm.cfg.to_dict() == jm.cfg.to_dict()
    assert tlm.TransformerLMConfig.from_dict(jm.cfg.to_dict()).to_dict() == tm.cfg.to_dict()
    assert tm.num_params() == jm.num_params()
    back = export_params(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    fresh = tlm.init_params(tm.cfg)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, fresh)) == \
        jax.tree_util.tree_structure(params)
    assert all(tuple(a.shape) == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(fresh), jax.tree_util.tree_leaves(params)))


@pytest.mark.parametrize("T", [20, 128, 200])
def test_forward_matches_jax(lms, T):
    jm, tm, _ = lms
    ids = np.random.default_rng(T).integers(0, 64, (2, T)).astype(np.int32)
    got = tm.logits(ids)
    assert got.dtype == np.float32 and got.shape == (2, T, 64)
    _close(got, jm.logits(ids), jm.cfg.compute_dtype)
    # pos_offset and a replaced attention function
    want = jlm.forward(jm.cfg, jm.params_, jnp.asarray(ids[:, :16]), pos_offset=3)
    got = tlm.forward(tm.cfg, tm.params_, torch.from_numpy(ids[:, :16]).long(), pos_offset=3,
                      attn_fn=tatt.dense_attention)
    _close(_np(got), want, jm.cfg.compute_dtype)


_JITTED = {}


def _jitted(cfg):
    """JAX's prefill and decode step, jitted once per compute dtype."""
    key = cfg.compute_dtype
    if key not in _JITTED:
        _JITTED[key] = (
            jax.jit(lambda p, c, i, n: jlm.prefill_cache(cfg, p, c, i, length=n)),
            jax.jit(lambda p, c, t: jlm.decode_step(cfg, p, c, t)))
    return _JITTED[key]


@pytest.mark.parametrize("Tp,length", [(32, 20), (256, 129)])
def test_prefill_and_decode_steps_match_jax(lms, Tp, length):
    jm, tm, _ = lms
    cfg_j, cfg_t, cd = jm.cfg, tm.cfg, jm.cfg.compute_dtype
    rng = np.random.default_rng(Tp + length)
    ids = np.zeros((2, Tp), np.int32)
    ids[:, :length] = rng.integers(0, 64, (2, length))
    j_prefill, j_decode = _jitted(cfg_j)
    jc = jlm.init_decode_cache(cfg_j, 2)
    jl, jc = j_prefill(jm.params_, jc, jnp.asarray(ids), jnp.asarray(length, jnp.int32))
    tc = tlm.init_decode_cache(cfg_t, 2)
    with torch.inference_mode():
        tl, tc = tlm.prefill_cache(cfg_t, tm.compute_params(), tc,
                                   torch.from_numpy(ids).long(), length=length)
    _close(_np(tl), jl, cd)
    assert int(tc["pos"]) == int(jc["pos"]) == length
    _close(_np(tc["k"][:, :, :, :Tp]), jc["k"][:, :, :, :Tp], cd)
    _close(_np(tc["v"]), jc["v"], cd)
    # a scalar-position step, then per-row positions (one past the slab's
    # end: the clip-mode position gather and the clamped write)
    tok = rng.integers(0, 64, 2).astype(np.int32)
    jl, jc = j_decode(jm.params_, jc, jnp.asarray(tok))
    with torch.inference_mode():
        tl, tc = tlm.decode_step(cfg_t, tm.compute_params(), tc, torch.from_numpy(tok).long())
    _close(_np(tl), jl, cd)
    assert int(tc["pos"]) == int(jc["pos"]) == length + 1
    pos = np.array([length + 1, 255], np.int32)
    jc = {**jc, "pos": jnp.asarray(pos)}
    tc = {**tc, "pos": torch.from_numpy(pos).long()}
    jl, jc = j_decode(jm.params_, jc, jnp.asarray(tok))
    with torch.inference_mode():
        tl, tc = tlm.decode_step(cfg_t, tm.params_, tc, torch.from_numpy(tok).long())
    _close(_np(tl), jl, cd)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(_np(tc["k"]), jc["k"], cd)
    _close(_np(tc["v"]), jc["v"], cd)


def test_decode_past_the_window_clips_the_position(lms):
    """A row at pos >= max_length reads the last position-table row and
    writes the slab's last column (the reference's ``jnp.take`` fills NaN
    there instead, ROADMAP § C)."""
    _, tm, _ = lms
    cache = tlm.init_decode_cache(tm.cfg, 2)
    tok = torch.tensor([3, 4])
    with torch.inference_mode():
        at, _ = tlm.decode_step(tm.cfg, tm.params_, {**cache, "pos": torch.tensor([255, 300])},
                                tok)
        k_row = cache["k"][:, 1, :, 255].clone()
        again, _ = tlm.decode_step(tm.cfg, tm.params_,
                                   {**tlm.init_decode_cache(tm.cfg, 2),
                                    "pos": torch.tensor([255, 255])}, tok)
    assert torch.isfinite(at).all() and k_row.abs().sum() > 0
    torch.testing.assert_close(at, again, rtol=0, atol=0)


def _first_divergence(a, b):
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return None if diff.size == 0 else int(diff[0])


@pytest.mark.parametrize("prompt_len", [5, 127, 128, 129, 200])
def test_generate_cached_greedy_tokens_match_jax(lms, prompt_len):
    jm, tm, _ = lms
    p = np.random.default_rng(prompt_len).integers(0, 64, (1, prompt_len)).astype(np.int32)
    max_new = 12
    want = jm.generate_cached(p, max_new=max_new)
    got = tm.generate_cached(p, max_new=max_new)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :prompt_len], p)
    j = _first_divergence(got[0, prompt_len:], want[0, prompt_len:])
    if jm.cfg.compute_dtype is None:
        assert j is None
        assert len(set(got[0, prompt_len:].tolist())) > 2
    elif j is not None:  # bf16: only where JAX's top-2 gap is within the noise
        logits = jm.logits(want[:, :prompt_len + j])[0, -1]
        d = _close(tm.logits(want[:, :prompt_len + j]), jm.logits(want[:, :prompt_len + j]),
                   "bfloat16")
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * d
    # the host loop of full forwards gives the same greedy tokens (f32)
    if jm.cfg.compute_dtype is None and prompt_len == 5:
        np.testing.assert_array_equal(tm.generate(p, max_new=max_new), got)


def test_perplexity_matches_jax(lms):
    jm, tm, _ = lms
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 64, (2, 40)).astype(np.int32)
    tgt = rng.integers(0, 64, (2, 40)).astype(np.int32)
    tgt[1, 30:] = -1
    want, got = jm.perplexity(ids, tgt), tm.perplexity(ids, tgt)
    rtol = 1e-5 if jm.cfg.compute_dtype is None else 2e-2
    assert abs(got - want) <= rtol * want


def test_sampled_generation_is_seeded_and_valid(lms):
    _, tm, _ = lms
    p = np.arange(10)[None] % 64
    a = tm.generate_cached(p, max_new=12, temperature=0.9, top_k=8, rng=tlm.new_key(5))
    b = tm.generate_cached(p, max_new=12, temperature=0.9, top_k=8, rng=tlm.new_key(5))
    c = tm.generate_cached(p, max_new=12, temperature=0.9, top_k=8, rng=tlm.new_key(6))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and a.min() >= 0 and a.max() < 64
    with pytest.raises(tlm.ContextWindowExceeded):
        tm.generate_cached(np.zeros((1, 250), np.int32), max_new=10)


# ----------------------------------------------------------------- refusals
def test_typed_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(n_experts=4, **CONF).init(device="cpu")
    tm = TransformerLM(**CONF).init(device="cpu")
    ids = np.zeros((1, 8), np.int32)
    # training is ported: fit_batch takes a step, lm_loss carries gradients
    assert math.isfinite(tm.fit_batch(ids, ids)) and tm.iteration == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.decode_steps(tm.cfg, tm.params_, tlm.init_decode_cache(tm.cfg, 1),
                         torch.zeros(1, 2, dtype=torch.long))
    layer0 = {k: v[0] for k, v in tm.params_["blocks"].items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.block_apply(tm.cfg, layer0, torch.zeros(1, 4, 32), tp_axis="model")
    head = tm.params_["head"].detach().requires_grad_()
    tlm.lm_loss(tm.cfg, {**tm.params_, "head": head}, torch.zeros(1, 4, dtype=torch.long),
                torch.zeros(1, 4, dtype=torch.long)).backward()
    assert head.grad is not None and float(head.grad.abs().sum()) > 0


# ------------------------------------------------------- compute_params' cache
def _c1_model():
    return TransformerLM(vocab_size=50, d_model=32, n_heads=4, n_layers=1, max_length=64,
                         compute_dtype="bfloat16").init(device="cpu")


def _uncached(tm, ids):
    with torch.inference_mode():
        return tlm.forward(tm.cfg, tlm.compute_params(tm.cfg, tm.params_),
                           torch.from_numpy(ids)).numpy()


def test_compute_params_follows_replaced_params():
    """ROADMAP § C1: keyed on ``(id, _version)``, the cache served the cast
    of a freed head once a new tensor took its ``id`` (49 of 50 trials of
    this sequence). Keyed on the tensors themselves, ``logits`` equals the
    uncached forward after every replacement and every in-place change."""
    tm = _c1_model()
    ids = np.random.default_rng(0).integers(0, 50, (2, 16))
    for trial in range(20):
        tm.logits(ids)
        for _ in range(2):
            tm.params_["head"] = torch.randn_like(tm.params_["head"])
        np.testing.assert_array_equal(tm.logits(ids), _uncached(tm, ids), err_msg=str(trial))
    with torch.no_grad():
        tm.params_["blocks"]["W1"].mul_(2.0)
    np.testing.assert_array_equal(tm.logits(ids), _uncached(tm, ids))


def test_logits_follow_fit_batch():
    tm = _c1_model()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (2, 16))
    tgt = np.roll(ids, -1, axis=1)
    tgt[:, -1] = -1
    before = tm.logits(ids)
    tm.fit_batch(ids, tgt)
    after = tm.logits(ids)
    np.testing.assert_array_equal(after, _uncached(tm, ids))
    assert not np.array_equal(after, before)
