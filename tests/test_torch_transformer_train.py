"""TransformerLM training in the port against the JAX package on the CPU,
with params and updater slots carried through ``interop``.

- ``fit_batch`` (default ``Adam(3e-4)``) over 4 steps from a run that JAX
  began (its params, Adam slots and iteration carried over): f32 and bf16,
  dense and packed (``segment_ids``, two documents per row, the boundary
  targets -1). f32: the losses within 1e-5 and the params and slots within
  1e-6 after the steps (both read ~1e-7). bf16: torch's tanh-gelu rounds
  once where XLA rounds op by op (``test_torch_transformer``), so the losses
  agree within 2e-3 relative (read 3e-4) and the params within 6 lr (read 3
  lr): Adam turns every gradient into a step of about ``lr`` whatever its
  size, so where a gradient is near 0 and the two packages' bf16 roundings
  give it other signs, a step goes +lr in one and -lr in the other.
- The whole model's gradient at T 128 through the port's ``FlashAttention``
  (plain forward and backward on the CPU) against ``jax.grad`` of JAX's
  ``lm_loss(attn_fn=flash_attention(interpret=True))``, f32, per tensor
  within rtol 1e-4 / atol 1e-6 (the reference's flash gradient test, with
  an absolute floor scaled to gradients of a loss averaged over 256
  tokens).
- The query-blocked attention path at T 1024 (recomputed per block in the
  backward): gradients against JAX's, f32 within 1e-5.
- Adam's update against JAX's ``Adam.apply`` at steps 1 to 5.
- A run carried JAX -> port -> JAX continues as JAX alone runs it; the
  port's ``export_opt_state`` is JAX's layout.
- ``perplexity`` after training equals JAX's after the same training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.layers import attention as jatt
from deeplearning4j_tpu.nn.ops.flash_attention import flash_attention as jflash
from deeplearning4j_tpu.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.interop import export_opt_state, export_params, load_jax_params
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.models import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa
from deeplearning4j_tpu_torch.updaters import Adam

CONF = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_length=128)
B, T = 2, 64
LR = 3e-4
F32_LOSS_TOL = 1e-5
F32_PARAM_TOL = 1e-6
BF16_LOSS_RTOL = 2e-3
BF16_PARAM_TOL = 6 * LR


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _batch(seed, packed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, (B, T)).astype(np.int32)
    tgt = np.roll(ids, -1, axis=1).astype(np.int32)
    tgt[:, -1] = -1
    seg = None
    if packed:  # two documents per row, cut off the port's 64-row tiles
        seg = np.zeros((B, T), np.int32)
        seg[0, 23:] = 1
        seg[1, 41:] = 1
        tgt[0, 22] = tgt[1, 40] = -1
    return ids, tgt, seg


def _pair(cd):
    """A JAX model two steps into a run and the port's model carrying its
    params, Adam slots and iteration."""
    jm = jlm.TransformerLM(compute_dtype=cd, **CONF).init()
    ids, tgt, _ = _batch(0, False)
    for _ in range(2):
        jm.fit_batch(ids, tgt)
    tm = TransformerLM(compute_dtype=cd, **CONF).init(device="cpu")
    load_jax_params(tm, _tree(jm.params_), None, opt_state=_tree(jm.opt_state_),
                    iteration=jm.iteration)
    return jm, tm


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_fit_batch_tracks_jax(cd, packed):
    jm, tm = _pair(cd)
    ids, tgt, seg = _batch(1, packed)
    want = [jm.fit_batch(ids, tgt, segment_ids=seg) for _ in range(4)]
    got = [tm.fit_batch(ids, tgt, segment_ids=seg) for _ in range(4)]
    assert tm.iteration == jm.iteration == 6 and got[-1] < got[0]
    dp = _max_diff(export_params(tm), _tree(jm.params_))
    if cd is None:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_LOSS_TOL)
        assert dp <= F32_PARAM_TOL, dp
        assert _max_diff(export_opt_state(tm), _tree(jm.opt_state_)) <= F32_PARAM_TOL
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL, atol=0)
        assert dp <= BF16_PARAM_TOL, dp


def test_model_gradient_through_the_flash_function_matches_jax():
    jm = jlm.TransformerLM(**{**CONF, "max_length": 128}).init()
    params = _tree(jm.params_)
    tm = TransformerLM(**CONF).init(device="cpu")
    load_jax_params(tm, params, None)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (B, 128)).astype(np.int32)
    tgt = np.roll(ids, -1, axis=1).astype(np.int32)
    tgt[:, -1] = -1

    def jattn(q, k, v, *, causal, mask=None):
        return jflash(q, k, v, causal=causal, interpret=True)

    want = _tree(jax.grad(lambda p: jlm.lm_loss(jm.cfg, p, jnp.asarray(ids), jnp.asarray(tgt),
                                                attn_fn=jattn))(jm.params_))

    def tattn(q, k, v, *, causal, mask=None):
        return fa.flash_attention(q, k, v, causal=causal)

    tids, ttgt = torch.from_numpy(ids).long(), torch.from_numpy(tgt).long()
    _, grads = tlm.value_and_grad(lambda p: tlm.token_nll(
        tlm.forward(tm.cfg, p, tids, attn_fn=tattn, cast_logits=False), ttgt)[0], tm.params_)
    for g, w, path in zip(jax.tree_util.tree_leaves(_tree(grads)), jax.tree_util.tree_leaves(want),
                          jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=str(path[0]))


def test_blocked_attention_gradients_match_jax():
    """T 1024 takes the query-blocked path in both packages (JAX's under
    ``jax.checkpoint``, the port's under ``torch.utils.checkpoint``)."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((1, 2, 1024, 8)).astype(np.float32) for _ in range(4))
    seg = np.zeros((1, 1024), np.int32)
    seg[:, 300:] = 1

    def jloss(q_, k_, v_):
        return jnp.sum(jatt.dense_attention(q_, k_, v_, causal=True, segment_ids=seg) * do)

    want = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tatt.dense_attention(tq, tk, tv, causal=True, segment_ids=seg)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)


def test_adam_matches_jax_at_the_tested_steps():
    rng = np.random.default_rng(3)
    g, m, v = (rng.standard_normal(50).astype(np.float32) for _ in range(3))
    v = np.abs(v)
    for t in range(1, 6):
        ju, js = JAdam(LR).apply(jnp.asarray(g), {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                                 jnp.asarray(t, jnp.int32), jnp.asarray(t, jnp.int32), 0)
        tu, ts = Adam(LR).apply(torch.from_numpy(g), {"m": torch.from_numpy(m),
                                                      "v": torch.from_numpy(v)}, t, t, 0)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=0)
        for key in ("m", "v"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_a_run_carried_jax_port_jax_continues():
    jm, tm = _pair(None)           # 2 JAX steps, carried into the port
    ids, tgt, _ = _batch(2, False)
    ref = jlm.TransformerLM(**CONF).init()
    ref.params_, ref.opt_state_, ref.iteration = jm.params_, jm.opt_state_, jm.iteration
    want = [ref.fit_batch(ids, tgt) for _ in range(3)]
    got = [tm.fit_batch(ids, tgt) for _ in range(2)]
    back = jlm.TransformerLM(**CONF).init()
    back.params_ = jax.tree_util.tree_map(jnp.asarray, export_params(tm))
    back.opt_state_ = jax.tree_util.tree_map(jnp.asarray, export_opt_state(tm))
    back.iteration = tm.iteration
    got.append(back.fit_batch(ids, tgt))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_LOSS_TOL)
    assert back.iteration == ref.iteration == 5
    assert _max_diff(_tree(back.params_), _tree(ref.params_)) <= F32_PARAM_TOL


def test_perplexity_after_training_matches_jax():
    jm, tm = _pair(None)
    ids, tgt, _ = _batch(3, False)
    before = tm.perplexity(ids, tgt)
    for _ in range(2):
        jm.fit_batch(ids, tgt)
        tm.fit_batch(ids, tgt)
    want, got = jm.perplexity(ids, tgt), tm.perplexity(ids, tgt)
    assert got < before and abs(got - want) <= 1e-5 * want
