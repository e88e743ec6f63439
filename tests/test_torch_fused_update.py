"""The port's one-pass Adam (``nn/ops/fused_update.py``) on the CPU.

The kernel (``csrc/fused_update.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2g); here the
wrapper takes its plain version, which is held:

- bit for bit (``torch.equal``) against the port's ``Adam.apply`` and
  ``param - update``: the contract the kernel keeps on the card;
- within one unit in the last place against the JAX package's
  ``Adam.apply`` composition on the same numpy inputs. Both packages round
  every f32 operation, but the bias correction's ``beta ** t`` goes through
  two libraries' ``pow``, which may differ in the last place; so m' and v'
  (which do not read alpha) are held bit for bit, and p' to one ulp of
  the update plus one ulp of p' (the rounding of the subtraction).
  The JAX interpret-mode Pallas leg is not the oracle: it fails on this
  tree (ROADMAP § C).

Inputs are made with numpy from a seed; v is non-negative (a running mean
of squares).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
from deeplearning4j_tpu_torch.parallel.zero import ShardedUpdateLayout

SIZES = [1, 3, 4095, 4097, 1000]
STEPS = [1, 2, 10, 1000]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return p, g, m * 0.1, v * 0.01


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _adam(lr=1e-3):
    return tupd.Adam(lr, 0.9, 0.999, 1e-8)


def _eager(upd, p, g, m, v, t):
    delta, st = upd.apply(g, {"m": m, "v": v}, t, t - 1, 0)
    return p - delta, st["m"], st["v"]


@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_version_is_adam_apply_bit_for_bit(n, t):
    upd = _adam()
    p, g, m, v = _torch(*_inputs(n, seed=n + t))
    want = _eager(upd, p, g, m, v, t)
    got = fu.fused_adam_apply(p, g, m, v, upd.alpha(t, t - 1, 0), b1=0.9, b2=0.999, eps=1e-8)
    for name, a, b in zip("pmv", got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("t", STEPS)
def test_alpha_is_adam_apply_scalar_pipeline(t):
    """``Adam.alpha`` is the expression ``Adam.apply`` used inline: one f32
    value on both paths (the group impl calls it too, and gives
    ``Adam.apply``'s bits: test_group_impl_is_the_reference_update)."""
    upd = _adam(3e-4)
    tf = torch.tensor(float(t), dtype=torch.float32)
    inline = (upd.lr(t - 1, 0) * torch.sqrt(1 - 0.999 ** tf) / (1 - 0.9 ** tf))
    alpha = upd.alpha(t, t - 1, 0)
    assert alpha.dtype == torch.float32 and alpha.dim() == 0
    assert torch.equal(alpha, inline)
    # and Adam.apply's update is alpha * m' / (sqrt(v') + eps) with it
    p, g, m, v = _torch(*_inputs(64, seed=t))
    delta, st = upd.apply(g, {"m": m, "v": v}, t, t - 1, 0)
    assert torch.equal(delta, alpha * st["m"] / (torch.sqrt(st["v"]) + 1e-8))


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("t", STEPS)
def test_plain_version_within_one_ulp_of_jax(t):
    n = 4097
    p, g, m, v = _inputs(n, seed=7 * t)
    jad = jupd.Adam(1e-3, 0.9, 0.999, 1e-8)
    delta, st = jad.apply(jnp.asarray(g), {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                          jnp.asarray(t, jnp.int32), jnp.asarray(t - 1, jnp.int32),
                          jnp.asarray(0, jnp.int32))
    jp = np.asarray(jnp.asarray(p) - delta)
    jm, jv, jdelta = np.asarray(st["m"]), np.asarray(st["v"]), np.asarray(delta)
    upd = _adam()
    tp, tm, tv = (a.numpy() for a in fu.fused_adam_apply(
        *_torch(p, g, m, v), upd.alpha(t, t - 1, 0), b1=0.9, b2=0.999, eps=1e-8))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    assert np.all(np.abs(tp - jp) <= _ulp(jdelta) + _ulp(jp)), float(np.abs(tp - jp).max())


def test_padding_lanes_stay_zero():
    """A group of 66 elements padded to 4 shards of 17: the two padding
    lanes are zero in p, g, m and v and stay zero through the update."""
    layers = [SimpleNamespace(updater=_adam()), SimpleNamespace(updater=_adam())]
    rng = np.random.default_rng(3)
    params = [{"W": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))},
              {"W": torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(3).astype(np.float32))}]
    layout = ShardedUpdateLayout(layers, params, 4)
    (grp,) = layout.groups
    assert (grp.total, grp.padded, grp.chunk, layout.n_padding()) == (66, 68, 17, 2)
    p2d = layout._flatten_group(grp, params)
    g2d = layout._flatten_group(grp, [{k: t * 0.5 for k, t in p.items()} for p in params])
    m2d, v2d = g2d * 0.1, (g2d * g2d) * 0.01
    upd = _adam()
    for t in (1, 2, 3):
        p2d, m2d, v2d = fu.fused_adam_apply(p2d, g2d, m2d, v2d, upd.alpha(t, t - 1, 0),
                                            b1=0.9, b2=0.999, eps=1e-8)
        for a in (p2d, m2d, v2d):
            assert a.shape == (4, 17)
            assert torch.equal(a.reshape(-1)[66:], torch.zeros(2))


def test_resolve_group_impls_takes_exact_type_f32_adam_only():
    class MyAdam(tupd.Adam):
        pass

    def w(dtype):
        return {"W": torch.zeros((2, 2), dtype=dtype)}

    layers = [SimpleNamespace(updater=u) for u in
              (_adam(), tupd.Nesterovs(1e-2, 0.9), MyAdam(1e-3), _adam(2e-3), _adam(),
               tupd.Sgd(0.1))]
    params = [w(torch.float32), w(torch.float32), w(torch.float32), w(torch.float32),
              w(torch.bfloat16), w(torch.float32)]
    layout = ShardedUpdateLayout(layers, params, 2)
    kinds = [(type(g.updater).__name__, g.dtype) for g in layout.groups]
    impls = fu.resolve_group_impls(layout)
    got = [impl is not None for impl in impls]
    assert kinds == [("Adam", torch.float32), ("Nesterovs", torch.float32),
                     ("MyAdam", torch.float32), ("Adam", torch.float32),
                     ("Adam", torch.bfloat16), ("Sgd", torch.float32)]
    assert got == [True, False, False, True, False, False]


def test_group_impl_is_the_reference_update():
    """The impl the sharded step calls gives ``updater.apply`` and the
    subtraction, bit for bit, on a (N, chunk) group."""
    upd = _adam(5e-3)
    p, g, m, v = (a.reshape(4, 1024) for a in _torch(*_inputs(4096, seed=11)))
    new_p, st = fu._make_impl()(upd, p, g, {"m": m, "v": v}, 5, 4, 0)
    want = _eager(upd, p, g, m, v, 5)
    assert torch.equal(new_p, want[0])
    assert torch.equal(st["m"], want[1]) and torch.equal(st["v"], want[2])


def test_kernel_argument_checks_refuse_off_the_card():
    """Tensors off the CPU reach the kernel's checks: ``meta`` tensors (no
    card needed) and CPU tensors handed to the kernel path are refused."""
    meta = [torch.empty(8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu.fused_adam_apply(*meta, 1e-3, b1=0.9, b2=0.999, eps=1e-8)
    cpu = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu._kernel(*cpu, 1e-3, 0.9, 0.999, 1e-8)
