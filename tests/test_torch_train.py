"""The port's training path against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; weights move
between them as arrays (``interop``), never by seed. The JAX fused block
runs its reference path here (its Pallas probe fails off the TPU), which is
the port's CPU path: the plain forward versions under autograd.

Tolerances (per tensor, relative error ||port - jax|| / ||jax|| unless
stated):
- float32: F32_TOL (1e-4) for single layers and the narrow graph: the two
  compute the same f32 operations, only summation order differs.
  ResNet-50 F32_RESNET_TOL (1e-3): its train-mode BN backward subtracts
  per-channel means over as few as 4 values (batch 4 at 1x1 in the last
  stage), which amplifies f32 order differences; measured 1.9e-4.
- bfloat16 block and BN gradients BF16_LAYER_GRAD_TOL (5e-2, the JAX
  probe's bound): both round to bf16 at the same points, but the gradient
  of a bf16 scale is a per-channel bf16 sum (e.g. sum dy*z) whose one-step
  rounding difference survives the cancellation against the shift's term;
  measured 0.025 (gamma_c).
- bfloat16 whole-network gradients: at these sizes bf16 rounding noise
  dominates the gradients in BOTH packages (JAX's own bf16 gradients of
  ResNet-50 differ from its f32 ones by 150% median, of the narrow graph by
  10%). So each tensor is held to NOISE_FACTOR (2) times the larger of the
  two packages' own bf16-vs-f32 distance on the same inputs, and the median
  over tensors to that median: the port is no further from JAX than bf16 is
  from f32. Scores and weights, which the noise barely moves, get fixed
  bounds.
- Max-pool ties: at equal values in a window XLA's select-and-scatter and
  ``F.max_pool2d`` may route the gradient to different elements. After a
  ReLU the tied values are zeros whose upstream gradient is 0 either way,
  so the f32 bounds hold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import losses as jlosses
from deeplearning4j_tpu import regularization as jreg
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.resnet50 import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import losses as tlosses
from deeplearning4j_tpu_torch import regularization as treg
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import ResNet50 as TResNet50
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph

F32_TOL = 1e-4
F32_RESNET_TOL = 1e-3
BF16_LAYER_GRAD_TOL = 5e-2
NOISE_FACTOR = 2.0
LR = 1e-3  # the zoo's Nesterovs(0.1) diverges on random data


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def randomize_bn(params, state, seed):
    """Seeded BN running stats and affine params on numpy dicts, in place;
    each branch's last BN gets a small gamma (unsaturated softmax)."""
    rng = np.random.default_rng(seed)
    for v in sorted(params):
        for k in sorted(params[v]):
            a = params[v][k]
            if k.startswith("gamma"):
                lo, hi = (0.1, 0.3) if k == "gamma_c" else (0.5, 1.5)
                params[v][k] = rng.uniform(lo, hi, a.shape).astype(np.float32)
            elif k.startswith("beta"):
                params[v][k] = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    for v in sorted(state):
        for k in sorted(state[v]):
            a = state[v][k]
            if k.startswith("mean"):
                state[v][k] = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            elif k.startswith("var"):
                state[v][k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# --------------------------------------------------------------------- block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,project", [(1, False), (1, True), (2, True)],
                         ids=["identity", "project", "stride2"])
def test_bottleneck_train_matches_jax(stride, project, dtype):
    """Value, new running state and gradients (params and input) of one
    train-mode block under one seeded cotangent."""
    width = 8
    cin = 12 if project else 4 * width
    it = jconf.InputType.convolutional(9, 11, cin)
    jl = jlayers.FusedResNetBottleneck(width=width, stride=stride, project=project)
    tl = tlayers.FusedResNetBottleneck(width=width, stride=stride, project=project)
    jl.initialize(it)
    tl.initialize(tconf.InputType.convolutional(9, 11, cin))
    params = {"b": {k: np.array(v) for k, v in
                    jl.init_params(jax.random.PRNGKey(3), it).items()}}
    state = {"b": {k: np.array(v) for k, v in jl.init_layer_state(it).items()}}
    randomize_bn(params, state, 5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 11, cin)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    names = sorted(params["b"])
    jp = {k: jnp.asarray(v, jdt if k.startswith("W") else jnp.float32)
          for k, v in params["b"].items()}
    js = {k: jnp.asarray(v) for k, v in state["b"].items()}

    def jfun(p, x_):
        return jl.apply(p, x_, state=js, train=True)

    jy, vjp, jns = jax.vjp(jfun, jp, jnp.asarray(x, jdt), has_aux=True)
    dy = (rng.standard_normal(jy.shape) * 0.1).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(dy, jdt))

    tp = {k: torch.from_numpy(v).to(tdt if k.startswith("W") else torch.float32)
          .requires_grad_() for k, v in params["b"].items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = {k: torch.from_numpy(v) for k, v in state["b"].items()}
    ty, tns = tl.apply(tp, tx, state=ts, train=True)
    grads = torch.autograd.grad(ty, [tp[k] for k in names] + [tx],
                                torch.from_numpy(dy).to(tdt))
    assert sorted(tns) == sorted(jns)
    assert all(not v.requires_grad for v in tns.values())

    jy, ty = _np(jy), _np(ty)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
        for k in jns:
            np.testing.assert_allclose(_np(tns[k]), _np(jns[k]), rtol=1e-5, atol=1e-6)
        grad_tol = F32_TOL
    else:
        err = np.abs(ty - jy)
        assert err.max() <= 4 * 2.0 ** -7 * np.abs(jy).max(), err.max()
        for k in jns:
            assert rel(_np(tns[k]), _np(jns[k])) <= 2.0 ** -7, k
        grad_tol = BF16_LAYER_GRAD_TOL
    for k, g in zip(names, grads):
        assert rel(_np(g), _np(jgp[k])) <= grad_tol, (k, rel(_np(g), _np(jgp[k])))
    assert rel(_np(grads[-1]), _np(jgx)) <= grad_tol


def test_bottleneck_output_tie_gradient_is_the_references():
    """x = 0 and beta = 0: every fold and the block output sit exactly on
    their ReLU's tie, and each batch variance on max(., 0)'s. The gradients
    are JAX's (0.5 at a tie, as jnp.maximum gives; torch.relu would give 0
    and clamp_min 1)."""
    it = jconf.InputType.convolutional(4, 4, 16)
    jl = jlayers.FusedResNetBottleneck(width=4)
    tl = tlayers.FusedResNetBottleneck(width=4)
    jl.initialize(it)
    tl.initialize(tconf.InputType.convolutional(4, 4, 16))
    params = {k: np.array(v) for k, v in jl.init_params(jax.random.PRNGKey(1), it).items()}
    state = {k: np.array(v) for k, v in jl.init_layer_state(it).items()}
    x = np.zeros((2, 4, 4, 16), np.float32)
    dy = np.random.default_rng(2).standard_normal((2, 4, 4, 16)).astype(np.float32)

    def jloss(p, x_):
        y, _ = jl.apply(p, x_, state={k: jnp.asarray(v) for k, v in state.items()},
                        train=True)
        return jnp.sum(y * dy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = tl.apply(tp, tx, state={k: torch.from_numpy(v) for k, v in state.items()},
                     train=True)
    assert float(ty.detach().abs().max()) == 0.0
    (ty * torch.from_numpy(dy)).sum().backward()
    # with relu at the output the input gradient would be 0 here, with
    # clamp_min twice JAX's; the gradients are huge (var = 0 -> 1/sqrt(eps))
    assert np.abs(np.asarray(jgx)).max() > 1.0
    assert rel(tx.grad.numpy(), jgx) <= 1e-5
    for k in params:
        # atol: a few entries are pure cancellation (|g| ~ 5e-5)
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


# ------------------------------------------------------------------------ BN
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    beta = (rng.standard_normal(7) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(7) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jl, tl = jlayers.BatchNormalization(), tlayers.BatchNormalization()
    js = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def jfun(p, x_):
        return jl.apply(p, x_, state=js, train=True)

    jy, vjp, jns = jax.vjp(jfun, {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
                           jnp.asarray(x, jdt), has_aux=True)
    jgp, jgx = vjp(jnp.asarray(dy, jdt))
    tp = {"gamma": torch.from_numpy(gamma).requires_grad_(),
          "beta": torch.from_numpy(beta).requires_grad_()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty, tns = tl.apply(tp, tx, state={"mean": torch.from_numpy(mean),
                                      "var": torch.from_numpy(var)}, train=True)
    ty.backward(torch.from_numpy(dy).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(tns[k]), _np(jns[k]), rtol=1e-5, atol=1e-6)
    assert rel(_np(ty), _np(jy)) <= tol
    for name, g, r in (("gamma", tp["gamma"].grad, jgp["gamma"]),
                       ("beta", tp["beta"].grad, jgp["beta"]), ("x", tx.grad, jgx)):
        assert rel(_np(g), _np(r)) <= (F32_TOL if dtype == "float32"
                                       else BF16_LAYER_GRAD_TOL), name


# ---------------------------------------------------------- loss, reg, updaters
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
def test_mcxent_matches_jax(activation, masked):
    """The log-softmax path and the clip path, with and without a mask:
    per-example values and the gradient in the logits."""
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    mask = (rng.uniform(size=(6, 1)) > 0.3).astype(np.float32) if masked else None

    def jf(z):
        return jlosses.get("mcxent")(jnp.asarray(labels), z, activation,
                                     None if mask is None else jnp.asarray(mask))

    jv, jvjp = jax.vjp(jf, jnp.asarray(logits))
    (jg,) = jvjp(jnp.ones_like(jv))
    tz = torch.from_numpy(logits).requires_grad_()
    tv = tlosses.get("mcxent")(torch.from_numpy(labels), tz, activation,
                               None if mask is None else torch.from_numpy(mask))
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_losses_not_ported_raise():
    """Every reference loss is ported now (``tests/test_torch_losses.py``
    holds each against JAX): a name the reference lacks still raises."""
    assert tlosses.get("mse") is tlosses.mse
    with pytest.raises(ValueError):
        tlosses.get("no_such_loss")


def test_regularization_matches_jax():
    """grad_term/score_term on the same arrays, and the reference's bias
    rule: a name starting with 'b' is a bias, so beta_* takes the bias
    coefficients (none here) while gamma_* and W_* take l2."""
    kw = dict(l1=3e-4, l2=1e-4, weight_decay=2e-4)
    jr, tr = jreg.RegularizationConf(**kw), treg.RegularizationConf(**kw)
    assert tserde.encode(tr) == jserde.encode(jr)
    rng = np.random.default_rng(9)
    for name in ("W_a", "gamma_b", "beta_c", "b", "bias_x"):
        p = rng.standard_normal((3, 4)).astype(np.float32)
        jt, tt = jr.grad_term(name, jnp.asarray(p)), tr.grad_term(name, torch.from_numpy(p))
        assert (jt is None) == (tt is None), name
        if jt is not None:
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(tr.score_term(name, torch.from_numpy(p))),
                                   float(jr.score_term(name, jnp.asarray(p))), rtol=1e-6)
    assert tr.coeffs_for("beta_a") == (0.0, 0.0, 0.0)
    assert tr.coeffs_for("gamma_a") == (3e-4, 1e-4, 2e-4)
    back = treg.as_regularization(tserde.decode(tserde.encode(tr)))
    assert back == tr and back.grad_term("W", torch.ones(2)) is not None


@pytest.mark.parametrize("mode", ["renormalize_l2_per_layer", "renormalize_l2_per_param_type",
                                  "clip_element_wise_absolute_value", "clip_l2_per_layer",
                                  "clip_l2_per_param_type", "none"])
def test_gradient_normalization_matches_jax(mode):
    """Each gradient-normalization mode on the same gradient dict (norms
    above the threshold for W, below it for b, so both clip branches run)."""
    rng = np.random.default_rng(16)
    grads = {"W": (rng.standard_normal((6, 5)) * 2).astype(np.float32),
             "b": (rng.standard_normal(5) * 0.05).astype(np.float32)}
    want = jreg.normalize_layer_gradients({k: jnp.asarray(v) for k, v in grads.items()},
                                          mode, threshold=0.5)
    got = treg.normalize_layer_gradients({k: torch.from_numpy(v) for k, v in grads.items()},
                                         mode, threshold=0.5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


UPDATERS = {
    "Sgd": (lambda: jupd.Sgd(0.05), lambda: tupd.Sgd(0.05)),
    "NoOp": (jupd.NoOp, tupd.NoOp),
    "Nesterovs": (lambda: jupd.Nesterovs(1e-3, 0.9), lambda: tupd.Nesterovs(1e-3, 0.9)),
    "Adam": (lambda: jupd.Adam(2e-3), lambda: tupd.Adam(2e-3)),
}


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_apply_matches_jax(name):
    """Three apply steps on the same gradients; the config dict is the
    reference's and the port reads the reference's JSON back into an
    updater that computes the same."""
    jmake, tmake = UPDATERS[name]
    ju, tu = jmake(), tmake()
    enc = jserde.encode(ju)
    assert tserde.encode(tu) == enc
    tu2 = tupd.as_updater(tserde.decode(enc))
    assert type(tu2) is type(tu) and tu2 == tu
    rng = np.random.default_rng(10)
    p = rng.standard_normal((5, 3)).astype(np.float32)
    js, ts = ju.init_state(jnp.asarray(p)), tu2.init_state(torch.from_numpy(p))
    for it in range(3):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        jd, js = ju.apply(jnp.asarray(g), js, jnp.asarray(it + 1, jnp.int32),
                          jnp.asarray(it, jnp.int32), jnp.asarray(0, jnp.int32))
        td, ts = tu2.apply(torch.from_numpy(g), ts, it + 1, it, 0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-9)
        assert sorted(ts) == sorted(js)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-6, atol=1e-9)


def test_unported_updater_is_refused_at_train_time():
    """Every reference updater is ported now (``tests/test_torch_updaters.py``):
    an AdaGrad dict decodes into the port's AdaGrad, and an updater class
    the reference lacks is refused by name."""
    conf = tserde.decode(jserde.encode(jupd.AdaGrad(0.05)))
    assert type(tupd.as_updater(conf)) is tupd.AdaGrad
    conf = tserde.decode({"@type": "updater", "@class": "AdamW", "epsilon": 1e-6})
    with pytest.raises(ValueError, match="AdamW"):
        tupd.as_updater(conf)


# -------------------------------------------------------------- narrow graph
def _narrow(conf_pkg, layers, upd, compute_dtype):
    """Stem, pool, two bottlenecks, avgpool, output, with l2 and Nesterovs:
    the same builder calls in either package."""
    gb = (conf_pkg.NeuralNetConfiguration.builder().seed(7).weight_init("relu")
          .updater(upd.Nesterovs(LR, 0.9)).l2(1e-4)
          .compute_dtype(compute_dtype).graph_builder().add_inputs("input")
          .set_input_types(conf_pkg.InputType.convolutional(15, 17, 3)))
    gb.add_layer("stem_conv", layers.ConvolutionLayer(
        n_out=16, kernel_size=7, stride=2, convolution_mode="same",
        activation="identity", has_bias=False), "input")
    gb.add_layer("stem_bn", layers.BatchNormalization(), "stem_conv")
    gb.add_layer("stem_relu", layers.ActivationLayer(activation="relu"), "stem_bn")
    gb.add_layer("stem_pool", layers.SubsamplingLayer(
        kernel_size=3, stride=2, convolution_mode="same"), "stem_relu")
    gb.add_layer("b0", layers.FusedResNetBottleneck(width=8, stride=2, project=True),
                 "stem_pool")
    gb.add_layer("b1", layers.FusedResNetBottleneck(width=8), "b0")
    gb.add_layer("avgpool", layers.GlobalPoolingLayer(pooling_type="avg"), "b1")
    gb.add_layer("output", layers.OutputLayer(n_out=10, activation="softmax",
                                              loss="mcxent"), "avgpool")
    gb.set_outputs("output")
    return gb.build()


def _tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _max_rel(a: dict, b: dict) -> float:
    """Largest per-tensor relative error over two nested dicts."""
    worst = 0.0
    for k in b:
        if isinstance(b[k], dict):
            worst = max(worst, _max_rel(a[k], b[k]))
        elif np.size(b[k]):
            worst = max(worst, rel(a[k], b[k]))
    return worst


def _narrow_pair(compute_dtype, params, state):
    """The narrow graph in both packages holding the same arrays, with the
    reference's freshly initialized updater state carried over."""
    jc = _narrow(jconf, jlayers, jupd, compute_dtype)
    tc = _narrow(tconf, tlayers, tupd, compute_dtype)
    assert tc.to_dict() == jc.to_dict()
    jg = JGraph(jc).init()
    jg.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    jg.state_ = jax.tree_util.tree_map(jnp.asarray, state)
    tg = TGraph(tc).init(device="cpu")
    interop.load_jax_params(tg, params, state, opt_state=_tree(jg.opt_state_),
                            iteration=jg.iteration)
    return jg, tg


@pytest.fixture(scope="module")
def narrow_arrays():
    jg = JGraph(_narrow(jconf, jlayers, jupd, None)).init()
    params, state = _tree(jg.params_), _tree(jg.state_)
    randomize_bn(params, state, 9)
    rng = np.random.default_rng(12)
    batches = [(rng.standard_normal((6, 15, 17, 3)).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]) for _ in range(3)]
    return params, state, batches


def _fit_runs(compute_dtype, narrow_arrays):
    """(JAX, port) snapshots after each of three fit steps: score, params,
    state, updater state."""
    params, state, batches = narrow_arrays
    jg, tg = _narrow_pair(compute_dtype, params, state)
    runs = ([], [])
    for step, (x, y) in enumerate(batches):
        jg.fit(JDataSet(x, y), batch_size=6)
        tg.fit(TDataSet(x, y), batch_size=6)
        assert tg.iteration == jg.iteration == step + 1
        runs[0].append((float(jg.score_), _tree(jg.params_), _tree(jg.state_),
                        _tree(jg.opt_state_)))
        runs[1].append((tg.score(), interop.export_params(tg), interop.export_state(tg),
                        interop.export_opt_state(tg)))
    return runs


def test_narrow_graph_fit_matches_jax_fp32(narrow_arrays):
    """Three fit steps on three seeded batches (l2, Nesterovs(1e-3, 0.9)),
    weights and updater state carried in by load_jax_params: after each
    step the score, params, BN state and Nesterovs' v agree with JAX."""
    for step, (j, t) in enumerate(zip(*_fit_runs(None, narrow_arrays))):
        assert abs(t[0] - j[0]) <= F32_TOL * abs(j[0]), step
        for i in (1, 2, 3):
            assert _max_rel(t[i], j[i]) <= F32_TOL, (step, i)


def test_narrow_graph_fit_matches_jax_bf16(narrow_arrays):
    """The same three steps under compute_dtype bfloat16. Score within
    1e-2 (measured 8e-4 relative); params and BN state within 1e-2
    (measured 2.7e-3 on the output bias, which starts at 0 and so is its
    update history, and 3.2e-3 on a running mean of bf16 conv outputs,
    1e-4 on the rest); Nesterovs' v, which is the gradient history, within
    NOISE_FACTOR times the packages' own bf16-vs-f32 distance, tensor by
    tensor (module docstring)."""
    jf, tf = _fit_runs(None, narrow_arrays)
    jb, tb = _fit_runs("bfloat16", narrow_arrays)
    for step in range(3):
        assert abs(tb[step][0] - jb[step][0]) <= 1e-2 * abs(jb[step][0]), step
        assert _max_rel(tb[step][1], jb[step][1]) <= 1e-2, step
        assert _max_rel(tb[step][2], jb[step][2]) <= 1e-2, step
        _assert_within_noise(tb[step][3], jb[step][3], tf[step][3], jf[step][3])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        elif np.size(v):
            yield prefix + (k,), v


def _assert_within_noise(port_bf16, jax_bf16, port_f32, jax_f32):
    """Per tensor: ||port - jax|| (bf16) <= NOISE_FACTOR * the larger of
    each package's bf16-vs-f32 distance; the median over tensors within
    the median noise."""
    pf, jf = dict(_leaves(port_f32)), dict(_leaves(jax_f32))
    errs, noises = [], []
    for path, jb in _leaves(jax_bf16):
        pb = dict(_leaves(port_bf16))[path]
        err = rel(pb, jb)
        noise = max(rel(jb, jf[path]), rel(pb, pf[path]))
        assert err <= NOISE_FACTOR * noise + 1e-4, (path, err, noise)
        errs.append(err)
        noises.append(noise)
    assert np.median(errs) <= np.median(noises), (np.median(errs), np.median(noises))


def test_fit_refuses_what_is_not_ported():
    """Nothing of these is refused any more: telemetry trains a graph (its
    step leaves the telemetry dict), remat is ported (a "dots" graph
    trains, ``tests/test_torch_remat.py``), so is dropout, and listeners
    are taken."""
    tc = _narrow(tconf, tlayers, tupd, None)
    tc.global_conf.telemetry = True
    tg = TGraph(tc).init(device="cpu")
    x = np.zeros((2, 15, 17, 3), np.float32)
    y = np.eye(10, dtype=np.float32)[:2]
    tg.fit(TDataSet(x, y))
    assert tg.iteration == 1 and "grad_norm" in tg.step_telemetry_
    tc = _narrow(tconf, tlayers, tupd, None)
    tc.global_conf.remat_policy = "dots"
    remat = TGraph(tc).init(device="cpu").fit(TDataSet(x, y))
    assert remat.iteration == 1 and math.isfinite(remat.score())
    # dropout is ported: a fused bottleneck's input dropout trains
    tc = _narrow(tconf, tlayers, tupd, None)
    tc.vertices["b0"].layer.dropout = 0.5
    dropped = TGraph(tc).init(device="cpu").fit(TDataSet(x, y))
    assert dropped.iteration == 1 and math.isfinite(dropped.score())
    tg.set_listeners(object())
    assert len(tg.listeners) == 1


def test_score_and_export_round_trip():
    """score(ds) is the eval-mode loss plus the l2 score, as JAX's; the
    exported arrays load back unchanged."""
    jc = _narrow(jconf, jlayers, jupd, None)
    tc = _narrow(tconf, tlayers, tupd, None)
    tg = TGraph(tc).init(device="cpu")
    jg = JGraph(jc)
    jg.params_ = jax.tree_util.tree_map(jnp.asarray, interop.export_params(tg))
    jg.state_ = jax.tree_util.tree_map(jnp.asarray, interop.export_state(tg))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 15, 17, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 3)]
    assert tg.score(TDataSet(x, y)) == pytest.approx(jg.score(JDataSet(x, y)), rel=1e-5)
    tg2 = TGraph(tc).init(device="cpu")
    interop.load_jax_params(tg2, interop.export_params(tg), interop.export_state(tg))
    assert _max_rel(interop.export_params(tg2), interop.export_params(tg)) == 0.0


# ------------------------------------------------------------------ ResNet-50
def test_resnet50_gradients_match_jax():
    """One compute_gradient_and_score of a fused ResNet-50 (10 classes,
    32x32, batch 4) with the same weights in both packages, in f32 and in
    bf16 compute. The port's graph is initialized on the CPU with
    randomized BN and the JAX graph is filled from its arrays (no JAX init,
    which takes ~13 s here). f32: the score within F32_TOL and every
    parameter's gradient within F32_RESNET_TOL. bf16: the score within
    1e-3, the gradients within the noise bound of the module docstring."""
    tm = TResNet50(num_classes=10, height=32, width=32, fused_pallas=True,
                   updater=tupd.Nesterovs(LR, 0.9)).init(device="cpu")
    params, state = interop.export_params(tm), interop.export_state(tm)
    randomize_bn(params, state, 11)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    out = {}
    for cd in (None, "bfloat16"):
        kw = dict(num_classes=10, height=32, width=32, fused_pallas=True,
                  compute_dtype=cd)
        jg = JGraph(JResNet50(updater=jupd.Nesterovs(LR, 0.9), **kw).conf())
        jg.params_ = jax.tree_util.tree_map(jnp.asarray, params)
        jg.state_ = jax.tree_util.tree_map(jnp.asarray, state)
        tg = TResNet50(updater=tupd.Nesterovs(LR, 0.9), **kw).init(device="cpu")
        interop.load_jax_params(tg, params, state)
        jgrads, jscore = jg.compute_gradient_and_score(JDataSet(x, y))
        tgrads, tscore = tg.compute_gradient_and_score(TDataSet(x, y))
        assert all(g.dtype == torch.float32 for d in tgrads.values() for g in d.values())
        out["jax", cd] = (_tree(jgrads), jscore)
        out["port", cd] = ({v: {k: _np(g) for k, g in d.items()}
                            for v, d in tgrads.items()}, tscore)

    (jgrads, jscore), (tgrads, tscore) = out["jax", None], out["port", None]
    assert abs(tscore - jscore) <= F32_TOL * abs(jscore)
    assert _max_rel(tgrads, jgrads) <= F32_RESNET_TOL
    (jb, jscore), (tb, tscore) = out["jax", "bfloat16"], out["port", "bfloat16"]
    assert abs(tscore - jscore) <= 1e-3 * abs(jscore)
    _assert_within_noise(tb, jb, tgrads, jgrads)
