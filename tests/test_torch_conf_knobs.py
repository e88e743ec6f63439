"""The builder's global knobs, schedules, activations and weight-init
schemes of the port against the JAX package's, on the CPU; and the gates of
three call-surface repairs (ListDataSetIterator's ``drop_last``,
``GraphBuilder.layer``, ``ParallelInference``'s ``mesh``).

- Knobs: a configuration built with each global knob gives the same JSON in
  both packages, and each package's JSON loads in the other, key for key.
  ``updater("<name>")`` resolves the ten reference updaters.
- Schedules: each dict round-trips both ways (``MapSchedule``'s string keys
  and the nested ``WarmupSchedule`` included); each ``value_at`` matches
  JAX's within 1e-6 relative over iteration and epoch schedules, and a
  0-dim tensor clock gives the host value's bits.
- Activations: each value and its gradient (autograd against ``jax.grad``
  of a weighted sum) within 1e-6 relative, at random points and exactly at
  each kink, where the rule is the reference's (half at a two-sided
  ``jnp.maximum``/``jnp.minimum`` tie, slope 1 of ``jnp.abs`` at 0).
- Weight init: deterministic schemes equal JAX's arrays; random ones are
  held by mean and variance against their formula at 160,000 draws, where
  5 standard errors of the variance are under 2% (and of the mean under
  2% of the std); orthogonal draws by QᵀQ = gain²·I.
- ``dtype``: the params' dtype equals JAX's under the tests' settings (x64
  off, so "float64" gives f32 arrays there and here).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import activations as jact
from deeplearning4j_tpu import initializers as jinit
from deeplearning4j_tpu import schedules as jsched
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListIter
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import activations as tact
from deeplearning4j_tpu_torch import initializers as tinit
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import schedules as tsched
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ListDataSetIterator as TListIter
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.graph_builder import ComputationGraphConfiguration as TGC
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh

JAX = (jconf, jlayers, jupd, jinit, jsched)
PORT = (tconf, tlayers, tupd, tinit, tsched)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------------------- knobs
#: knob -> (builder call on a package), each a reference configuration
KNOBS = {
    "dist": lambda p, b: b.weight_init("distribution").dist(p[3].Distribution(
        "normal", mean=0.1, std=0.5)),
    "activation": lambda p, b: b.activation("leakyrelu"),
    "bias_init": lambda p, b: b.bias_init(0.25),
    "l1": lambda p, b: b.l1(1e-3),
    "l2": lambda p, b: b.l2(1e-4),
    "l1_bias": lambda p, b: b.l1_bias(2e-3),
    "l2_bias": lambda p, b: b.l2_bias(3e-3),
    "weight_decay": lambda p, b: b.weight_decay(5e-4),
    "gradient_normalization": lambda p, b: b.gradient_normalization(
        "clip_l2_per_param_type", 0.5),
    "dtype": lambda p, b: b.dtype("bfloat16"),
    "async_queue_size": lambda p, b: b.async_queue_size(9),
    "telemetry": lambda p, b: b.telemetry(True),
    "remat_policy": lambda p, b: b.remat_policy("save_conv_outputs"),
    "weight_init": lambda p, b: b.weight_init("lecun_uniform"),
    "compute_dtype": lambda p, b: b.compute_dtype("bfloat16"),
    "steps_per_call": lambda p, b: b.steps_per_call(3),
    "sharded_update": lambda p, b: b.sharded_update(True),
    "updater_schedule": lambda p, b: b.updater(p[2].AMSGrad(p[4].WarmupSchedule(
        4, p[4].CosineSchedule(1e-2, 20)))),
}


def knob_conf(pkg, knob):
    conf, layers = pkg[0], pkg[1]
    b = KNOBS[knob](pkg, conf.NeuralNetConfiguration.builder().seed(4))
    return (b.list()
            .layer(layers.DenseLayer(n_out=6))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(5)).build())


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_each_knob_gives_the_reference_json_both_ways(knob):
    j, t = knob_conf(JAX, knob), knob_conf(PORT, knob)
    assert t.to_dict() == j.to_dict()
    from_jax, from_port = TConf.from_json(j.to_json()), jconf.MultiLayerConfiguration.from_json(
        t.to_json())
    assert from_jax == t and from_jax.to_json() == j.to_json()
    assert from_port == j and from_port.to_json() == t.to_json()


def test_every_reference_knob_exists():
    ref = {n for n in dir(jconf.NeuralNetConfiguration) if not n.startswith("_")}
    mine = {n for n in dir(tconf.NeuralNetConfiguration) if not n.startswith("_")}
    assert ref <= mine, sorted(ref - mine)


@pytest.mark.parametrize("name", sorted(tupd._UPDATERS))
def test_updater_by_name_gives_the_reference_json(name):
    def build(pkg):
        conf, layers = pkg[0], pkg[1]
        return (conf.NeuralNetConfiguration.builder().updater(name.lower()).list()
                .layer(layers.OutputLayer(n_out=2))
                .set_input_type(conf.InputType.feed_forward(3)).build())

    j, t = build(JAX), build(PORT)
    assert t.to_dict() == j.to_dict()
    assert type(tupd.as_updater(t.layers[0].updater)).__name__ == name
    assert TConf.from_json(j.to_json()) == t


def test_knobs_reach_the_layers_and_train():
    """A network built with the training knobs trains, and its layers hold
    the knobs' values, as the reference's do."""
    def build(pkg):
        conf, layers = pkg[0], pkg[1]
        return (conf.NeuralNetConfiguration.builder().seed(9).updater("adamax")
                .activation("rrelu").weight_init("xavier_uniform").bias_init(0.1)
                .l1(1e-3).l2_bias(1e-3).gradient_normalization("renormalize_l2_per_layer")
                .list().layer(layers.DenseLayer(n_out=6))
                .layer(layers.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(conf.InputType.feed_forward(5)).build())

    jnet, tnet = JNet(build(JAX)).init(), TNet(build(PORT)).init(device="cpu")
    assert torch.equal(tnet.params_[0]["b"], torch.full((6,), 0.1))
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    for _ in range(2):
        jnet.fit(JDataSet(x, y), batch_size=8)
        tnet.fit(TDataSet(x, y), batch_size=8)
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=1e-5)
    assert abs(tnet.score() - float(jnet.score())) <= 1e-5


def test_telemetry_and_remat_stay_refused_at_train_time():
    """Both knobs now train: the telemetry knob (in-graph telemetry is
    ported: ``tests/test_torch_telemetry.py``) leaves each step's
    telemetry dict, and the remat_policy knob rematerializes
    (``tests/test_torch_remat.py``)."""
    x = np.zeros((2, 5), np.float32)
    net = TNet(knob_conf(PORT, "telemetry")).init(device="cpu")
    net.fit(x, np.eye(3, dtype=np.float32)[:2])
    assert net.iteration == 1
    assert sorted(net.step_telemetry_) == ["grad_norm", "param_norm", "update_norm",
                                           "update_ratio"]
    net = TNet(knob_conf(PORT, "remat_policy")).init(device="cpu")
    assert net.conf.global_conf.remat_policy == "save_conv_outputs"
    net.fit(x, np.eye(3, dtype=np.float32)[:2])
    assert net.iteration == 1 and np.isfinite(net.score())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
def test_dtype_gives_the_references_params(dtype):
    def build(pkg):
        conf, layers = pkg[0], pkg[1]
        return (conf.NeuralNetConfiguration.builder().seed(1).dtype(dtype).list()
                .layer(layers.DenseLayer(n_out=4, activation="tanh"))
                .layer(layers.OutputLayer(n_out=2, activation="softmax"))
                .set_input_type(conf.InputType.feed_forward(3)).build())

    jnet, tnet = JNet(build(JAX)).init(), TNet(build(PORT)).init(device="cpu")
    for mine, theirs in zip(tnet.params_, jnet.params_):
        for k in theirs:
            assert str(mine[k].dtype).replace("torch.", "") == str(theirs[k].dtype), (k, dtype)
    want = "float32" if dtype == "float64" else dtype
    assert str(tnet.params_[0]["W"].dtype) == f"torch.{want}"
    f32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params_)
    interop.load_jax_params(tnet, f32, numpy_tree(jnet.state_))
    x = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
    tol = 1e-6 if want == "float32" else 1e-2
    np.testing.assert_allclose(tnet.output(x), np.asarray(jnet.output(x), np.float32),
                               rtol=0, atol=tol)


def test_distribution_round_trips_and_draws_where_the_layer_asks():
    for kind, kw in (("normal", {"mean": 0.1, "std": 0.5}), ("uniform", {"lower": -0.2}),
                     ("constant", {"value": 0.3}), ("orthogonal", {"gain": 2.0})):
        mine, theirs = tinit.Distribution(kind, **kw), jinit.Distribution(kind, **kw)
        assert tserde.encode(mine) == jserde.encode(theirs)
        assert jserde.decode(tserde.encode(mine)) == theirs
        assert tinit.as_distribution(tserde.decode(jserde.encode(theirs))) == mine

    def build(pkg):
        conf, layers, _, init, _ = pkg
        return (conf.NeuralNetConfiguration.builder().weight_init("distribution")
                .dist(init.Distribution("constant", value=0.3)).list()
                .layer(layers.DenseLayer(n_out=4))
                .layer(layers.OutputLayer(n_out=2, weight_init=init.Distribution(
                    "constant", value=-0.2)))
                .set_input_type(conf.InputType.feed_forward(3)).build())

    j, t = build(JAX), build(PORT)
    assert t.to_dict() == j.to_dict()
    jnet, tnet = JNet(j).init(), TNet(TConf.from_json(j.to_json())).init(device="cpu")
    for mine, theirs in zip(tnet.params_, numpy_tree(jnet.params_)):
        np.testing.assert_array_equal(mine["W"].numpy(), theirs["W"])


# ---------------------------------------------------------------- schedules
SCHEDULES = {
    "fixed": lambda s, ty: s.FixedSchedule(0.3),
    "exponential": lambda s, ty: s.ExponentialSchedule(ty, 0.5, 0.97),
    "inverse": lambda s, ty: s.InverseSchedule(ty, 0.5, 0.1, 0.75),
    "poly": lambda s, ty: s.PolySchedule(ty, 0.5, 2.0, 60),
    "sigmoid": lambda s, ty: s.SigmoidSchedule(ty, 0.5, 0.2, 20),
    "step": lambda s, ty: s.StepSchedule(ty, 0.5, 0.8, 7),
    "map": lambda s, ty: s.MapSchedule(ty, {0: 0.5, 10: 0.2, 35: 0.05}),
    "cycle": lambda s, ty: s.CycleSchedule(ty, 0.1, 0.9, 24, 3, 0.5),
    "cosine": lambda s, ty: s.CosineSchedule(0.5, 50, 0.01, ty),
    "warmup": lambda s, ty: s.WarmupSchedule(10, s.CosineSchedule(0.5, 40), ty),
    "warmup_map": lambda s, ty: s.WarmupSchedule(5, s.MapSchedule("iteration",
                                                                  {0: 1.0, 8: 0.5}), ty),
}
SCHED_CASES = [(n, ty) for n in sorted(SCHEDULES) for ty in ("iteration", "epoch")
               if not (n == "fixed" and ty == "epoch")]


@pytest.mark.parametrize("name,stype", SCHED_CASES)
def test_schedule_dicts_round_trip_both_ways(name, stype):
    mine, theirs = SCHEDULES[name](tsched, stype), SCHEDULES[name](jsched, stype)
    assert mine.to_dict() == theirs.to_dict()
    assert jsched.Schedule.from_dict(mine.to_dict()) == theirs
    assert tsched.Schedule.from_dict(theirs.to_dict()) == mine
    # inside an updater's dict, as the configuration JSON carries it
    upd_dict = jserde.encode(jupd.Sgd(theirs))
    assert tserde.encode(tupd.Sgd(mine)) == upd_dict
    assert tupd.as_updater(tserde.decode(upd_dict)) == tupd.Sgd(mine)


@pytest.mark.parametrize("name,stype", SCHED_CASES)
def test_schedule_values_match_jax(name, stype):
    """Within 1e-6 of the schedule's largest value over the run: a cosine
    ending at 0 computes 1 + cos(pi t/T), which cancels near the end, so an
    ulp of the two libraries' ``cos`` is 2e-5 of that step's own value
    (measured at step 49 of ``warmup``)."""
    mine, theirs = SCHEDULES[name](tsched, stype), SCHEDULES[name](jsched, stype)
    got, want = [], []
    for step in range(0, 120):
        it, ep = (step, 3) if stype == "iteration" else (5, step)
        host = mine.value_at(it, ep)
        dev = mine.value_at(torch.tensor(it, dtype=torch.int32),
                            torch.tensor(ep, dtype=torch.int32))
        assert host.dtype == torch.float32 and host.dim() == 0
        assert torch.equal(host, dev), (step, host, dev)
        got.append(float(host))
        want.append(float(theirs.value_at(jnp.int32(it), jnp.int32(ep))))
    got, want = np.array(got), np.array(want)
    scale = np.abs(want).max()
    assert scale > 0 and np.all(np.abs(got - want) <= 1e-6 * scale), np.abs(got - want).max()
    assert len(set(want)) > 1 or name == "fixed"


def test_unknown_schedule_raises_as_the_reference():
    with pytest.raises(KeyError):
        jsched.Schedule.from_dict({"@class": "NoSuchSchedule"})
    with pytest.raises(KeyError, match="NoSuchSchedule"):
        tsched.Schedule.from_dict({"@class": "NoSuchSchedule"})
    with pytest.raises(ValueError, match="t=0"):
        tsched.MapSchedule("iteration", {5: 0.1})


def test_reference_schedule_quirks_are_kept():
    """CycleSchedule ignores its annealing fields; MapSchedule holds its
    first value below the first key (the reference is the oracle)."""
    a = tsched.CycleSchedule("iteration", 0.1, 0.9, 10, 0, 0.1)
    b = tsched.CycleSchedule("iteration", 0.1, 0.9, 10, 5, 0.9)
    assert all(torch.equal(a.value_at(i, 0), b.value_at(i, 0)) for i in range(40))
    m = tsched.MapSchedule("iteration", {0: 0.5, 10: 0.2})
    assert float(m.value_at(-3, 0)) == 0.5
    assert float(m.value_at(-3, 0)) == float(jsched.MapSchedule(
        "iteration", {0: 0.5, 10: 0.2}).value_at(-3, 0))


# -------------------------------------------------------------- activations
KINKS = {"relu": [0.0], "relu6": [0.0, 6.0], "hardtanh": [-1.0, 1.0],
         "hardsigmoid": [-2.5, 2.5], "thresholdedrelu": [1.0, 0.0],
         "leakyrelu": [0.0], "rrelu": [0.0], "elu": [0.0], "selu": [0.0],
         "rectifiedtanh": [0.0], "softsign": [0.0], "rationaltanh": [0.0],
         "leakyrelu(0.2)": [0.0], "thresholdedrelu(0.5)": [0.5]}
ACT_NAMES = jact.names() + ["leakyrelu(0.2)", "thresholdedrelu(0.5)", "Leaky_ReLU"]


@pytest.mark.parametrize("name", ACT_NAMES)
def test_activation_value_and_gradient_match_jax(name):
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal((4, 9)) * 3).astype(np.float32)
    kinks = KINKS.get(name, [])
    if kinks:
        x[0, :len(kinks)] = kinks
    w = rng.standard_normal(x.shape).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    ty = tact.get(name)(tx)
    (ty * torch.from_numpy(w)).sum().backward()
    jf = jact.get(name)
    jy = np.asarray(jf(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x)))
    # gelu's far tail is 1 + tanh(..) near -1, where the two libraries' tanh
    # cancel differently: measured 2.2e-6 absolute on the gradient at x = -5
    atol = 5e-6 if name == "gelu" else 1e-6
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=1e-6, atol=atol)
    if kinks:  # the kink's gradient is exactly the reference's
        np.testing.assert_array_equal(tx.grad.numpy()[0, :len(kinks)], jg[0, :len(kinks)])


def test_every_reference_activation_is_ported():
    assert tact.names() == jact.names()
    assert len(tact.names()) == 23
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get("swishy")


# --------------------------------------------------------------- weight init
N_DRAW = (400, 400)  # 160,000 draws: 5 standard errors of the variance < 2%


def _moments(scheme, fan_in, fan_out):
    """(mean, variance) of a scheme's draws from its formula."""
    normal = {"xavier": 2 / (fan_in + fan_out), "xavier_fan_in": 1 / fan_in,
              "xavier_legacy": 1 / (N_DRAW[0] * N_DRAW[1]), "relu": 2 / fan_in,
              "lecun_normal": 1 / fan_in, "normal": 1 / fan_in,
              "var_scaling_normal_fan_in": 1 / fan_in,
              "var_scaling_normal_fan_out": 1 / fan_out,
              "var_scaling_normal_fan_avg": 2 / (fan_in + fan_out)}
    uniform = {"xavier_uniform": math.sqrt(6 / (fan_in + fan_out)),
               "relu_uniform": math.sqrt(6 / fan_in), "lecun_uniform": math.sqrt(3 / fan_in),
               "sigmoid_uniform": 4 * math.sqrt(6 / (fan_in + fan_out)),
               "uniform": 1 / math.sqrt(fan_in),
               "var_scaling_uniform_fan_in": math.sqrt(3 / fan_in),
               "var_scaling_uniform_fan_out": math.sqrt(3 / fan_out),
               "var_scaling_uniform_fan_avg": math.sqrt(6 / (fan_in + fan_out))}
    if scheme in normal:
        return 0.0, normal[scheme]
    return 0.0, uniform[scheme] ** 2 / 3


RANDOM_SCHEMES = sorted(set(tinit._SCHEMES))


def _held_by_moments(w, mean, var):
    w = w.double()
    sd = math.sqrt(var)
    assert abs(float(w.mean()) - mean) <= 5 * sd / math.sqrt(w.numel())
    assert abs(float(w.var()) / var - 1) <= 0.02, (float(w.var()), var)


@pytest.mark.parametrize("scheme", RANDOM_SCHEMES)
def test_random_schemes_match_their_moments(scheme):
    fan_in, fan_out = 300.0, 500.0
    w = tinit.init_weights(torch.Generator().manual_seed(3), N_DRAW, fan_in, fan_out, scheme)
    assert w.shape == N_DRAW and w.dtype == torch.float32
    _held_by_moments(w, *_moments(scheme, fan_in, fan_out))
    if "uniform" in scheme:
        lim = math.sqrt(3 * _moments(scheme, fan_in, fan_out)[1])
        assert float(w.abs().max()) <= lim * (1 + 1e-6)
    # the reference's alias without underscores draws the same
    alias = scheme.replace("_", "")
    if alias in tinit._ALIASES:
        again = tinit.init_weights(torch.Generator().manual_seed(3), N_DRAW, fan_in,
                                   fan_out, alias)
        assert torch.equal(again, w)


@pytest.mark.parametrize("kind", ["normal", "uniform", "lognormal", "truncated_normal"])
def test_random_distributions_match_their_moments(kind):
    kw = {"normal": {"mean": 0.5, "std": 2.0}, "uniform": {"lower": -0.5, "upper": 1.5},
          "lognormal": {"mean": 0.2, "std": 0.1},
          "truncated_normal": {"mean": -1.0, "std": 0.5}}[kind]
    w = tinit.Distribution(kind, **kw).sample(torch.Generator().manual_seed(4), N_DRAW)
    if kind == "normal":
        mean, var = 0.5, 4.0
    elif kind == "uniform":
        mean, var = 0.5, 4.0 / 12
    elif kind == "lognormal":
        s2 = 0.01
        mean, var = math.exp(0.2 + s2 / 2), (math.exp(s2) - 1) * math.exp(0.4 + s2)
    else:
        z = math.erf(2 / math.sqrt(2))
        phi2 = math.exp(-2) / math.sqrt(2 * math.pi)
        mean, var = -1.0, 0.25 * (1 - 4 * phi2 / z)
        assert float(w.min()) >= -2.0 - 1e-6 and float(w.max()) <= 1e-6
    _held_by_moments(w, mean, var)


@pytest.mark.parametrize("shape,gain", [((64, 32), 1.0), ((32, 64), 2.0), ((3, 3, 4, 8), 1.5)])
def test_orthogonal_is_orthogonal(shape, gain):
    gen = torch.Generator().manual_seed(5)
    w = (tinit.Distribution("orthogonal", gain=gain).sample(gen, shape) if gain != 1.0
         else tinit.init_weights(gen, shape, 1, 1, "orthogonal"))
    q = w.reshape(shape[0], -1).double()
    g = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
    torch.testing.assert_close(g, gain ** 2 * torch.eye(g.shape[0], dtype=torch.float64),
                               rtol=0, atol=1e-5 * gain ** 2)


@pytest.mark.parametrize("scheme", ["zero", "ones", "identity", "constant"])
def test_deterministic_schemes_equal_the_references(scheme):
    shape = (5, 5)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    if scheme == "constant":
        mine = tinit.Distribution("constant", value=0.7).sample(gen, shape)
        theirs = jinit.Distribution("constant", value=0.7).sample(key, shape)
    else:
        mine = tinit.init_weights(gen, shape, 5, 5, scheme)
        theirs = jinit.init_weights(key, shape, 5, 5, scheme)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_unknown_schemes_raise():
    with pytest.raises(ValueError, match="Unknown weight init"):
        tinit.init_weights(torch.Generator(), (2, 2), 2, 2, "he_magic")
    with pytest.raises(ValueError, match="requires a Distribution"):
        tinit.init_weights(torch.Generator(), (2, 2), 2, 2, "distribution")


# ---------------------------------------------------------- C5, C6 and C7
@pytest.mark.parametrize("drop_last", [False, True])
def test_list_iterator_drops_the_ragged_tail_where_jax_does(drop_last):
    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    y = np.eye(2, dtype=np.float32)[np.arange(11) % 2]
    mine = [d.features for d in TListIter(TDataSet(x, y), 4, drop_last=drop_last)]
    theirs = [np.asarray(d.features) for d in JListIter(JDataSet(x, y), 4,
                                                        drop_last=drop_last)]
    assert [len(a) for a in mine] == [len(a) for a in theirs] == (
        [4, 4] if drop_last else [4, 4, 3])
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)
    exact = TListIter(TDataSet(x[:8], y[:8]), 4, drop_last=drop_last)
    assert [len(d.features) for d in exact] == [4, 4]


def test_graph_builder_layer_is_add_layer():
    def build(pkg, alias):
        conf, layers = pkg[0], pkg[1]
        gb = (conf.NeuralNetConfiguration.builder().seed(2).graph_builder()
              .add_inputs("in").set_input_types(conf.InputType.feed_forward(4)))
        add = gb.layer if alias else gb.add_layer
        add("d", layers.DenseLayer(n_out=5, activation="relu"), "in")
        add("out", layers.OutputLayer(n_out=3, activation="softmax"), "d")
        return gb.set_outputs("out").build()

    mine, plain, theirs = build(PORT, True), build(PORT, False), build(JAX, True)
    assert mine.to_json() == plain.to_json()
    assert mine.to_dict() == theirs.to_dict()
    assert TGC.from_json(theirs.to_json()).to_json() == mine.to_json()


def _mlp():
    conf, layers = tconf, tlayers
    return TNet(conf.NeuralNetConfiguration.builder().seed(3).list()
                .layer(layers.DenseLayer(n_out=8, activation="tanh"))
                .layer(layers.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(conf.InputType.feed_forward(4)).build()).init(device="cpu")


@pytest.mark.parametrize("mode", ["sequential", "batched", "inplace"])
def test_parallel_inference_takes_the_references_mesh(mode):
    """``mesh`` sits where the reference has it and is never read: a mesh
    object with no attributes set (reading one would raise) changes
    nothing, and the positional call binds ``workers`` after it."""
    net = _mlp()
    x = np.random.default_rng(1).standard_normal((10, 4)).astype(np.float32)
    bare = object.__new__(TrainingMesh)
    plain = ParallelInference(net, mode=mode, workers=3)
    with_mesh = ParallelInference(net, mode=mode, mesh=bare, workers=3)
    positional = ParallelInference(net, mode, 32, 64, bare, 3)
    for pi in (plain, with_mesh, positional):
        np.testing.assert_array_equal(pi.output(x), net.output(x))
        if mode == "inplace":
            assert len(pi._replicas) == 3
        pi.shutdown()
