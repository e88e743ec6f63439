"""The port's ten updaters against the JAX package's, on the CPU.

- ``apply``: each updater's update and slots over t = 1..1000 on one fixed
  gradient stream (numpy, seeded), with ``t`` a host int and a 0-dim
  tensor, each step's update (and the slots) within 1e-6 of its norm
  (f32). Both compute the same f32 operations, but the two compilers round
  some of them differently (an ulp at step 1), and the slots carry that on
  over the thousand steps: measured 7.2e-7 of the norm at worst (AdaDelta;
  the existing Nesterovs 6.5e-7), 1.2e-6 of the step's largest element.
  The slots are held at 2e-6: AdaDelta's ``msdx`` sums squared updates,
  which doubles their relative error (measured 1.04e-6).
  Where a moment cancels to near 0 the ulp is large against that element
  itself, so the element's own magnitude is no bound.
- Dicts and slots: each config dict equals the reference's ``serde.encode``
  key for key and decodes both ways; slot names are the reference's.
- The leak test: under a scalar feed that answers every per-step scalar
  with step 7's value while ``t`` is 1, ``apply`` equals a plain step 7 bit
  for bit. A scalar that ``apply`` computed from ``t`` itself would be
  frozen into a captured bundle's CUDA graph; ``BundledStep.emulate``
  recomputes it eagerly and so cannot see it.
- Bundles: a k-4 bundle (``emulate``, the card's path without the graph)
  under a varying learning-rate schedule is bit-equal to 4 eager steps.
- ``fit``: LeNet over 5 steps from carried params tracks JAX within 1e-5
  (absolute, the tolerance of ``test_torch_multilayer_train.py``) under
  each updater, and under l1 + gradient normalization.
- Zips: a zip written mid-fit under AMSGrad or AdaDelta by either package
  resumes in the other, and the next step matches within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.schedules as jsched
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.schedules as tsched
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer as TSer

NAMES = sorted(tupd._UPDATERS)
NEW = ["AMSGrad", "AdaDelta", "AdaGrad", "AdaMax", "Nadam", "RmsProp"]
FIT_TOL = 1e-5
STEPS = 1000

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def grad_stream(n=STEPS, size=24, seed=0):
    """A fixed gradient stream: mostly O(1), some tiny and some large."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, size)).astype(np.float32)
    return g * np.float32(10.0) ** rng.integers(-3, 2, (1, size)).astype(np.float32)


# ------------------------------------------------------------ dicts and slots
@pytest.mark.parametrize("name", NAMES)
def test_updater_dicts_and_slots_equal_the_reference(name):
    mine, theirs = tupd.get(name.lower()), jupd.get(name.lower())
    assert type(mine).__name__ == name
    jd = jserde.encode(theirs)
    assert tserde.encode(mine) == jd
    assert tupd.as_updater(tserde.decode(jd)) == mine
    assert jserde.decode(tserde.encode(mine)) == theirs
    p = np.zeros(3, np.float32)
    assert set(mine.init_state(torch.zeros(3))) == set(theirs.init_state(jnp.asarray(p)))
    assert tupd.get(name.upper()) == mine


def test_adadelta_has_no_learning_rate_and_amsgrad_three_slots():
    assert tserde.encode(tupd.AdaDelta())["learning_rate"] is None
    assert sorted(tupd.AMSGrad().init_state(torch.zeros(2))) == ["m", "v", "v_hat"]
    with pytest.raises(ValueError, match="Unknown updater"):
        tupd.get("adamw")


def test_updater_takes_a_schedule_dict_both_ways():
    mine = tupd.Nadam(tsched.WarmupSchedule(3, tsched.CosineSchedule(1e-2, 10)))
    theirs = jupd.Nadam(jsched.WarmupSchedule(3, jsched.CosineSchedule(1e-2, 10)))
    assert tserde.encode(mine) == jserde.encode(theirs)
    assert jserde.decode(tserde.encode(mine)) == theirs


# -------------------------------------------------------------------- apply
def _jax_updates(name, grads):
    upd = jupd.get(name.lower())
    step = jax.jit(lambda g, s, t: upd.apply(g, s, t, t - 1, 0))
    state = upd.init_state(jnp.zeros(grads.shape[1], jnp.float32))
    outs, states = [], []
    for i, g in enumerate(grads):
        u, state = step(jnp.asarray(g), state, jnp.int32(i + 1))
        outs.append(np.asarray(u))
        states.append(numpy_tree(state))
    return np.stack(outs), states


def _port_updates(name, grads, tensor_t):
    upd = tupd.get(name.lower())
    state = upd.init_state(torch.zeros(grads.shape[1]))
    outs, states = [], []
    for i, g in enumerate(grads):
        t = torch.tensor(i + 1, dtype=torch.int32) if tensor_t else i + 1
        it = torch.tensor(i, dtype=torch.int32) if tensor_t else i
        u, state = upd.apply(torch.from_numpy(g), state, t, it, 0)
        outs.append(u.numpy())
        states.append({k: v.numpy() for k, v in state.items()})
    return np.stack(outs), states


def close(mine, ref, what="", tol=1e-6):
    """Row by row (a step): the difference within ``tol`` of the row's norm."""
    err = np.linalg.norm(mine - ref, axis=-1)
    scale = np.linalg.norm(ref, axis=-1)
    assert np.all(err <= tol * scale), (what, float(np.max(err / np.maximum(scale, 1e-38))))


@pytest.mark.parametrize("name", NAMES)
def test_apply_matches_jax_over_a_thousand_steps(name):
    grads = grad_stream()
    ref, ref_states = _jax_updates(name, grads)
    host, host_states = _port_updates(name, grads, tensor_t=False)
    dev, dev_states = _port_updates(name, grads, tensor_t=True)
    close(host, ref)
    # the 0-dim tensor clock computes the same f32 operations: same bits
    np.testing.assert_array_equal(dev, host)
    for mine, theirs in zip(host_states[::97], ref_states[::97]):
        for k in theirs:
            # a slot of squared updates (AdaDelta's msdx) doubles their error
            close(mine[k][None], theirs[k][None], k, tol=2e-6)
    for mine, other in zip(host_states[-1:], dev_states[-1:]):
        for k in mine:
            np.testing.assert_array_equal(mine[k], other[k])


# ---------------------------------------------------------------- leak test
class _Step7Feed:
    """Answers every per-step scalar with its value at step 7 (t 7,
    iteration 6), whatever step asks."""

    base = 6

    def take(self, upd, kind, t, iteration, epoch):
        return upd.scalar_value(kind, 7, 6, epoch)


def _scheduled(name):
    """The updater at its defaults, its learning rate (where it has one) on
    a schedule that changes every step."""
    upd = tupd.get(name.lower())
    if upd.get("learning_rate") is not None:
        upd = type(upd).__new__(type(upd))
        dict.__init__(upd, tupd.get(name.lower()))
        upd["learning_rate"] = tupd._schedule_dict(
            tsched.ExponentialSchedule("iteration", 1e-2, 0.9))
    return upd


@pytest.mark.parametrize("name", NAMES)
def test_every_step_scalar_goes_through_the_feed(name):
    upd = _scheduled(name)
    grads = torch.from_numpy(grad_stream(8))
    state = upd.init_state(torch.zeros(grads.shape[1]))
    for i in range(6):
        _, state = upd.apply(grads[i], state, i + 1, i, 0)
    want, want_state = upd.apply(grads[6], state, 7, 6, 0)
    with tupd.scalar_feed(_Step7Feed()):
        got, got_state = upd.apply(grads[6], state, 1, 0, 0)
    assert torch.equal(got, want)
    assert all(torch.equal(got_state[k], want_state[k]) for k in want_state)
    if name in ("Adam", "AMSGrad", "AdaMax", "Nadam"):
        # non-vacuous: step 1 differs from step 7
        assert not torch.equal(upd.apply(grads[6], state, 1, 0, 0)[0], want)


def test_a_guarded_epoch_schedule_comes_from_the_feed():
    """On the guarded step's device clock the t-scalars are computed from
    ``t``, but a schedule that reads only the (host) epoch is the feed's:
    a captured graph would otherwise keep the epoch of its capture."""
    upd = tupd.AdaMax(tsched.StepSchedule("epoch", 1e-2, 0.5, 1))
    asked = []

    class Feed:
        base = 3

        def take(self, u, kind, t, iteration, epoch):
            asked.append((kind, t, iteration, epoch))
            return u.scalar_value(kind, t, iteration, epoch)

    t = torch.tensor(4, dtype=torch.int32)
    plain = upd.scalar_value("alpha", 4, 3, 2)
    with tupd.scalar_feed(Feed()):
        alpha = upd.step_scalar("alpha", t, t - 1, 2)
    assert asked == [("learning_rate", 3, 3, 2)]
    assert torch.equal(alpha, plain)


# ------------------------------------------------------------------ bundles
def _mlp(pkg, upd, k=1, **knobs):
    conf, layers, _ = pkg
    b = conf.NeuralNetConfiguration.builder().seed(7).updater(upd).steps_per_call(k)
    for knob, v in knobs.items():
        b = getattr(b, knob)(*v) if isinstance(v, tuple) else getattr(b, knob)(v)
    return (b.list()
            .layer(layers.DenseLayer(n_out=16, activation="relu"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.feed_forward(12)).build())


def _batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [TDataSet(rng.standard_normal((b, 12)).astype(np.float32),
                     np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


@pytest.mark.parametrize("name", NAMES)
def test_k4_bundle_under_a_schedule_equals_eager_steps(name):
    upd = _scheduled(name)
    a = TNet(_mlp(PORT, upd, 1)).init(device="cpu")
    b = TNet(_mlp(PORT, upd, 4)).init(device="cpu")
    b._bundle_step(4).emulate = True
    data = _batches(8)
    a.fit(TExisting(data))
    b.fit(TExisting(data))
    assert a.iteration == b.iteration == 8
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    np.testing.assert_array_equal(a.opt_state_flat(), b.opt_state_flat())
    assert torch.equal(a.score_, b.score_)
    assert len(b._bundle_step(4)._feed.specs) > 0 or name in ("AdaDelta", "NoOp")


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_epoch_schedule_bundles_never_span_an_epoch(guarded):
    """An epoch schedule (AdaMax's learning rate halving each epoch) over 2
    epochs of 6 batches at k 4: each epoch one bundle and two single steps
    (a bundle never spans an epoch, so the feed's one epoch a bundle is the
    bundle's), bit-equal to k 1, guarded too; and the second epoch ran at
    its own rate (the run differs from one at a fixed rate)."""
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy

    def net(k, sched):
        conf = _mlp(PORT, tupd.AdaMax(sched), k)
        if guarded:
            conf.global_conf.fault_policy = FaultPolicy(loss_scaling=False)
        return TNet(conf).init(device="cpu")

    step = tsched.StepSchedule("epoch", 1e-2, 0.5, 1)
    a, b, fixed = net(1, step), net(4, step), net(1, 1e-2)
    b._bundle_step(4).emulate = True
    data = _batches(6, seed=8)
    for m in (a, b, fixed):
        m.fit(TExisting(data), epochs=2)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    np.testing.assert_array_equal(a.opt_state_flat(), b.opt_state_flat())
    assert a.iteration == b.iteration == 12 and a.epoch == b.epoch == 2
    assert not np.array_equal(a.params_flat(), fixed.params_flat())


def test_new_updaters_never_take_the_fused_adam():
    """The fused Adam's route admits exact-type f32 ``Adam`` groups only."""
    confs = [_mlp(PORT, tupd.get(n.lower())) for n in NAMES]
    for name, conf in zip(NAMES, confs):
        net = TNet(conf).init(device="cpu")
        layout = zero.ShardedUpdateLayout(net.layers, net.params_, 2)
        impls = fu.resolve_group_impls(layout)
        assert all((impl is not None) == (name == "Adam") for impl in impls), name


@pytest.mark.parametrize("name", ["AMSGrad", "AdaDelta"])
def test_zero1_layout_round_trips_the_slots(name):
    net = TNet(_mlp(PORT, tupd.get(name.lower()))).init(device="cpu")
    net.fit(TExisting(_batches(2)))
    layout = zero.ShardedUpdateLayout(net.layers, net.params_, 3)
    z = layout.shard_opt_state(net.opt_state_)
    assert sorted(z[0]) == sorted(net.opt_state_[0]["W"])
    back = layout.unshard_opt_state(z, net.opt_state_)
    for mine, theirs in zip(back, net.opt_state_):
        for p in theirs:
            for s in theirs[p]:
                assert torch.equal(mine[p][s], theirs[p][s])


# ---------------------------------------------------------- every fit path
def _knobbed(name, k=1, policy=None):
    """``_mlp`` under ``name`` on a warmup-cosine learning rate (where it
    has one), with l1 and the per-layer l2 clip."""
    upd = tupd.get(name.lower())
    if upd.get("learning_rate") is not None:
        upd = type(upd).__new__(type(upd))
        dict.__init__(upd, tupd.get(name.lower()))
        upd["learning_rate"] = tupd._schedule_dict(
            tsched.WarmupSchedule(2, tsched.CosineSchedule(1e-2, 10)))
    conf = _mlp(PORT, upd, k, l1=1e-4, gradient_normalization=("clip_l2_per_layer", 0.5))
    if policy is not None:
        conf.global_conf.fault_policy = policy
    return TNet(conf).init(device="cpu")


def _same(a, b):
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    np.testing.assert_array_equal(a.opt_state_flat(), b.opt_state_flat())


@pytest.mark.parametrize("name", NEW)
def test_every_fit_path_trains_under_the_new_updaters(name):
    """Under each new updater (a schedule, l1, the clip): the one-rank
    wrapper replicated and ZeRO-1, the same layers as a ComputationGraph,
    the guarded step with a NaN-poisoned batch (against the run without it,
    the device clock skipping the step) eager and in an emulated k-2
    bundle, and the one-rank ``SharedTrainingMaster`` replicated, sharded
    and bundled: all bit-equal to ``MultiLayerNetwork.fit`` or to each
    other."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection

    data = _batches(4, seed=6)
    ref = _knobbed(name)
    ref.fit(TExisting(data))
    assert np.abs(ref.opt_state_flat()).max() > 0
    for sharded in (False, True):
        net = _knobbed(name)
        ParallelWrapper.builder(net).workers(1).sharded_update(sharded).build().fit(
            TExisting(data))
        _same(net, ref)

    graph_conf = (tconf.NeuralNetConfiguration.builder().seed(7)
                  .updater(ref.layers[0].updater).l1(1e-4)
                  .gradient_normalization("clip_l2_per_layer", 0.5).graph_builder()
                  .add_inputs("in").set_input_types(tconf.InputType.feed_forward(12)))
    graph_conf.add_layer("d0", tlayers.DenseLayer(n_out=16, activation="relu"), "in")
    graph_conf.add_layer("out", tlayers.OutputLayer(n_out=3, activation="softmax",
                                                    loss="mcxent"), "d0")
    graph = ComputationGraph(graph_conf.set_outputs("out").build()).init(device="cpu")
    graph.params_ = {"d0": dict(_knobbed(name).params_[0]),
                     "out": dict(_knobbed(name).params_[1])}
    graph.fit(TExisting(data))
    for i, v in enumerate(("d0", "out")):
        for k in ref.params_[i]:
            assert torch.equal(graph.params_[v][k], ref.params_[i][k]), (v, k)

    skip = FaultPolicy(loss_scaling=False)
    clean = _knobbed(name, policy=skip)
    clean.fit(TExisting(data[:1] + data[2:]))
    for k in (1, 2):
        guarded = _knobbed(name, k, policy=skip)
        if k > 1:
            guarded._bundle_step(k).emulate = True
        with fault_injection([1]):
            guarded.fit(TExisting(data))
        assert guarded.bad_step_count == 1 and int(guarded.fault_state_["good_count"]) == 3
        _same(guarded, clean)

    runs = {}
    for sharded in (False, True):
        for k in (1, 2):
            net = _knobbed(name, k)
            (SharedTrainingMaster.builder(1e-4).sharded_update(sharded).build()
             .fit(net, TExisting(data)))
            runs[sharded, k] = net
    for key, net in runs.items():
        _same(net, runs[False, 1])
    assert not np.array_equal(runs[False, 1].params_flat(), _knobbed(name).params_flat())
    assert np.isfinite(runs[False, 1].params_flat()).all()


# ---------------------------------------------------------------- LeNet fit
def _lenet(pkg, upd, **knobs):
    """The zoo's LeNet (28x28x1, 10 classes), built through the builder
    with ``knobs``."""
    conf, layers, _ = pkg
    b = conf.NeuralNetConfiguration.builder().seed(12).updater(upd).weight_init("xavier")
    for knob, v in knobs.items():
        b = getattr(b, knob)(*v) if isinstance(v, tuple) else getattr(b, knob)(v)
    return (b.list()
            .layer(layers.ConvolutionLayer(n_out=20, kernel_size=5, convolution_mode="same",
                                           activation="relu"))
            .layer(layers.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(layers.ConvolutionLayer(n_out=50, kernel_size=5, convolution_mode="same",
                                           activation="relu"))
            .layer(layers.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"))
            .layer(layers.DenseLayer(n_out=500, activation="relu"))
            .layer(layers.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.convolutional_flat(28, 28, 1)).build())


def _fit_pair(jconf_, tconf_, steps=5, batch=4, seed=3):
    jnet = JNet(jconf_).init()
    tnet = TNet(tconf_).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    rng = np.random.default_rng(seed)
    x = rng.random((steps * batch, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, steps * batch)]
    jnet.fit(JDataSet(x, y), batch_size=batch)
    tnet.fit(TDataSet(x, y), batch_size=batch)
    assert tnet.iteration == jnet.iteration == steps
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)
    assert abs(tnet.score() - float(jnet.score())) <= FIT_TOL
    return jnet, tnet


#: the fit's updaters: learning rate 1e-3 (Sgd 1e-2) and, for those that
#: divide by |g| + eps, eps 1e-3 (see below)
FIT_UPDATERS = {
    "AMSGrad": lambda u: u.AMSGrad(1e-3, epsilon=1e-3),
    "AdaDelta": lambda u: u.AdaDelta(),
    "AdaGrad": lambda u: u.AdaGrad(1e-3, epsilon=1e-3),
    "AdaMax": lambda u: u.AdaMax(1e-3, epsilon=1e-3),
    "Adam": lambda u: u.Adam(1e-3, epsilon=1e-3),
    "Nadam": lambda u: u.Nadam(1e-3, epsilon=1e-3),
    "Nesterovs": lambda u: u.Nesterovs(1e-3, 0.9),
    "RmsProp": lambda u: u.RmsProp(1e-3),
    "Sgd": lambda u: u.Sgd(1e-2),
}


@pytest.mark.parametrize("name", sorted(FIT_UPDATERS))
def test_lenet_fit_tracks_jax_under_each_updater(name):
    """LeNet's near-zero gradient elements differ between the packages by
    up to 6.5e-9 (the order of the sums; measured here), and an updater
    that divides by |g| + eps multiplies that by lr/eps: 1e4 for AdaGrad's
    default eps 1e-6 at lr 1e-2, 1e5 for AdaMax's 1e-8 at lr 1e-3, which
    alone would pass 1e-5. So the fit runs those updaters at eps 1e-3
    (amplification 1); ``test_apply_matches_jax_over_a_thousand_steps``
    holds each at its default eps."""
    jnet, tnet = _fit_pair(_lenet(JAX, FIT_UPDATERS[name](jupd)),
                           _lenet(PORT, FIT_UPDATERS[name](tupd)))
    assert name == "Sgd" or np.abs(tnet.opt_state_flat()).max() > 0


def test_lenet_fit_tracks_jax_under_l1_and_gradient_normalization():
    knobs = dict(l1=1e-3, l2_bias=1e-3, weight_decay=1e-4,
                 gradient_normalization=("clip_l2_per_layer", 0.5), activation="relu",
                 bias_init=0.1)
    jnet, tnet = _fit_pair(_lenet(JAX, jupd.Nadam(1e-3, epsilon=1e-3), **knobs),
                           _lenet(PORT, tupd.Nadam(1e-3, epsilon=1e-3), **knobs))
    assert tnet.conf.to_dict() == jnet.conf.to_dict()


# --------------------------------------------------------------------- zips
@pytest.mark.parametrize("name", ["AMSGrad", "AdaDelta"])
def test_jax_zip_resumes_in_the_port(name, tmp_path):
    upd = {"AMSGrad": lambda p: p.AMSGrad(1e-2), "AdaDelta": lambda p: p.AdaDelta()}[name]
    jnet = JNet(_mlp(JAX, upd(jupd))).init()
    data = _batches(3, seed=4)
    for ds in data[:2]:
        jnet.fit(JDataSet(ds.features, ds.labels))
    path = str(tmp_path / "jax.zip")
    JSer.write_model(jnet, path)
    tnet = TSer.restore_multi_layer_network(path, device="cpu")
    assert tnet.iteration == 2
    np.testing.assert_array_equal(tnet.opt_state_flat(), jnet.opt_state_flat())
    assert sorted(tnet.opt_state_[0]["W"]) == sorted(jnet.opt_state_[0]["W"])
    jnet.fit(JDataSet(data[2].features, data[2].labels))
    tnet.fit(TExisting([data[2]]))
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)


@pytest.mark.parametrize("name", ["AMSGrad", "AdaDelta"])
def test_port_zip_resumes_in_jax(name, tmp_path):
    upd = {"AMSGrad": lambda p: p.AMSGrad(1e-2), "AdaDelta": lambda p: p.AdaDelta()}[name]
    tnet = TNet(_mlp(PORT, upd(tupd))).init(device="cpu")
    data = _batches(3, seed=5)
    tnet.fit(TExisting(data[:2]))
    path = str(tmp_path / "port.zip")
    TSer.write_model(tnet, path)
    jnet = JSer.restore_multi_layer_network(path)
    assert jnet.iteration == 2
    np.testing.assert_array_equal(jnet.opt_state_flat(), tnet.opt_state_flat())
    jnet.fit(JDataSet(data[2].features, data[2].labels))
    tnet.fit(TExisting([data[2]]))
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0,
                               atol=FIT_TOL)
