"""Dropout, weight noise and parameter constraints of the port against the
JAX package, on the CPU.

The two packages draw their noise from different generators, so draws are
never compared bit for bit across them. Each variant is held two ways:

- its draw alone, by its moments (the port's counter-based
  ``NoiseSource``): AlphaDropout's output mean within 0.05 of 0 and std
  within 0.05 of 1 on standard-normal input (the reference's own bound,
  ``tests/test_parity_tail.py``), a keep fraction within 5 standard errors
  of its probability, a normal's mean and std within 5 standard errors;
- the arithmetic around the draw, with JAX's own draw fed in
  (``dropouts.FedNoise``): a variant's output within 1e-6, a network's
  train-mode loss and gradients within 1e-5 (f32: the same operations, sums
  in another order), one update within 1e-5 and each constraint alone
  within 1e-6.

Configurations and zips that use every ``IDropout``, ``IWeightNoise`` and
constraint load in the port from the reference's JSON, write it back key
for key, and a reference zip restores with the reference's ``output``
within 1e-6 (the repair of ``UnknownConfigClassError: Unknown config class
'AlphaDropout'``); a port zip restores in the reference, and a zip written
mid-fit resumes bit for bit.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import regularization as jreg
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import dropouts as jdrop
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import _apply_layer_updates as japply
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import regularization as treg
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import dropouts as tdrop
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.graph_builder import ComputationGraphConfiguration as TGC
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

JAX = (jconf, jlayers, jupd, jreg)
PORT = (tconf, tlayers, tupd, treg)
COMBINE_TOL = 1e-6
GRAD_TOL = 1e-5
CONSTRAINT_TOL = 1e-6


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- the variants
#: name -> (constructor on a package's layers module, input kind)
DROPOUTS = {
    "Dropout": lambda L: L.Dropout(0.3),
    "AlphaDropout": lambda L: L.AlphaDropout(0.2),
    "GaussianDropout": lambda L: L.GaussianDropout(0.25),
    "GaussianNoise": lambda L: L.GaussianNoise(0.2),
}
WEIGHT_NOISE = {
    "DropConnect": lambda L: L.DropConnect(0.8),
    "DropConnect-biases": lambda L: L.DropConnect(0.7, apply_to_biases=True),
    "WeightNoise": lambda L: L.WeightNoise(0.05),
    "WeightNoise-mult": lambda L: L.WeightNoise(0.1, additive=False),
}
CONSTRAINTS = {
    "MaxNorm": lambda R: R.MaxNormConstraint(0.6),
    "MinMaxNorm": lambda R: R.MinMaxNormConstraint(0.3, 0.5, 0.7),
    "NonNegative": lambda R: R.NonNegativeConstraint(),
    "UnitNorm": lambda R: R.UnitNormConstraint(),
}


def jax_draw(variant, key, shape, dtype=jnp.float32):
    """The draw a JAX variant makes from ``key`` for an input of ``shape``."""
    if isinstance(variant, (jdrop.Dropout, jdrop.AlphaDropout)):
        return np.asarray(jax.random.bernoulli(key, 1.0 - variant.p, shape))
    if isinstance(variant, jdrop.DropConnect):
        return np.asarray(jax.random.bernoulli(key, variant.weight_retain_prob, shape))
    return np.asarray(jax.random.normal(key, shape, dtype))


# ------------------------------------------------------------------ moments
def _within(value, want, se, n_se=5.0):
    assert abs(value - want) <= n_se * se, (value, want, se)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_dropout_moments(name, dtype):
    v = DROPOUTS[name](tlayers)
    src = tdrop.NoiseSource(7, 3).child(1)
    n = 200 * 200
    if name == "AlphaDropout":
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((200, 200))
                             .astype(np.float32)).to(dtype)
        y = v.apply(x, src).float()
        assert abs(float(y.mean())) < 0.05 and abs(float(y.std()) - 1.0) < 0.05
        mask = v.draw(src, x.shape, dtype, "cpu")
        _within(float(mask.float().mean()), 0.8, (0.8 * 0.2 / n) ** 0.5)
        return
    x = torch.ones((200, 200), dtype=dtype)
    y = v.apply(x, src).float()
    if name == "Dropout":
        keep = 0.7
        _within(float((y != 0).float().mean()), keep, (keep * (1 - keep) / n) ** 0.5)
        _within(float(y.mean()), 1.0, (1 / keep - 1) ** 0.5 / n ** 0.5)
    elif name == "GaussianDropout":
        std = (0.25 / 0.75) ** 0.5
        _within(float(y.mean()), 1.0, std / n ** 0.5)
        assert abs(float(y.std()) / std - 1) < 0.02 + (0.01 if dtype == torch.bfloat16 else 0)
    else:  # GaussianNoise on ones
        _within(float(y.mean()), 1.0, 0.2 / n ** 0.5)
        assert abs(float(y.std()) / 0.2 - 1) < 0.02 + (0.01 if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("name", sorted(WEIGHT_NOISE))
def test_weight_noise_moments(name):
    wn = WEIGHT_NOISE[name](tlayers)
    params = {"W": torch.ones((300, 200)), "b": torch.ones((200,))}
    out = wn.apply_to_params(params, tdrop.NoiseSource(1, 0))
    n = 300 * 200
    if name.startswith("DropConnect"):
        keep = wn.weight_retain_prob
        _within(float((out["W"] != 0).float().mean()), keep, (keep * (1 - keep) / n) ** 0.5)
        if wn.apply_to_biases:
            assert not bool((out["b"] != 0).all())
        else:
            assert torch.equal(out["b"], params["b"])
    else:
        delta = out["W"] - 1.0
        _within(float(delta.mean()), 0.0, wn.stddev / n ** 0.5)
        assert abs(float(delta.std()) / wn.stddev - 1) < 0.02
        assert torch.equal(out["b"], params["b"])


def test_noise_source_is_a_function_of_its_key():
    """Same key, same bits (an int position or a 0-dim tensor one); another
    position, rank, stream or seed, other bits; ``shared`` drops the rank;
    uniforms are the top 24 bits and bernoulli masks their comparison."""
    s = tdrop.NoiseSource(5, 9, rank=1)
    a = s.child(2).bits(1000, "cpu")
    assert torch.equal(a, tdrop.NoiseSource(5, 9, rank=1).child(2).bits(1000, "cpu"))
    assert torch.equal(a, tdrop.NoiseSource(5, torch.tensor(9), rank=1).child(2).bits(1000, "cpu"))
    others = [tdrop.NoiseSource(5, 10, 1).child(2), tdrop.NoiseSource(5, 9, 0).child(2),
              s.child(3), tdrop.NoiseSource(6, 9, 1).child(2), s.child(2).shared()]
    for o in others:
        assert (o.bits(1000, "cpu") == a).float().mean() < 0.01
    assert torch.equal(tdrop.NoiseSource(5, 9, 0).shared().bits(64, "cpu"),
                       tdrop.NoiseSource(5, 9, 3).shared().bits(64, "cpu"))
    ranked = tdrop.NoiseSource(5, 9, 0, ranked_params=True)
    assert not torch.equal(ranked.shared().bits(64, "cpu"),
                           tdrop.NoiseSource(5, 9, 3, ranked_params=True).shared().bits(64, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    u = s.child(2).uniform((10, 100), "cpu")
    assert torch.equal(u.reshape(-1), (a >> 8).float() * 2.0 ** -24)
    assert torch.equal(s.child(2).bernoulli(0.6, (10, 100), "cpu"), u < 0.6)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        s.bits(2 ** 32, "meta")


# --------------------------------------------------- combines on JAX's draw
@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_dropout_combine_with_jax_draw(name):
    jv, tv = DROPOUTS[name](jlayers), DROPOUTS[name](tlayers)
    x = np.random.default_rng(2).standard_normal((6, 7)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jv.apply(jnp.asarray(x), key))
    draw = jax_draw(jv, key, x.shape)
    tx = torch.from_numpy(x).requires_grad_()
    got = tv.apply(tx, tdrop.FedNoise([draw]))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=COMBINE_TOL)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jv.apply(a, key) * w))(jnp.asarray(x)))
    (tg,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(WEIGHT_NOISE))
def test_weight_noise_combine_with_jax_draw(name):
    jv, tv = WEIGHT_NOISE[name](jlayers), WEIGHT_NOISE[name](tlayers)
    rng = np.random.default_rng(4)
    params = {"W": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32),
              "Wo": rng.standard_normal((4, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    want = jv.apply_to_params({k: jnp.asarray(v) for k, v in params.items()}, key)
    draws = []
    for i, (k, v) in enumerate(sorted(params.items())):
        if jv.apply_to_biases or jv._is_weight(k):
            draws.append(jax_draw(jv, jax.random.fold_in(key, i), v.shape))
    got = tv.apply_to_params({k: torch.from_numpy(v) for k, v in params.items()},
                             tdrop.FedNoise(draws))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=COMBINE_TOL)


@pytest.mark.parametrize("shape", [(7,), (5, 6), (3, 3, 4, 5)], ids=["1d", "dense", "conv"])
@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraint_matches_jax(name, shape):
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = np.asarray(CONSTRAINTS[name](jreg).apply(jnp.asarray(w)))
    got = CONSTRAINTS[name](treg).apply(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONSTRAINT_TOL)
    assert CONSTRAINTS[name](treg).applies_to == ("W",)


# --------------------------------------------------------------- networks
def noisy_mln(pkg, dropout="AlphaDropout", weight_noise="DropConnect", constraint="MaxNorm",
              updater=None):
    """Dense -> dense -> output, with a dropout object and weight noise on
    the first layer, a float dropout on the second, both on the output
    layer, and a constraint on the first and the output layers."""
    conf, L, upd, R = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3)
            .updater(updater(upd) if updater else upd.Sgd(0.1)).list()
            .layer(L.DenseLayer(n_out=6, activation="tanh", dropout=DROPOUTS[dropout](L),
                                weight_noise=WEIGHT_NOISE[weight_noise](L),
                                constraints=[CONSTRAINTS[constraint](R)]))
            .layer(L.DenseLayer(n_out=5, activation="relu", dropout=0.25))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                 dropout=L.GaussianNoise(0.1),
                                 weight_noise=L.WeightNoise(0.05),
                                 constraints=[CONSTRAINTS[constraint](R)]))
            .set_input_type(conf.InputType.feed_forward(4)).build())


def mln_pair(**kw):
    jnet = JNet(noisy_mln(JAX, **kw)).init()
    tnet = TNet(noisy_mln(PORT, **kw)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    return jnet, tnet


def mln_jax_draws(jnet, rng, x_shapes):
    """The draws JAX's ``_loss_and_new_state`` makes from ``rng``, in the
    order the port asks for them: per layer its input dropout, then its
    weight noise (params sorted); the output layer's weight noise from the
    unsplit rng last."""
    n = len(jnet.layers)
    rngs = jax.random.split(rng, n)
    draws = []
    for i, layer in enumerate(jnet.layers):
        d = layer.dropout
        if not isinstance(d, (int, float)) or d > 0:
            v = d if not isinstance(d, (int, float)) else jdrop.Dropout(d)
            draws.append(jax_draw(v, rngs[i], x_shapes[i]))
        wkey = rngs[i] if i < n - 1 else rng
        wn = layer.weight_noise
        if wn is not None:
            wkey = jax.random.fold_in(wkey, 0x5EED)
            for j, (k, p) in enumerate(sorted(jnet.params_[i].items())):
                if wn.apply_to_biases or wn._is_weight(k):
                    draws.append(jax_draw(wn, jax.random.fold_in(wkey, j), p.shape))
    return draws


@pytest.mark.parametrize("dropout", sorted(DROPOUTS))
@pytest.mark.parametrize("weight_noise", ["DropConnect", "WeightNoise"])
def test_mln_loss_gradients_and_step_with_jax_draws(dropout, weight_noise):
    """Train-mode loss, gradients and one Sgd update (with the constraints)
    of the port on JAX's draws, against JAX."""
    jnet, tnet = mln_pair(dropout=dropout, weight_noise=weight_noise)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    key = jax.random.PRNGKey(21)

    def jloss(p):
        loss, _ = jnet._loss_and_new_state(p, jnet.state_, jnp.asarray(x), jnp.asarray(y),
                                           None, None, key, train=True)
        return loss

    jl, jg = jax.value_and_grad(jloss)(jnet.params_)
    draws = mln_jax_draws(jnet, key, [(8, 4), (8, 6), (8, 5)])
    feed = tdrop.FedNoise(draws)
    tl, _, tg = tnet._value_and_grad(torch.from_numpy(x), torch.from_numpy(y), None, None,
                                     noise=feed)
    assert feed.taken == len(draws)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL)
    for i in range(3):
        for k in tg[i]:
            np.testing.assert_allclose(tg[i][k].numpy(), np.asarray(jg[i][k]), rtol=0,
                                       atol=GRAD_TOL)
    jp, _ = japply(jnet.layers, jnet.params_, jg, jnet.opt_state_ or
                   [{k: {} for k in p} for p in jnet.params_], 1, 0, 0)
    tnet._apply_step(tl, [{}] * 3, tg)
    for i in range(3):
        for k in tnet.params_[i]:
            np.testing.assert_allclose(tnet.params_[i][k].numpy(), np.asarray(jp[i][k]),
                                       rtol=0, atol=GRAD_TOL)
    # the constraint held: every unit's norm of the first W within 0.6
    norms = torch.linalg.norm(tnet.params_[0]["W"], dim=0)
    assert float(norms.max()) <= 0.6 + 1e-6


@pytest.mark.parametrize("constraint", sorted(CONSTRAINTS))
def test_constraints_after_one_fit_step_match_jax(constraint):
    """One ``fit`` step without noise (dropout 0): the constrained params
    after the update within 1e-6 of JAX's."""
    def build(pkg):
        conf, L, upd, R = pkg
        return (conf.NeuralNetConfiguration.builder().seed(5).updater(upd.Sgd(0.5)).list()
                .layer(L.DenseLayer(n_out=6, activation="tanh",
                                    constraints=[CONSTRAINTS[constraint](R)]))
                .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                     constraints=[CONSTRAINTS[constraint](R)]))
                .set_input_type(conf.InputType.feed_forward(4)).build())

    jnet = JNet(build(JAX)).init()
    tnet = TNet(build(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jnet.fit(JDataSet(x, y), batch_size=16)
    tnet.fit(ExistingDataSetIterator([TDataSet(x, y)]))
    for i in range(2):
        for k in tnet.params_[i]:
            np.testing.assert_allclose(tnet.params_[i][k].numpy(),
                                       np.asarray(jnet.params_[i][k]), rtol=0,
                                       atol=CONSTRAINT_TOL)


def test_output_layer_input_dropout_and_weight_noise_reach_the_loss():
    """The walk drops the output layer's input and the score path noises
    its weights (the reference's regression, ``test_parity_tail.py``): at
    lr 0 only the noise moves the score, and each alone moves it."""
    def build(dropout, noise):
        conf = (tconf.NeuralNetConfiguration.builder().seed(3).updater(tupd.Sgd(0.0)).list()
                .layer(tlayers.DenseLayer(n_out=8, activation="tanh"))
                .layer(tlayers.OutputLayer(n_out=2, activation="softmax", loss="mcxent",
                                           dropout=dropout, weight_noise=noise))
                .set_input_type(tconf.InputType.feed_forward(4)).build())
        return TNet(conf).init(device="cpu")

    rng = np.random.default_rng(1)
    ds = TDataSet(rng.standard_normal((32, 4)).astype(np.float32),
                  np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)])
    scores = {}
    for label, d, wn in [("clean", 0.0, None), ("dropout", 0.5, None),
                         ("noise", 0.0, tlayers.WeightNoise(0.5))]:
        net = build(d, wn)
        net.fit(ExistingDataSetIterator([ds]))
        scores[label] = float(net.score_)
    assert scores["clean"] != scores["dropout"] and scores["clean"] != scores["noise"]


def test_inference_is_deterministic_and_noise_free():
    jnet, tnet = mln_pair()
    x = np.random.default_rng(9).standard_normal((5, 4)).astype(np.float32)
    a, b = tnet.output(x), tnet.output(x)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, np.asarray(jnet.output(x)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="requires an rng"):
        tnet._loss_and_new_state(tnet.params_, tnet.state_, torch.from_numpy(x),
                                 torch.zeros(5, 3), None, None, train=True, noise=None)


# -------------------------------------------------- serde and zips (repair)
def _add(pkg):
    if pkg is JAX:
        from deeplearning4j_tpu.nn.conf.graph_vertices import ElementWiseVertex
    else:
        from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
    return ElementWiseVertex("add")


def graph_conf(pkg):
    conf, L, upd, R = pkg
    return (conf.NeuralNetConfiguration.builder().seed(9).updater(upd.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("a", L.DenseLayer(n_out=5, activation="tanh",
                                         dropout=L.GaussianDropout(0.2),
                                         weight_noise=L.WeightNoise(0.02, additive=False),
                                         constraints=[R.UnitNormConstraint()]), "in")
            .add_layer("b", L.DenseLayer(n_out=5, activation="relu",
                                         dropout=L.AlphaDropout(0.1),
                                         constraints=[R.MinMaxNormConstraint(0.1, 0.9, 0.5),
                                                      R.NonNegativeConstraint()]), "in")
            .add_vertex("m", _add(pkg), "a", "b")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                            dropout=0.3,
                                            weight_noise=L.DropConnect(0.9, True),
                                            constraints=[R.MaxNormConstraint(1.5)]), "m")
            .set_outputs("out").set_input_types(conf.InputType.feed_forward(4)).build())


def test_reference_configurations_load_and_write_back_key_for_key():
    """The reference's JSON with every IDropout, IWeightNoise and constraint,
    on a MultiLayerNetwork and a ComputationGraph, loads in the port and the
    port writes the same dict; the port's JSON loads in the reference."""
    from deeplearning4j_tpu.nn.conf.builders import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.graph_builder import ComputationGraphConfiguration as JGC

    for d in sorted(DROPOUTS):
        for wn in sorted(WEIGHT_NOISE):
            for c in sorted(CONSTRAINTS):
                js = noisy_mln(JAX, dropout=d, weight_noise=wn, constraint=c).to_json()
                tc = TConf.from_json(js)
                assert json.loads(tc.to_json()) == json.loads(js)
                assert json.loads(JConf.from_json(tc.to_json()).to_json()) == json.loads(js)
    assert isinstance(tc.layers[0].dropout, tdrop.IDropout)
    assert isinstance(tc.layers[0].weight_noise, tdrop.IWeightNoise)
    js = graph_conf(JAX).to_json()
    tg = TGC.from_json(js)
    assert json.loads(tg.to_json()) == json.loads(js)
    assert json.loads(JGC.from_json(tg.to_json()).to_json()) == json.loads(js)
    assert isinstance(tg.vertices["b"].layer.dropout, tdrop.AlphaDropout)
    assert isinstance(tg.vertices["out"].layer.weight_noise, tdrop.DropConnect)
    assert [type(c).__name__ for c in tg.vertices["b"].layer.constraints] == \
        ["MinMaxNormConstraint", "NonNegativeConstraint"]
    # the port's own configuration is the reference's, key for key
    assert json.loads(graph_conf(PORT).to_json()) == json.loads(js)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_reference_zip_restores_and_serves(kind, tmp_path):
    """A zip the reference wrote from a trained noisy network restores in the
    port; its ``output`` within 1e-6 of the reference's; and the port's zip
    of it restores in the reference."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    path = str(tmp_path / "ref.zip")
    if kind == "mln":
        jnet = JNet(noisy_mln(JAX)).init()
        jnet.fit(JDataSet(x, y), batch_size=8)
        JSer.write_model(jnet, path)
        tnet = ModelSerializer.restore_multi_layer_network(path, device="cpu")
        want, got = np.asarray(jnet.output(x)), tnet.output(x)
    else:
        jnet = JGraph(graph_conf(JAX)).init()
        jnet.fit(JDataSet(x, y), batch_size=8)
        JSer.write_model(jnet, path)
        tnet = ModelSerializer.restore_computation_graph(path, device="cpu")
        want, got = np.asarray(jnet.output_single(x)), tnet.output_single(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tnet.iteration == jnet.iteration
    back = str(tmp_path / "port.zip")
    ModelSerializer.write_model(tnet, back)
    with zipfile.ZipFile(back) as z:
        meta = json.loads(z.read("meta.json"))
    assert "rng" not in meta and meta["dropout_noise"]["position"] == tnet.iteration
    if kind == "mln":
        again = JSer.restore_multi_layer_network(back)
        np.testing.assert_allclose(np.asarray(again.output(x)), want, rtol=0, atol=1e-6)
    else:
        again = JSer.restore_computation_graph(back)
        np.testing.assert_allclose(np.asarray(again.output_single(x)), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_midfit_zip_resumes_bit_for_bit(kind, tmp_path):
    """A zip written after two noisy steps restores, and its next two steps
    equal the uninterrupted run's (the dropout RNG's position is the
    iteration, its seed in ``meta.json``); a changed seed changes them."""
    rng = np.random.default_rng(12)
    dss = [TDataSet(rng.standard_normal((8, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(4)]
    if kind == "mln":
        net = TNet(noisy_mln(PORT, updater=lambda u: u.Adam(0.01))).init(device="cpu")
        restore = ModelSerializer.restore_multi_layer_network
    else:
        net = TGraph(graph_conf(PORT)).init(device="cpu")
        restore = ModelSerializer.restore_computation_graph
    net.noise_seed = 4242  # not the configuration's: the zip must carry it
    net.fit(ExistingDataSetIterator(dss[:2]))
    path = str(tmp_path / "mid.zip")
    ModelSerializer.write_model(net, path)
    net.fit(ExistingDataSetIterator(dss[2:]))
    resumed = restore(path, device="cpu")
    assert resumed.noise_seed == 4242 and resumed.iteration == 2
    other = restore(path, device="cpu")
    other.noise_seed = 1
    resumed.fit(ExistingDataSetIterator(dss[2:]))
    other.fit(ExistingDataSetIterator(dss[2:]))
    np.testing.assert_array_equal(resumed.params_flat(), net.params_flat())
    np.testing.assert_array_equal(resumed.opt_state_flat(), net.opt_state_flat())
    assert not np.array_equal(other.params_flat(), net.params_flat())


def test_graph_loss_and_gradients_with_jax_draws():
    """The graph's train-mode loss and gradients on JAX's draws: per layer
    vertex (JAX's split order) input dropout, weight noise (not for the
    output vertex), then the output's weight noise from ``fold_in(rng, 0)``."""
    jnet = JGraph(graph_conf(JAX)).init()
    tnet = TGraph(graph_conf(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    key = jax.random.PRNGKey(31)

    def jloss(p):
        loss, _ = jnet._loss_and_new_state(p, jnet.state_, (jnp.asarray(x),),
                                           (jnp.asarray(y),), (None,), (None,), key, train=True)
        return loss

    jl, jg = jax.value_and_grad(jloss)(jnet.params_)
    keys = dict(zip(jnet.layer_names, jax.random.split(key, len(jnet.layer_names))))
    shapes = {"a": (6, 4), "b": (6, 4), "out": (6, 5)}
    draws = []
    for name in tnet.topo:
        if name not in keys:
            continue
        layer = jnet._layer(name)
        d = layer.dropout
        if not isinstance(d, (int, float)) or d > 0:
            v = d if not isinstance(d, (int, float)) else jdrop.Dropout(d)
            draws.append(jax_draw(v, keys[name], shapes[name]))
        wn = layer.weight_noise
        if wn is not None and not layer.is_output_layer:
            wk = jax.random.fold_in(keys[name], 0x5EED)
            for j, (k, p) in enumerate(sorted(jnet.params_[name].items())):
                if wn.apply_to_biases or wn._is_weight(k):
                    draws.append(jax_draw(wn, jax.random.fold_in(wk, j), p.shape))
    wk = jax.random.fold_in(jax.random.fold_in(key, 0), 0x5EED)
    out = jnet._layer("out")
    for j, (k, p) in enumerate(sorted(jnet.params_["out"].items())):
        draws.append(jax_draw(out.weight_noise, jax.random.fold_in(wk, j), p.shape))
    feed = tdrop.FedNoise(draws)
    tl, _, tg = tnet._value_and_grad([torch.from_numpy(x)], [torch.from_numpy(y)], [None],
                                     noise=feed)
    assert feed.taken == len(draws)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL)
    for name in tg:
        for k in tg[name]:
            np.testing.assert_allclose(tg[name][k].numpy(), np.asarray(jg[name][k]), rtol=0,
                                       atol=GRAD_TOL)


def test_unknown_dropout_class_is_gone():
    """The repair's gate: the reference's AlphaDropout no longer raises
    ``UnknownConfigClassError`` in the port, and a constraint decodes to its
    class, not an opaque dict."""
    from deeplearning4j_tpu_torch.nn.conf import serde

    js = jlayers.DenseLayer(n_out=2, dropout=jlayers.AlphaDropout(0.2),
                            constraints=[jreg.MaxNormConstraint(2.0)]).to_dict()
    layer = tlayers.DenseLayer.from_dict(json.loads(json.dumps(js)))
    assert isinstance(layer.dropout, tdrop.AlphaDropout) and layer.dropout.p == 0.2
    assert isinstance(layer.constraints[0], treg.MaxNormConstraint)
    assert not isinstance(layer.constraints[0], serde.TaggedConf)
