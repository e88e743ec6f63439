"""VariationalAutoencoder, AutoEncoder and both networks' ``pretrain``
against the JAX package on the CPU.

JAX draws its noise from ``jax.random`` keys; the port from its noise
sources, which a ``FedNoise`` replaces with given draws. Each case computes
JAX's own draws from the key JAX uses (the network's next key in
``pretrain_layer``, as ``_next_rng`` splits it) and feeds them to the port:
the AutoEncoder's kept-element mask, the VAE's eps of each sample, a
distribution's sample draws (a composite's part by part).

- ``pretrain_loss`` and its gradient for the five reconstruction
  distributions (Bernoulli with sigmoid and another activation, Gaussian,
  Exponential, LossFunctionWrapper, Composite) and the AutoEncoder, within
  TOL (1e-5 of the largest magnitude, f32).
- The VAE's other methods: ``apply`` (the mean of q(z|x)), ``reconstruct``,
  ``reconstruction_log_probability``, ``generate_at_mean_given_z`` and
  ``generate_random_given_z``.
- ``pretrain`` and ``pretrain_layer`` on a MultiLayerNetwork and a
  ComputationGraph (a preprocessor in front of the first pretrained
  vertex) over 3 steps a layer, with an updater, l2 and a constraint: the
  params, updater slots, score and iteration within TOL; the other layers'
  params untouched; JAX's ``ValueError`` for a layer that cannot be
  pretrained.
- The configurations decode both ways.
"""

import json

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
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import regularization as treg
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ListDataSetIterator as TList
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.conf.dropouts import FedNoise
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet

TOL = 1e-5
N_IN, LATENT, B = 6, 3, 5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1.0))


def dists(layers):
    """name -> a distribution of ``layers``' package."""
    return {
        "bernoulli": layers.BernoulliReconstructionDistribution(),
        "bernoulli_hardsigmoid": layers.BernoulliReconstructionDistribution("hardsigmoid"),
        "gaussian": layers.GaussianReconstructionDistribution(),
        "gaussian_tanh": layers.GaussianReconstructionDistribution("tanh"),
        "exponential": layers.ExponentialReconstructionDistribution(),
        "loss_wrapper": layers.LossFunctionWrapper("mse", "sigmoid"),
        "composite": layers.CompositeReconstructionDistribution()
        .add(3, layers.GaussianReconstructionDistribution())
        .add(2, layers.BernoulliReconstructionDistribution())
        .add(1, layers.ExponentialReconstructionDistribution()),
    }


def vae(layers, dist, samples=2):
    return layers.VariationalAutoencoder(
        n_in=N_IN, n_out=LATENT, encoder_layer_sizes=(5, 4), decoder_layer_sizes=(4,),
        reconstruction_distribution=dists(layers)[dist], pzx_activation="tanh",
        num_samples=samples, activation="tanh", weight_init="xavier")


def _pair(dist, samples=2):
    jl, tl = vae(jlayers, dist, samples), vae(tlayers, dist, samples)
    params = {k: v.numpy() for k, v in tl.init_params(
        torch.Generator().manual_seed(1), tconf.InputType.feed_forward(N_IN)).items()}
    jshapes = {k: tuple(v.shape) for k, v in jl.init_params(
        jax.random.PRNGKey(0), jconf.InputType.feed_forward(N_IN)).items()}
    assert {k: v.shape for k, v in params.items()} == jshapes
    # biases away from 0 so every term is exercised
    rng = np.random.default_rng(2)
    for k in params:
        if "b" in k[-2:] or k.endswith("b"):
            params[k] = (rng.standard_normal(params[k].shape) * 0.3).astype(np.float32)
    return jl, tl, params


def _x(seed=3, n=B):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, N_IN)).astype(np.float32)


def eps_draws(key, samples, shape):
    """The VAE's eps of each sample, as JAX draws them from ``key``."""
    return [np.asarray(jax.random.normal(k, shape, jnp.float32))
            for k in jax.random.split(key, samples)]


def sample_draws(dist, key, dist_params):
    """What ``dist.sample(key, dist_params)`` draws in JAX, in the port's
    order."""
    name = type(dist).__name__
    if name == "BernoulliReconstructionDistribution":
        return [np.asarray(jax.random.bernoulli(key, dist.mean(dist_params)))]
    if name == "GaussianReconstructionDistribution":
        return [np.asarray(jax.random.normal(key, dist.mean(dist_params).shape, jnp.float32))]
    if name == "ExponentialReconstructionDistribution":
        return [np.asarray(jax.random.uniform(key, dist_params.shape, jnp.float32, 0.0, 1.0))]
    if name == "CompositeReconstructionDistribution":
        keys = jax.random.split(key, max(len(dist.parts), 1))
        out = []
        for i, (_, _, p_off, n_p, d) in enumerate(dist._iter_slices()):
            out += sample_draws(d, keys[i], dist_params[..., p_off:p_off + n_p])
        return out
    return []


def _torch(params, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}


DISTS = sorted(dists(tlayers))


@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("dist", DISTS)
def test_vae_pretrain_loss_and_gradient(dist, samples):
    jl, tl, params = _pair(dist, samples)
    x, key = _x(), jax.random.PRNGKey(11)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = _torch(params, grad=True)
    tloss = tl.pretrain_loss(tp, torch.tensor(x),
                             FedNoise(eps_draws(key, samples, (B, LATENT))))
    tloss.backward()
    _close(float(tloss.detach()), float(jloss))
    for k in params:
        _close(tp[k].grad.numpy(), np.asarray(jgrads[k]))


@pytest.mark.parametrize("dist", DISTS)
def test_vae_other_methods(dist):
    jl, tl, params = _pair(dist)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _torch(params)
    x = _x(4)
    _close(tl.apply(tp, torch.tensor(x))[0].numpy(), np.asarray(jl.apply(jp, jnp.asarray(x))[0]))
    _close(tl.reconstruct(tp, x).numpy(), np.asarray(jl.reconstruct(jp, x)))
    key = jax.random.PRNGKey(12)
    want = np.asarray(jl.reconstruction_log_probability(jp, x, 3, rng=key))
    got = tl.reconstruction_log_probability(tp, x, 3,
                                            rng=FedNoise(eps_draws(key, 3, (B, LATENT))))
    _close(got.numpy(), want)
    z = np.random.default_rng(5).standard_normal((B, LATENT)).astype(np.float32)
    _close(tl.generate_at_mean_given_z(tp, z).numpy(),
           np.asarray(jl.generate_at_mean_given_z(jp, z)))
    key = jax.random.PRNGKey(13)
    want = np.asarray(jl.generate_random_given_z(jp, z, rng=key))
    draws = sample_draws(jl.reconstruction_distribution, key, jl.decode(jp, jnp.asarray(z)))
    _close(tl.generate_random_given_z(tp, z, rng=FedNoise(draws)).numpy(), want)
    assert tl.has_loss_function() == jl.has_loss_function()


def test_vae_without_a_source_draws_from_a_fixed_one():
    _, tl, params = _pair("gaussian")
    tp, x = _torch(params), torch.tensor(_x())
    assert torch.equal(tl.pretrain_loss(tp, x), tl.pretrain_loss(tp, x))


@pytest.mark.parametrize("loss", ["mse", "xent"])
@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_pretrain_loss_and_gradient(corruption, loss):
    kw = dict(n_in=N_IN, n_out=4, corruption_level=corruption, loss=loss,
              activation="sigmoid", weight_init="xavier")
    jl, tl = jlayers.AutoEncoder(**kw), tlayers.AutoEncoder(**kw)
    params = {k: v.numpy() for k, v in tl.init_params(
        torch.Generator().manual_seed(2), tconf.InputType.feed_forward(N_IN)).items()}
    params["vb"] = np.linspace(-0.3, 0.3, N_IN).astype(np.float32)
    x, key = _x(6), jax.random.PRNGKey(14)
    jloss, jgrads = jax.value_and_grad(lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = _torch(params, grad=True)
    keep = [np.asarray(jax.random.bernoulli(key, 1.0 - corruption, x.shape))]
    tloss = tl.pretrain_loss(tp, torch.tensor(x), FedNoise(keep) if corruption else None)
    tloss.backward()
    _close(float(tloss.detach()), float(jloss))
    for k in params:
        _close(tp[k].grad.numpy(), np.asarray(jgrads[k]))
    _close(tl.reconstruct(_torch(params), x).numpy(),
           np.asarray(jl.reconstruct({k: jnp.asarray(v) for k, v in params.items()}, x)))


@pytest.mark.parametrize("dist", DISTS)
def test_distribution_json_both_ways(dist):
    jl, tl = vae(jlayers, dist), vae(tlayers, dist)
    jd, td = jserde.encode(jl), tserde.encode(tl)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert tserde.decode(jd) == tl
    assert jserde.encode(tserde.decode(jd)) == jd


# ------------------------------------------------------------------ networks
def _builder(pkg):
    conf, _, upd, reg = pkg
    return (conf.NeuralNetConfiguration.builder().seed(6).updater(upd.Adam(0.01)).l2(1e-3)
            .weight_init("xavier"))


def _layers(pkg):
    _, layers, _, reg = pkg
    return (layers.AutoEncoder(n_out=5, corruption_level=0.3, activation="sigmoid",
                               constraints=[reg.MaxNormConstraint(0.8)]),
            layers.VariationalAutoencoder(
                n_out=LATENT, encoder_layer_sizes=(4,), decoder_layer_sizes=(4,),
                reconstruction_distribution=layers.BernoulliReconstructionDistribution(),
                num_samples=2, activation="tanh"),
            layers.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))


def mln(pkg):
    ae, v, out = _layers(pkg)
    return (_builder(pkg).list().layer(ae).layer(v).layer(out)
            .set_input_type(pkg[0].InputType.feed_forward(N_IN)).build())


def graph(pkg):
    ae, v, out = _layers(pkg)
    return (_builder(pkg).graph_builder().add_inputs("in")
            .add_layer("ae", ae, "in").add_layer("vae", v, "ae").add_layer("out", out, "vae")
            .set_outputs("out").set_input_types(pkg[0].InputType.convolutional(2, 3, 1))
            .build())


JAX = (jconf, jlayers, jupd, jreg)
PORT = (tconf, tlayers, tupd, treg)
#: name -> (builder, JAX class, port class, feature shape, pretrained keys)
NETS = {"mln": (mln, JNet, TNet, (N_IN,), (0, 1)),
        "graph": (graph, JGraph, TGraph, (2, 3, 1), ("ae", "vae"))}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(name):
    build, jcls, tcls = NETS[name][:3]
    jnet = jcls(build(JAX)).init()
    tnet = tcls(build(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return jnet, tnet


def batches(name, n=3):
    shape = NETS[name][3]
    rng = np.random.default_rng(8)
    return rng.uniform(0.0, 1.0, (n * B,) + shape).astype(np.float32)


def step_draws(jnet, name, key, x):
    """The draws of one JAX pretrain step of the layer at ``key`` on
    features ``x``: the next key of the network, then the layer's use of
    it."""
    jnet._rng, k = jax.random.split(jnet._rng)
    if key in (0, "ae"):
        c = 0.3
        return [np.asarray(jax.random.bernoulli(k, 1.0 - c, (x.shape[0], N_IN)))]
    return eps_draws(k, 2, (x.shape[0], LATENT))


def _params(net, key):
    return jax.tree_util.tree_map(np.asarray, interop.export_params(net)[key]) \
        if isinstance(net.params_, dict) else interop.export_params(net)[key]


@pytest.mark.parametrize("whole", [False, True], ids=["pretrain_layer", "pretrain"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_pretrain_tracks_jax(name, whole):
    jnet, tnet = pair(name)
    x = batches(name)
    keys = NETS[name][4]
    # JAX's draws, taken from a copy of its key before it trains
    rng0 = jnet._rng
    draws = []
    for key in (keys if whole else keys[1:]):
        for i in range(3):
            draws += step_draws(jnet, name, key, x[i * B:(i + 1) * B])
    jnet._rng = rng0
    out_before = _params(tnet, 2 if name == "mln" else "out")
    ae_before = _params(tnet, keys[0])
    if whole:
        jnet.pretrain(JList(JDataSet(x, None), B), epochs=1)
        tnet.pretrain(TList(TDataSet(x, None), B), epochs=1, noise=FedNoise(draws))
    else:
        jnet.pretrain_layer(keys[1], JList(JDataSet(x, None), B), epochs=1)
        tnet.pretrain_layer(keys[1], TList(TDataSet(x, None), B), epochs=1,
                            noise=FedNoise(draws))
    assert tnet.iteration == jnet.iteration == (6 if whole else 3)
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(), rtol=0, atol=TOL)
    np.testing.assert_allclose(tnet.opt_state_flat(), jnet.opt_state_flat(), rtol=0, atol=TOL)
    assert abs(tnet.score() - float(jnet.score())) <= TOL * max(abs(float(jnet.score())), 1)
    out_after = _params(tnet, 2 if name == "mln" else "out")
    assert all(np.array_equal(out_before[k], out_after[k]) for k in out_before)
    if not whole:
        ae_after = _params(tnet, keys[0])
        assert all(np.array_equal(ae_before[k], ae_after[k]) for k in ae_before)
    # the AutoEncoder's max-norm constraint held after its updates
    if whole:
        w = _params(tnet, keys[0])["W"]
        assert np.linalg.norm(w, axis=0).max() <= 0.8 + 1e-6


@pytest.mark.parametrize("name", sorted(NETS))
def test_pretrain_layer_refuses_a_layer_that_cannot_be_pretrained(name):
    jnet, tnet = pair(name)
    x = batches(name, 1)
    key = 2 if name == "mln" else "out"
    with pytest.raises(ValueError, match="not pretrainable"):
        jnet.pretrain_layer(key, JList(JDataSet(x, None), B))
    with pytest.raises(ValueError, match="not pretrainable"):
        tnet.pretrain_layer(key, TList(TDataSet(x, None), B))


def test_pretrain_draws_the_models_noise_and_moves_the_score():
    """Without fed draws the steps draw from the model's noise at their
    iterations (two fresh models pretrain alike), and the -ELBO falls."""
    nets = [pair("mln")[1] for _ in range(2)]
    x = batches("mln", 4)
    scores = []
    for net in nets:
        seen = []
        for _ in range(3):
            net.pretrain_layer(1, TList(TDataSet(x, None), B), epochs=1)
            seen.append(net.score())
        scores.append(seen)
    assert scores[0] == scores[1] and scores[0][-1] < scores[0][0]
    np.testing.assert_array_equal(nets[0].params_flat(), nets[1].params_flat())


@pytest.mark.parametrize("name", sorted(NETS))
def test_network_json_both_ways(name):
    build = NETS[name][0]
    jc, tc = build(JAX), build(PORT)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert json.loads(type(tc).from_json(jc.to_json()).to_json()) == json.loads(jc.to_json())
