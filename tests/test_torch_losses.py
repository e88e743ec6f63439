"""The port's losses against the JAX package's, on the CPU.

Each of the 22 loss names: the per-example score and its gradient with
respect to the pre-activation output (autograd against ``jax.grad`` of the
summed score), without and with a mask, at the loss's default activation
and, where the loss applies one, at a non-default activation; within 1e-6
relative (f32) to the norm of the reference's value and of its gradient.
Inputs are made with numpy from a seed; labels are drawn in each loss's
domain (one-hot, probabilities, ±1, counts, class indices in the two
shapes ``sparse_mcxent`` takes). A case also puts pre-activations exactly
on the clip bounds and ties, where the gradient is the reference's rule
(half at a ``jnp.maximum``/``jnp.clip`` tie). Integer labels through
``fit`` (eager and bundled, f32 and bf16) give the one-hot fit's bits and
track JAX's sparse fit within 1e-5.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import losses as jlosses
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import losses as tlosses
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet

B, C = 6, 5
TOL = 1e-6

#: loss -> the label domain its labels are drawn from
DOMAIN = {
    "mse": "real", "squared_loss": "real", "l2": "real", "mae": "real",
    "mean_absolute_error": "real", "l1": "real", "mape": "real",
    "mean_absolute_percentage_error": "real", "msle": "positive",
    "mean_squared_logarithmic_error": "positive", "xent": "binary",
    "mcxent": "onehot", "negativeloglikelihood": "onehot", "sparse_mcxent": "index",
    "kl_divergence": "probs", "kld": "probs", "cosine_proximity": "real",
    "hinge": "sign", "squared_hinge": "sign", "poisson": "positive",
    "reconstruction_crossentropy": "binary", "wasserstein": "real",
}

#: a non-default activation for each loss that applies one
OTHER_ACTIVATION = {
    "mse": "tanh", "squared_loss": "sigmoid", "l2": "relu", "mae": "tanh",
    "mean_absolute_error": "softsign", "l1": "elu", "mape": "softplus",
    "mean_absolute_percentage_error": "swish", "msle": "softplus",
    "mean_squared_logarithmic_error": "sigmoid", "xent": "hardsigmoid",
    "mcxent": "sigmoid", "negativeloglikelihood": "hardsigmoid", "sparse_mcxent": "sigmoid",
    "kl_divergence": "sigmoid", "kld": "hardsigmoid", "cosine_proximity": "tanh",
    "hinge": "tanh", "squared_hinge": "hardtanh", "poisson": "softplus",
    "reconstruction_crossentropy": "hardsigmoid", "wasserstein": "tanh",
}


def labels_for(domain, rng, shape=(B, C)):
    if domain == "real":
        return rng.standard_normal(shape).astype(np.float32)
    if domain == "positive":
        return rng.random(shape).astype(np.float32) * 3
    if domain == "binary":
        return (rng.random(shape) > 0.5).astype(np.float32)
    if domain == "onehot":
        return np.eye(C, dtype=np.float32)[rng.integers(0, C, shape[:-1])]
    if domain == "probs":
        p = rng.random(shape).astype(np.float32) + 0.05
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if domain == "sign":
        return np.where(rng.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)
    if domain == "index":
        return rng.integers(0, C, shape[:-1]).astype(np.int32)
    raise ValueError(domain)


def both(name, labels, preout, activation, mask):
    """(port (value, grad), JAX (value, grad)) of the summed score."""
    kwargs = {} if activation == "default" else {"activation": activation}
    tx = torch.tensor(preout, requires_grad=True)
    tl = torch.from_numpy(labels)
    tm = None if mask is None else torch.from_numpy(mask)
    tv = tlosses.get(name)(tl, tx, mask=tm, **kwargs)
    tv.sum().backward()
    jf = jlosses.get(name)
    jm = None if mask is None else jnp.asarray(mask)

    def total(x):
        v = jf(jnp.asarray(labels), x, mask=jm, **kwargs)
        return v.sum(), v

    (_, jv), jg = jax.value_and_grad(total, has_aux=True)(jnp.asarray(preout))
    return (tv.detach().numpy(), tx.grad.numpy()), (np.asarray(jv), np.asarray(jg))


def assert_close(mine, ref, what):
    err = np.linalg.norm(np.asarray(mine, np.float64) - ref)
    scale = np.linalg.norm(np.asarray(ref, np.float64))
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


CASES = [(n, act, masked) for n in sorted(DOMAIN)
         for act in ("default", OTHER_ACTIVATION[n]) for masked in (False, True)]


@pytest.mark.parametrize("name,activation,masked", CASES,
                         ids=[f"{n}-{a}-{'mask' if m else 'nomask'}" for n, a, m in CASES])
def test_loss_value_and_gradient_match_jax(name, activation, masked):
    rng = np.random.default_rng(zlib.crc32(f"{name}/{activation}/{masked}".encode()))
    preout = rng.standard_normal((B, C)).astype(np.float32) * 2
    labels = labels_for(DOMAIN[name], rng)
    mask = None
    if masked:
        mask = (rng.random((B, 1)) > 0.3).astype(np.float32)
        mask[0] = 1.0
        if name != "sparse_mcxent":
            mask = np.broadcast_to(mask, (B, C)) * (rng.random((B, C)) > 0.2)
            mask = mask.astype(np.float32)
    (tv, tg), (jv, jg) = both(name, labels, preout, activation, mask)
    assert tv.shape == jv.shape == (B,)
    assert_close(tv, jv, "value")
    assert_close(tg, jg, "grad")
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("shape", [(B,), (B, 1)], ids=["flat", "column"])
def test_sparse_mcxent_takes_both_label_shapes(shape):
    rng = np.random.default_rng(3)
    preout = rng.standard_normal((B, C)).astype(np.float32)
    labels = rng.integers(0, C, shape).astype(np.int64)
    mask = (rng.random((B, 1)) > 0.4).astype(np.float32)
    for m in (None, mask):
        (tv, tg), (jv, jg) = both("sparse_mcxent", labels, preout, "default", m)
        assert_close(tv, jv, "value")
        assert_close(tg, jg, "grad")
    onehot = np.eye(C, dtype=np.float32)[labels.reshape(-1)]
    dense = tlosses.mcxent(torch.from_numpy(onehot), torch.from_numpy(preout))
    sparse = tlosses.sparse_mcxent(torch.from_numpy(labels), torch.from_numpy(preout))
    torch.testing.assert_close(sparse, dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["xent", "reconstruction_crossentropy", "kl_divergence",
                                  "hinge", "squared_hinge", "poisson", "msle", "mape"])
def test_gradients_at_the_bounds_and_ties_are_the_references(name):
    """Pre-activations placed on the clip bounds and ties: 0 for the
    logits' max(x, 0) and poisson's max(out, EPS) through relu, the hinge's
    margin, and the labels at 0 for ``mape``'s where."""
    labels = labels_for(DOMAIN[name], np.random.default_rng(1))
    preout = np.random.default_rng(2).standard_normal((B, C)).astype(np.float32)
    act = "default"
    if name in ("hinge", "squared_hinge"):
        preout = labels.copy()  # labels * out == 1: the margin's tie
    elif name in ("xent",):
        preout[:, :2] = 0.0
    elif name in ("reconstruction_crossentropy", "kl_divergence"):
        act = "hardsigmoid"
        preout[:, 0], preout[:, 1] = 2.5, -2.5  # hardsigmoid's clip at 1 and 0
    elif name in ("poisson", "msle"):
        act = "relu"
        preout[:, :2] = 0.0
    elif name == "mape":
        labels[:, :2] = 0.0
    (tv, tg), (jv, jg) = both(name, labels, preout, act, None)
    assert_close(tv, jv, "value")
    assert_close(tg, jg, "grad")


def test_every_reference_loss_name_is_ported():
    assert tlosses.names() == jlosses.names() == sorted(DOMAIN)
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get("huber")


# ------------------------------------------------------- sparse labels in fit
def _sparse_net(pkg, loss, compute_dtype=None, k=1):
    conf, layers, upd = pkg
    b = conf.NeuralNetConfiguration.builder().seed(11).updater(upd.Adam(1e-2)).steps_per_call(k)
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    return (b.list().layer(layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_out=C, activation="softmax", loss=loss))
            .set_input_type(conf.InputType.feed_forward(4)).build())


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_sparse_labels_reach_the_loss_as_integers(compute_dtype, k):
    """Integer class labels, (B, 1), through ``fit`` (eager, and stacked in
    an emulated k-2 bundle) under f32 and bf16 compute: the fit equals the
    one-hot ``mcxent`` fit bit for bit (the loss and its gradient are the
    same numbers when the labels arrive as integers), and tracks JAX's
    sparse fit in f32 within 1e-5."""
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((8, 4)).astype(np.float32) for _ in range(4)]
    ys = [rng.integers(0, C, (8, 1)).astype(np.int64) for _ in range(4)]
    port = (tconf, tlayers, tupd)
    jnet = JNet(_sparse_net((jconf, jlayers, jupd), "sparse_mcxent")).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params_)
    nets = {}
    for loss, lab in (("sparse_mcxent", lambda y: y),
                      ("mcxent", lambda y: np.eye(C, dtype=np.float32)[y[:, 0]])):
        net = TNet(_sparse_net(port, loss, compute_dtype, k)).init(device="cpu")
        interop.load_jax_params(net, params, [{} for _ in params])
        if k > 1:
            net._bundle_step(k).emulate = True
        net.fit(TExisting([TDataSet(x, lab(y)) for x, y in zip(xs, ys)]))
        nets[loss] = net
    np.testing.assert_array_equal(nets["sparse_mcxent"].params_flat(), nets["mcxent"].params_flat())
    assert torch.equal(nets["sparse_mcxent"].score_, nets["mcxent"].score_)
    if compute_dtype is None and k == 1:
        for x, y in zip(xs, ys):
            jnet.fit(JDataSet(x, y))
        np.testing.assert_allclose(nets["sparse_mcxent"].params_flat(), jnet.params_flat(),
                                   rtol=0, atol=1e-5)
