"""The attention layers in train mode inside a ``MultiLayerNetwork``, against
the JAX package on the CPU.

- A network of ``PositionalEmbeddingLayer`` -> 2 x ``TransformerBlock`` ->
  ``SelfAttentionLayer`` -> ``GlobalPoolingLayer`` -> ``OutputLayer`` takes
  3 ``fit`` steps under Adam from params carried from JAX
  (``interop.load_jax_params``), dropout off: params, Adam slots and scores
  within 1e-5 (f32: the same operations, sums in another order).
- With input dropout on the blocks and attention dropout on the attention
  layer, the train-mode loss and gradients on JAX's own draws (fed in,
  ``dropouts.FedNoise``) within 1e-5: JAX's attention layer draws its mask of
  ``p`` from the layer's key, as its input dropout does.
- A nonzero attention-dropout rate takes the einsum path on the card too
  (the route's rule), a zero rate at T % 128 == 0 the flash kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import dropouts as tdrop
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet

TOL = 1e-5
D, HEADS, T, B, CLASSES = 16, 4, 8, 4, 3

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def block_stack(pkg, block_dropout=0.0, attention_dropout=0.0, causal=True):
    conf, L, upd = pkg
    b = (conf.NeuralNetConfiguration.builder().seed(11).updater(upd.Adam(1e-3)).list()
         .layer(L.PositionalEmbeddingLayer(max_length=T)))
    for _ in range(2):
        b = b.layer(L.TransformerBlock(n_heads=HEADS, causal=causal, dropout=block_dropout))
    return (b.layer(L.SelfAttentionLayer(n_heads=HEADS, attention_dropout=attention_dropout))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.recurrent(D, T)).build())


def pair(**kw):
    jnet = JNet(block_stack(JAX, **kw)).init()
    tnet = TNet(block_stack(PORT, **kw)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return jnet, tnet


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, T, D)).astype(np.float32),
             np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, B)]) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_block_stack_fit_three_steps_matches_jax(causal):
    jnet, tnet = pair(causal=causal)
    for x, y in batches(3):
        jnet.fit(JDataSet(x, y), batch_size=B)
        tnet.fit(ExistingDataSetIterator([TDataSet(x, y)]))
        np.testing.assert_allclose(float(tnet.score_), float(jnet.score()), rtol=0, atol=TOL)
    for i, (jp, tp) in enumerate(zip(jnet.params_, tnet.params_)):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=TOL,
                                       err_msg=f"layer {i} {k}")
            for s in tnet.opt_state_[i][k]:
                np.testing.assert_allclose(tnet.opt_state_[i][k][s].numpy(),
                                           np.asarray(jnet.opt_state_[i][k][s]), rtol=0,
                                           atol=TOL, err_msg=f"layer {i} {k} {s}")
    assert tnet.iteration == jnet.iteration == 3


def _jax_draws(jnet, key, x_shape):
    """JAX's draws from ``key`` in the port's order: per layer its input
    dropout (the layer's key), then the attention layer's mask of ``p``
    (the same key)."""
    rngs = jax.random.split(key, len(jnet.layers))
    draws = []
    for i, layer in enumerate(jnet.layers):
        if layer.dropout:
            draws.append(np.asarray(jax.random.bernoulli(rngs[i], 1.0 - layer.dropout,
                                                         x_shape)))
        if getattr(layer, "attention_dropout", 0.0):
            draws.append(np.asarray(jax.random.bernoulli(
                rngs[i], 1.0 - layer.attention_dropout, (B, HEADS, T, T))))
    return draws


def test_dropout_loss_and_gradients_with_jax_draws():
    jnet, tnet = pair(block_dropout=0.1, attention_dropout=0.25)
    x, y = batches(1, seed=5)[0]
    key = jax.random.PRNGKey(17)

    def jloss(p):
        loss, _ = jnet._loss_and_new_state(p, jnet.state_, jnp.asarray(x), jnp.asarray(y),
                                           None, None, key, train=True)
        return loss

    jl, jg = jax.value_and_grad(jloss)(jnet.params_)
    draws = _jax_draws(jnet, key, (B, T, D))
    assert len(draws) == 3
    feed = tdrop.FedNoise(draws)
    tl, _, tg = tnet._value_and_grad(torch.from_numpy(x), torch.from_numpy(y), None, None,
                                     noise=feed)
    assert feed.taken == 3
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=TOL)
    for i, g in enumerate(tg):
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[i][k]), rtol=0, atol=TOL,
                                       err_msg=f"layer {i} {k}")
    # the draws matter: another feed moves the loss
    other = tdrop.FedNoise([~d for d in draws])
    tl2, _, _ = tnet._value_and_grad(torch.from_numpy(x), torch.from_numpy(y), None, None,
                                     noise=other)
    assert abs(float(tl2) - float(tl)) > 1e-4


def test_dropout_fit_draws_fresh_masks_and_eval_is_clean():
    """Each step draws anew (two steps on one batch at lr 0 give two scores);
    eval-mode output equals the network's without dropout."""
    conf = block_stack(PORT, block_dropout=0.2, attention_dropout=0.3)
    conf.global_conf.updater = tupd.Sgd(0.0)
    for layer in conf.layers:
        layer.updater = tupd.Sgd(0.0)
    net = TNet(conf).init(device="cpu")
    x, y = batches(1, seed=6)[0]
    scores = []
    for _ in range(2):
        net.fit(ExistingDataSetIterator([TDataSet(x, y)]))
        scores.append(float(net.score_))
    assert scores[0] != scores[1]
    clean = TNet(block_stack(PORT)).init(device="cpu")
    clean.params_, clean.state_ = net.params_, net.state_
    np.testing.assert_array_equal(net.output(x), clean.output(x))


def test_training_routes():
    """In training on the card (device type forced: no card here), a
    nonzero attention-dropout rate takes the einsum path and a zero rate at
    T 128 the flash kernel, whose backward the autograd function holds."""
    q = torch.zeros(2, HEADS, 128, 8, device="meta")
    assert tatt._flash_attention_route(q, q, True, None, 0.0, device_type="cuda")
    assert not tatt._flash_attention_route(q, q, True, None, 0.1, device_type="cuda")
    assert not tatt._flash_attention_route(q[:, :, :64], q[:, :, :64], True, None, 0.0,
                                           device_type="cuda")
