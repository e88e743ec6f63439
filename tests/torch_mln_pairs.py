"""Helpers shared by the port's MultiLayerNetwork tests: the same list
configuration built by the same builder calls in both packages, and a JAX
network with its weights carried into the port (weights move by array,
never by seed)."""

import jax
import numpy as np

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.updaters as jupd
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.updaters as tupd
from deeplearning4j_tpu.models.lenet import LeNet as JLeNet
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models.lenet import LeNet as TLeNet
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def narrow_vgg(pkg, compute_dtype=None):
    """A VGG-shaped list network at test size: two conv blocks, Dense 32
    with dropout 0.5, Dense 32, Output 10, on 16x16x3."""
    conf, layers, upd = pkg
    b = (conf.NeuralNetConfiguration.builder().seed(5)
         .updater(upd.Nesterovs(1e-2, 0.9)).weight_init("relu"))
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    b = b.list()
    for n_out, reps in ((8, 2), (16, 1)):
        for _ in range(reps):
            b = b.layer(layers.ConvolutionLayer(n_out=n_out, kernel_size=3,
                                                convolution_mode="same",
                                                activation="relu"))
        b = b.layer(layers.SubsamplingLayer(kernel_size=2, stride=2))
    return (b.layer(layers.DenseLayer(n_out=32, activation="relu", dropout=0.5))
            .layer(layers.DenseLayer(n_out=32, activation="relu"))
            .layer(layers.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(conf.InputType.convolutional(16, 16, 3))
            .build())


def lenet(pkg, compute_dtype=None):
    """The zoo's LeNet (28x28x1, 10 classes) configuration."""
    c = (JLeNet if pkg is JAX else TLeNet)(num_classes=10).conf()
    c.global_conf.compute_dtype = compute_dtype
    return c


def small_graph(pkg):
    """A graph with a dense layer on conv output: the builder inserts a
    CnnToFeedForwardPreProcessor in front of it."""
    conf, layers, _ = pkg
    gb = (conf.NeuralNetConfiguration.builder().seed(2).graph_builder()
          .add_inputs("in").set_input_types(conf.InputType.convolutional(6, 6, 2)))
    gb.add_layer("conv", layers.ConvolutionLayer(n_out=3, kernel_size=3,
                                                 activation="relu"), "in")
    gb.add_layer("dense", layers.DenseLayer(n_out=5, activation="relu"), "conv")
    gb.add_layer("out", layers.OutputLayer(n_out=4, activation="softmax"), "dense")
    return gb.set_outputs("out").build()


CONFS = {"lenet": lenet, "narrow_vgg": narrow_vgg}
SHAPES = {"lenet": (28, 28, 1), "narrow_vgg": (16, 16, 3)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(name, compute_dtype=None, head_scale=4.0):
    """(JAX network, port network on the CPU) holding the same weights. The
    output layer's ``W`` is scaled by ``head_scale`` so the softmax is
    spread, neither uniform nor saturated."""
    jnet = JNet(CONFS[name](JAX, compute_dtype)).init()
    params = numpy_tree(jnet.params_)
    params[-1]["W"] = params[-1]["W"] * np.float32(head_scale)
    jnet.params_ = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tnet = TNet(CONFS[name](PORT, compute_dtype)).init(device="cpu")
    load_jax_params(tnet, params, numpy_tree(jnet.state_))
    return jnet, tnet


def inputs(name, n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n,) + SHAPES[name]).astype(np.float32)
