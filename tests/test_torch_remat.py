"""Rematerialization (``remat_policy``, ``nn/remat.py``) on every fit path
of the port, on the CPU.

- Exactness: a rematerialized step recomputes the same operations on the
  same inputs (the dropout draws are counter-based), so under each policy
  ("save_conv_outputs", "dots", "nothing", and the ``DL4J_TPU_REMAT``
  override) the loss, the new layer state and the gradients are
  ``torch.equal`` to no remat: on a LeNet ``MultiLayerNetwork``, the narrow
  ``ComputationGraph`` of ``test_torch_train.py`` (stem conv, BN, two fused
  bottlenecks) and a 2-block attention stack, with and without dropout;
  and after eager, emulated bundled (``BundledStep.emulate``: the card's
  path without the graph) and guarded fits, through the one-rank wrapper
  (replicated and ZeRO-1) and ``SharedTrainingMaster``. The 2- and 4-rank
  gloo runs are in ``test_torch_parallel.py`` (``remat/*``).
- What the policies keep: fewer tensors saved outside the regions than
  without remat (a ``saved_tensors_hooks`` count); "dots" reruns no
  convolution or matrix product in the backward, "nothing" reruns them,
  "save_conv_outputs" reruns no ``ConvolutionLayer`` convolution.
- Against the JAX package under the same policy, from carried params: 3
  ``fit`` steps of the narrow graph at ``test_torch_train.py``'s F32_TOL
  (1e-4) and of ``test_torch_multilayer_train.py``'s conv-BN network at
  its FIT_TOL (1e-5): remat changes no arithmetic in either package. An
  unknown name raises the reference's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_attention_train as att
import test_torch_multilayer_train as mlt
import test_torch_train as tt
import torch_mln_pairs as pairs
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import multilayer as jml
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn import multilayer as tml
from deeplearning4j_tpu_torch.nn import remat
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import _as_multi
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster
from deeplearning4j_tpu_torch.train import pipeline
from deeplearning4j_tpu_torch.train.faults import FaultPolicy

POLICIES = ["save_conv_outputs", "dots", "nothing"]
MODELS = ["lenet", "graph", "blocks"]


# ------------------------------------------------------------------ models
def conf_of(model: str, dropout: bool, k: int = 1):
    """The port's configuration of ``model`` (see the module docstring),
    with dropout on a hidden layer's input where ``dropout`` (and
    attention dropout in the attention stack)."""
    if model == "lenet":
        c = pairs.lenet(pairs.PORT)
        if dropout:
            c.layers[4].dropout = 0.5
    elif model == "graph":
        c = tt._narrow(tt.tconf, tt.tlayers, tt.tupd, None)
        if dropout:
            c.vertices["b0"].layer.dropout = 0.5
    else:
        c = att.block_stack(att.PORT, block_dropout=0.2 if dropout else 0.0,
                            attention_dropout=0.2 if dropout else 0.0)
    c.global_conf.steps_per_call = k
    return c


def net_of(model: str, policy, dropout: bool = True, k: int = 1, fault_policy=None):
    c = conf_of(model, dropout, k)
    c.global_conf.remat_policy = policy
    c.global_conf.fault_policy = fault_policy
    return (TGraph if model == "graph" else TNet)(c).init(device="cpu")


def data_of(model: str, n: int, seed: int = 0):
    """``n`` seeded DataSets of ``model``'s input."""
    rng = np.random.default_rng(seed)
    shape, classes = {"lenet": ((4, 28, 28, 1), 10), "graph": ((6, 15, 17, 3), 10),
                      "blocks": ((att.B, att.T, att.D), att.CLASSES)}[model]
    return [TDataSet(rng.standard_normal(shape).astype(np.float32),
                     np.eye(classes, dtype=np.float32)[rng.integers(0, classes, shape[0])])
            for _ in range(n)]


def batch_of(net, ds):
    return net._batch(_as_multi(ds)) if isinstance(net, TGraph) else net._batch(ds)


def leaves(tree):
    return pipeline.tree_leaves(tree)


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def assert_nets_equal(a, b):
    assert_trees_equal(a.params_, b.params_)
    assert_trees_equal(a.opt_state_, b.opt_state_)
    if leaves(b.state_):
        assert_trees_equal(a.state_, b.state_)
    assert torch.equal(a.score_, b.score_) and a.iteration == b.iteration


# ------------------------------------------------------------- exactness
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("policy", POLICIES + ["env:nothing"])
@pytest.mark.parametrize("model", MODELS)
def test_gradients_equal_no_remat(model, policy, dropout, monkeypatch):
    """One train step's loss, new layer state and gradients under the policy
    are torch.equal to no remat's (the env override with no knob set)."""
    base = net_of(model, None, dropout)
    want = base._value_and_grad(*batch_of(base, data_of(model, 1)[0]))
    if policy.startswith("env:"):
        monkeypatch.setenv(remat.ENV, policy[4:])
        net = net_of(model, None, dropout)
    else:
        net = net_of(model, policy, dropout)
    assert tml.remat_policy_of(net) is remat.POLICIES[policy.split(":")[-1]]
    got = net._value_and_grad(*batch_of(net, data_of(model, 1)[0]))
    assert torch.equal(got[0], want[0])
    assert_trees_equal(got[2], want[2])
    if leaves(want[1]):
        assert_trees_equal(got[1], want[1])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", MODELS)
def test_eager_bundled_and_guarded_fits_equal_no_remat(model, policy):
    """With dropout on: two eager steps, an emulated bundle of two and two
    guarded steps (a FaultPolicy) under the policy give no remat's params,
    updater state, layer state and scores, bit for bit."""
    data = data_of(model, 2, seed=3)
    for k, fault in ((1, None), (2, None), (1, FaultPolicy())):
        a = net_of(model, None, k=k, fault_policy=fault)
        b = net_of(model, policy, k=k, fault_policy=fault)
        for n in (a, b):
            if k > 1:
                n._bundle_step(k).emulate = True
            n.fit(ExistingDataSetIterator(data))
        assert_nets_equal(b, a)
        if fault is not None:
            assert_trees_equal(b.fault_state_, a.fault_state_)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_wrapper_zero1_and_master_on_one_rank_equal_no_remat(policy):
    """The one-rank wrapper (replicated, ZeRO-1, ZeRO-1 bundled at 2) and
    SharedTrainingMaster on LeNet with dropout, under the policy, equal
    their runs without remat bit for bit (all of them reach the loss
    through ``_value_and_grad``)."""
    data = data_of("lenet", 2, seed=4)
    for sharded, k in ((False, 1), (True, 1), (True, 2)):
        a, b = net_of("lenet", None, k=k), net_of("lenet", policy, k=k)
        for n in (a, b):
            (ParallelWrapper.builder(n).workers(1).sharded_update(sharded).build()
             .fit(ExistingDataSetIterator(data)))
        assert_nets_equal(b, a)
    a, b = net_of("lenet", None), net_of("lenet", policy)
    for n in (a, b):
        SharedTrainingMaster.builder(1e-3).build().fit(n, ExistingDataSetIterator(data))
    assert_trees_equal(b.params_, a.params_)
    assert torch.equal(b.score_, a.score_)


# ------------------------------------------------------- what is kept
def _saved_outside_regions(net, ds) -> int:
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        net._value_and_grad(*batch_of(net, ds))
    return count[0]


@pytest.mark.parametrize("model", MODELS)
def test_nothing_saves_fewer_tensors(model):
    """Under "nothing" every layer's tensors are its region's (kept by the
    checkpoint, recomputed in the backward): fewer tensors go through the
    saved-tensor hooks outside the regions than without remat."""
    ds = data_of(model, 1)[0]
    none = _saved_outside_regions(net_of(model, None), ds)
    nothing = _saved_outside_regions(net_of(model, "nothing"), ds)
    assert nothing < none, (nothing, none)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _op_counts(policy) -> dict:
    """The convolutions and matrix products one train step of the narrow
    VGG (convolutions with ReLU, dense layers, dropout) runs, forward and
    backward."""
    c = pairs.narrow_vgg(pairs.PORT)
    c.global_conf.remat_policy = policy
    net = TNet(c).init(device="cpu")
    x = pairs.inputs("narrow_vgg", 4)
    y = np.eye(10, dtype=np.float32)[[1, 2, 3, 4]]
    with _OpCount() as cnt:
        net._value_and_grad(*net._batch(TDataSet(x, y)))
    return {k: cnt.n.get(k, 0) for k in ("aten.convolution", "aten.mm", "aten.addmm")}


def test_what_each_policy_keeps():
    """"dots" keeps every convolution and product (the backward reruns
    none), "save_conv_outputs" every ConvolutionLayer's raw convolution
    ("conv_out"), "nothing" nothing (the backward reruns some of each)."""
    none = _op_counts(None)
    dots, names, nothing = (_op_counts(p) for p in ("dots", "save_conv_outputs", "nothing"))
    assert dots == none
    assert names["aten.convolution"] == none["aten.convolution"]
    assert nothing["aten.convolution"] > none["aten.convolution"]
    assert nothing["aten.mm"] + nothing["aten.addmm"] > none["aten.mm"] + none["aten.addmm"]


def test_checkpoint_name_outside_a_region_changes_nothing():
    """Outside a region the name is only a scope: eval outputs and an
    unrematerialized step are what they were."""
    a, b = net_of("lenet", None), net_of("lenet", None)
    x = data_of("lenet", 1)[0].features
    with remat.checkpoint_name("conv_out"):
        ya = a.output(x)
    assert np.array_equal(ya, b.output(x))


# ---------------------------------------------------------- the policy
def test_unknown_policy_raises_the_references_error(monkeypatch):
    for name in ("full", "save_everything"):
        with pytest.raises(ValueError) as jerr:
            jml._resolve_remat_policy(name)
        with pytest.raises(ValueError) as terr:
            tml._resolve_remat_policy(name)
        assert str(terr.value) == str(jerr.value) == f"unknown remat_policy: {name!r}"
        net = net_of("lenet", name)
        ds = data_of("lenet", 1)[0]
        with pytest.raises(ValueError, match="unknown remat_policy"):
            net.fit(ds)
        assert net.iteration == 0
    monkeypatch.setenv(remat.ENV, "bogus")
    with pytest.raises(ValueError, match="'bogus'"):
        tml._resolve_remat_policy("dots")


def test_env_override_and_none(monkeypatch):
    """DL4J_TPU_REMAT wins over the knob, as the reference's; "none" and
    None are no remat."""
    assert tml._resolve_remat_policy(None) is None
    assert tml._resolve_remat_policy("none") is None
    assert tml._resolve_remat_policy("dots").name == "dots"
    monkeypatch.setenv(remat.ENV, "nothing")
    assert tml._resolve_remat_policy("dots").name == "nothing"
    assert tml._resolve_remat_policy(None).name == "nothing"
    monkeypatch.setenv(remat.ENV, "")
    assert tml._resolve_remat_policy("dots").name == "dots"


def test_a_change_of_policy_makes_a_new_bundle(monkeypatch):
    """The bundle's key holds the resolved policy: after a change of knob
    or environment the next bundled fit builds a new bundle, and its steps
    still equal no remat's."""
    net, ref = net_of("lenet", None, k=2), net_of("lenet", None, k=2)
    data = data_of("lenet", 2, seed=6)
    net.fit(ExistingDataSetIterator(data))
    ref.fit(ExistingDataSetIterator(data))
    first = net._bundled
    net.conf.global_conf.remat_policy = "dots"
    net.fit(ExistingDataSetIterator(data))
    second = net._bundled
    assert second is not first
    monkeypatch.setenv(remat.ENV, "nothing")
    net.fit(ExistingDataSetIterator(data))
    assert net._bundled is not second
    monkeypatch.delenv(remat.ENV)
    ref.fit(ExistingDataSetIterator(data))
    ref.fit(ExistingDataSetIterator(data))
    assert_nets_equal(net, ref)


# ------------------------------------------------------------- vs JAX
def _carried_graph_pair(policy, narrow_arrays):
    params, state, batches = narrow_arrays
    jc = tt._narrow(tt.jconf, tt.jlayers, tt.jupd, None)
    tc = tt._narrow(tt.tconf, tt.tlayers, tt.tupd, None)
    jc.global_conf.remat_policy = tc.global_conf.remat_policy = policy
    jg = JGraph(jc).init()
    jg.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    jg.state_ = jax.tree_util.tree_map(jnp.asarray, state)
    tg = TGraph(tc).init(device="cpu")
    interop.load_jax_params(tg, params, state, opt_state=tt._tree(jg.opt_state_),
                            iteration=jg.iteration)
    return jg, tg, batches


@pytest.fixture(scope="module")
def narrow_arrays():
    jg = JGraph(tt._narrow(tt.jconf, tt.jlayers, tt.jupd, None)).init()
    params, state = tt._tree(jg.params_), tt._tree(jg.state_)
    tt.randomize_bn(params, state, 9)
    rng = np.random.default_rng(12)
    batches = [(rng.standard_normal((6, 15, 17, 3)).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]) for _ in range(3)]
    return params, state, batches


@pytest.mark.parametrize("policy", POLICIES)
def test_narrow_graph_fit_under_remat_matches_jax(policy, narrow_arrays):
    """Three fit steps of the narrow graph under the same policy in both
    packages (JAX: ``jax.checkpoint`` around the loss): score, params, BN
    state and Nesterovs' v within F32_TOL after each step."""
    jg, tg, batches = _carried_graph_pair(policy, narrow_arrays)
    for step, (x, y) in enumerate(batches):
        jg.fit(JDataSet(x, y), batch_size=6)
        tg.fit(TDataSet(x, y), batch_size=6)
        assert abs(tg.score() - float(jg.score_)) <= tt.F32_TOL * abs(float(jg.score_)), step
        assert tt._max_rel(interop.export_params(tg), tt._tree(jg.params_)) <= tt.F32_TOL
        assert tt._max_rel(interop.export_state(tg), tt._tree(jg.state_)) <= tt.F32_TOL
        assert tt._max_rel(interop.export_opt_state(tg), tt._tree(jg.opt_state_)) <= tt.F32_TOL


@pytest.mark.parametrize("policy", ["save_conv_outputs", "nothing"])
def test_conv_bn_fit_under_remat_matches_jax(policy):
    """``test_torch_multilayer_train.py``'s conv-BN network (two named
    convolutions with ReLU, BN, l2, Nesterovs) under the same policy in both
    packages: three fit steps of three batches, params, slots, BN state and
    scores within its FIT_TOL (1e-5)."""
    jnet, tnet = mlt.pair("conv_bn")
    jnet.conf.global_conf.remat_policy = tnet.conf.global_conf.remat_policy = policy
    x, y = mlt.data("conv_bn", 24, seed=1)
    for _ in range(3):
        jnet.fit(JDataSet(x, y), batch_size=8, epochs=1)
        tnet.fit(TDataSet(x, y), batch_size=8, epochs=1)
        assert abs(float(jnet.score()) - tnet.score()) <= mlt.FIT_TOL
    mlt.assert_tracks(jnet, tnet)
