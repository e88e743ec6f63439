"""The port's training fault policy (``train/faults.py``) against the JAX
package, on the CPU.

The oracle of skip-exactness is JAX's UNGUARDED ``fit`` on the batches with
the poisoned one removed (weights carried in by array, never by seed): a
guarded port fit that skips batch k holds to it at FIT_TOL (1e-5, f32: the
two packages sum in other orders, ``tests/test_torch_multilayer_train.py``),
and equals the port's own removed-batch fit exactly (the skip is a select
on the old tensors and the updater's clock is ``good_count``). The
loss-scale trace, floor and activation are the reference's
``tests/test_fault_tolerance.py::TestDynamicLossScaling`` cases; the
policy's JSON is held key for key against JAX's ``FaultPolicy.to_dict``;
checkpoints carry ``fault_state`` between the packages both ways.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train import faults as jfaults
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.train import faults
from deeplearning4j_tpu_torch.train.faults import (
    FaultPolicy,
    TrainingDivergedError,
    fault_injection,
)
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

FIT_TOL = 1e-5
N_IN, N_HID, N_OUT = 5, 7, 3

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def conf(pkg, policy=None, mixed_precision=False, steps=1, bn=False):
    """``tests/test_fault_tolerance.py``'s network (with a BatchNormalization
    after the dense layer where ``bn``) in ``pkg``."""
    c, layers, upd = pkg
    b = c.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
    if mixed_precision:
        b = b.compute_dtype("bfloat16")
    if policy is not None:
        b = b.fault_policy(policy)
    if steps > 1:
        b = b.steps_per_call(steps)
    b = b.list().layer(layers.DenseLayer(n_out=N_HID, activation="tanh"))
    if bn:
        b = b.layer(layers.BatchNormalization())
    return (b.layer(layers.OutputLayer(n_out=N_OUT, activation="softmax"))
            .set_input_type(c.InputType.feed_forward(N_IN)).build())


def graph_conf(pkg, policy=None, steps=1):
    """The same network as a ComputationGraph."""
    c, layers, upd = pkg
    b = c.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
    if policy is not None:
        b = b.fault_policy(policy)
    if steps > 1:
        b = b.steps_per_call(steps)
    gb = (b.graph_builder().add_inputs("in")
          .set_input_types(c.InputType.feed_forward(N_IN)))
    gb.add_layer("dense", layers.DenseLayer(n_out=N_HID, activation="tanh"), "in")
    gb.add_layer("out", layers.OutputLayer(n_out=N_OUT, activation="softmax"), "dense")
    return gb.set_outputs("out").build()


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_net(jnet, policy=None, graph=False, **opts):
    """The port's network of the same configuration, holding ``jnet``'s
    params and layer state, on the CPU."""
    net = (TGraph(graph_conf(PORT, policy, **opts)) if graph
           else TNet(conf(PORT, policy, **opts))).init(device="cpu")
    interop.load_jax_params(net, numpy_tree(jnet.params_), numpy_tree(jnet.state_))
    return net


def batches(n=4, per=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((per, N_IN)).astype(np.float32)
        y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, per)]
        out.append((x, y))
    return out


def t_it(bs):
    return TExisting([TDataSet(x, y) for x, y in bs])


def j_it(bs):
    return JExisting([JDataSet(x, y) for x, y in bs])


def flat(tree) -> np.ndarray:
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    chunks = [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                         np.float32).reshape(-1) for d in tree for t in _leaves(d)]
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def _leaves(d):
    for k in sorted(d):
        v = d[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ policy
def test_policy_json_both_ways_key_for_key():
    pol = dict(max_consecutive_bad_steps=7, keep_last=2, init_loss_scale=2.0 ** 10,
               loss_scaling=True, scale_growth_interval=3)
    mine, theirs = FaultPolicy(**pol), jfaults.FaultPolicy(**pol)
    assert mine.to_dict() == theirs.to_dict()
    assert json.dumps(mine.to_dict(), sort_keys=True) == json.dumps(theirs.to_dict(),
                                                                    sort_keys=True)
    assert FaultPolicy.from_dict(theirs.to_dict()) == mine
    assert jfaults.FaultPolicy.from_dict(mine.to_dict()) == theirs
    assert FaultPolicy() == FaultPolicy() and FaultPolicy() != mine
    for cd in (None, "bfloat16"):
        assert FaultPolicy().scaling_active(cd) == jfaults.FaultPolicy().scaling_active(cd)
    assert faults.active_policy(FaultPolicy(skip_nonfinite=False), None) is None
    assert faults.active_policy(FaultPolicy(skip_nonfinite=False), "bfloat16") is not None


@pytest.mark.parametrize("kind", ["list", "graph"])
def test_config_json_carries_the_policy_between_the_packages(kind):
    """A configuration with a policy, written by either package, loads in
    the other into a live FaultPolicy and writes back the same dict."""
    pol = dict(max_consecutive_bad_steps=4, init_loss_scale=2.0 ** 12)
    build = graph_conf if kind == "graph" else conf
    jc = build(JAX, jfaults.FaultPolicy(**pol))
    tc = build(PORT, FaultPolicy(**pol))
    mine = type(tc).from_json(jc.to_json())
    assert isinstance(mine.global_conf.fault_policy, FaultPolicy)
    assert mine.global_conf.fault_policy == FaultPolicy(**pol)
    assert json.loads(mine.to_json()) == json.loads(jc.to_json())
    theirs = type(jc).from_json(tc.to_json())
    assert theirs.global_conf.fault_policy == jfaults.FaultPolicy(**pol)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())


# ------------------------------------------------------------ skip-exactness
@pytest.mark.parametrize("graph,bn", [(False, False), (False, True), (True, False)])
def test_skipped_batch_equals_jax_fit_without_it(graph, bn):
    """NaN at step 1 of 4: params, updater state and layer state equal the
    port's fit of the other three batches exactly, and JAX's unguarded fit
    of them within FIT_TOL; the host iteration counts all four."""
    bs = batches()
    kept = [bs[0], bs[2], bs[3]]
    jnet = (JGraph(graph_conf(JAX)) if graph else JNet(conf(JAX, bn=bn))).init()
    opts = {} if graph else {"bn": bn}
    with fault_injection([1]):
        a = port_net(jnet, FaultPolicy(), graph=graph, **opts)
        a.fit(t_it(bs))
    b = port_net(jnet, graph=graph, **opts)
    b.fit(t_it(kept))
    jnet.fit(j_it(kept))
    assert np.array_equal(a.params_flat(), b.params_flat())
    assert np.array_equal(a.opt_state_flat(), b.opt_state_flat())
    assert np.array_equal(flat(a.state_), flat(b.state_))
    np.testing.assert_allclose(a.params_flat(), jnet.params_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(a.opt_state_flat(), jnet.opt_state_flat(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(flat(a.state_), flat(numpy_tree(jnet.state_)), rtol=0,
                               atol=FIT_TOL)
    assert a.bad_step_count == 1
    assert int(a.fault_state_["good_count"]) == 3 and int(a.fault_state_["consec"]) == 0
    assert a.iteration == 4


@pytest.mark.parametrize("graph", [False, True])
def test_guard_without_faults_changes_nothing(graph):
    """The reference's ``test_guard_enabled_without_faults_is_a_noop``: on
    the CPU a guarded fit without faults is the unguarded fit bit for bit
    (alpha computed from the device clock by the host's operations)."""
    bs = batches()
    jnet = (JGraph(graph_conf(JAX)) if graph else JNet(conf(JAX))).init()
    a = port_net(jnet, FaultPolicy(), graph=graph)
    a.fit(t_it(bs), epochs=2)
    b = port_net(jnet, graph=graph)
    b.fit(t_it(bs), epochs=2)
    assert np.array_equal(a.params_flat(), b.params_flat())
    assert np.array_equal(a.opt_state_flat(), b.opt_state_flat())
    assert a.bad_step_count == 0 and a.loss_scale is None


def test_bf16_skipped_step_keeps_params():
    """An overflow-skipped step leaves a bf16-compute model's params bit for
    bit (the reference's ``test_skipped_step_params_unchanged_bf16``)."""
    x, y = batches(1)[0]
    with fault_injection([1]):
        n = TNet(conf(PORT, FaultPolicy(init_loss_scale=2.0 ** 8),
                      mixed_precision=True)).init(device="cpu")
        n.fit(TDataSet(x, y), epochs=1, batch_size=8)
        before = n.params_flat().copy()
        n.fit(TDataSet(x, y), epochs=1, batch_size=8)
    assert np.array_equal(before, n.params_flat())
    assert n.loss_scale == 128.0


def test_set_fault_policy_installs_and_clears():
    n = TNet(conf(PORT)).init(device="cpu")
    n.set_fault_policy(FaultPolicy(loss_scaling=True, init_loss_scale=64.0))
    n.fit(TDataSet(*batches(1)[0]), epochs=1, batch_size=8)
    assert n.loss_scale == 64.0 and n.bad_step_count == 0
    n.set_fault_policy(None)
    assert n.fault_state_ is None and n.loss_scale is None
    n.fit(TDataSet(*batches(1)[0]), epochs=1, batch_size=8)
    assert n.fault_state_ is None


# ------------------------------------------------------------- loss scaling
def test_loss_scale_trace_is_the_reference_one():
    """bf16 compute: the scale doubles after 2 good steps, halves on the
    injected overflow, then recovers."""
    pol = FaultPolicy(init_loss_scale=2.0 ** 8, scale_growth_interval=2)
    x, y = batches(1)[0]
    with fault_injection([2]):
        n = TNet(conf(PORT, pol, mixed_precision=True)).init(device="cpu")
        scales = []
        for _ in range(6):
            n.fit(TDataSet(x, y), epochs=1, batch_size=8)
            scales.append(n.loss_scale)
    assert scales == [256.0, 512.0, 256.0, 256.0, 512.0, 512.0]
    assert n.bad_step_count == 1


def test_loss_scale_floor():
    pol = FaultPolicy(init_loss_scale=2.0, min_loss_scale=1.0, scale_growth_interval=100)
    x, y = batches(1)[0]
    with fault_injection([0, 1, 2]):
        n = TNet(conf(PORT, pol, mixed_precision=True)).init(device="cpu")
        for _ in range(3):
            n.fit(TDataSet(x, y), epochs=1, batch_size=8)
    assert n.loss_scale == 1.0


def test_scaling_off_for_f32():
    n = TNet(conf(PORT, FaultPolicy())).init(device="cpu")
    n.fit(TDataSet(*batches(1)[0]), epochs=1, batch_size=8)
    assert n.loss_scale is None and "loss_scale" not in n.fault_state_


def test_scaled_bf16_step_tracks_the_unscaled_one():
    """Loss scaling by a power of two moves a bf16 model's first step by no
    more than bf16 rounding at the scaled magnitudes does: the scaled and
    unscaled runs agree within 1e-3 of Adam's lr 0.01 steps."""
    x, y = batches(1)[0]
    a = TNet(conf(PORT, FaultPolicy(init_loss_scale=2.0 ** 15), mixed_precision=True))
    b = TNet(conf(PORT, mixed_precision=True))
    for n in (a, b):
        n.init(device="cpu").fit(TDataSet(x, y), epochs=3, batch_size=8)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(), rtol=0, atol=1e-3)


# ---------------------------------------------------------------- tripwire
def test_tripwire_raises_at_its_limit():
    with fault_injection([0, 1, 2, 3]):
        n = TNet(conf(PORT, FaultPolicy(max_consecutive_bad_steps=2))).init(device="cpu")
        with pytest.raises(TrainingDivergedError, match="consecutive"):
            n.fit(t_it(batches()))
    assert n.bad_step_count == 2


def test_tripwire_lets_non_consecutive_bad_steps_pass():
    with fault_injection([0, 2]):
        n = TNet(conf(PORT, FaultPolicy(max_consecutive_bad_steps=2))).init(device="cpu")
        n.fit(t_it(batches()))
    assert n.bad_step_count == 2


def test_tripwire_reports_the_bad_count_delta_per_owner():
    """Under bundling the tripwire sees the end-of-bundle ``consec`` only;
    a mid-bundle skip that recovered shows in the per-owner delta."""
    pol = FaultPolicy(max_consecutive_bad_steps=3)
    with fault_injection([1]):
        n = TNet(conf(PORT, pol, steps=4)).init(device="cpu")
        n.fit(t_it(batches()))
    assert int(n.fault_state_["consec"]) == 0 and n.bad_step_count == 1
    other = TNet(conf(PORT, pol)).init(device="cpu")
    assert faults.check_fault_state(pol, n.fault_state_, owner=other) == 1
    assert faults.check_fault_state(pol, n.fault_state_, owner=other) == 0
    assert faults.check_fault_state(FaultPolicy(), n.fault_state_, owner=other) == 0


# ----------------------------------------------------------------- bundles
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("graph", [False, True])
def test_guarded_bundles_equal_single_steps(graph, k):
    """``steps_per_call`` k with NaN inside a bundle: bit-equal to k = 1
    (params, updater state, fault state); and the card's path (static
    buffers, the scalar and iteration feeds, the write-back; ``emulate``)
    gives the same bits."""
    bs = batches(8)
    jnet = (JGraph(graph_conf(JAX)) if graph else JNet(conf(JAX))).init()
    runs = {}
    for key, steps, emulate in (("k1", 1, False), ("k", k, False), ("emu", k, True)):
        with fault_injection([1, 5]):
            n = port_net(jnet, FaultPolicy(loss_scaling=True, init_loss_scale=2.0 ** 8,
                                           scale_growth_interval=2), graph=graph, steps=steps)
            if emulate:
                n._bundle_step(k).emulate = True
            n.fit(t_it(bs))
        runs[key] = n
    for key in ("k", "emu"):
        assert np.array_equal(runs[key].params_flat(), runs["k1"].params_flat()), key
        assert np.array_equal(runs[key].opt_state_flat(), runs["k1"].opt_state_flat()), key
        for f in runs["k1"].fault_state_:
            assert torch.equal(runs[key].fault_state_[f], runs["k1"].fault_state_[f]), (key, f)
    assert runs["k1"].bad_step_count == 2
    assert runs["emu"]._bundled._feed.ibuf is not None


def test_bundle_made_anew_when_the_policy_changes():
    n = TNet(conf(PORT, steps=2)).init(device="cpu")
    n.fit(t_it(batches(2)))
    first = n._bundled
    n.set_fault_policy(FaultPolicy())
    n.fit(t_it(batches(2)))
    assert n._bundled is not first and n.fault_state_ is not None


# ------------------------------------------------------------- refusals
def test_remat_telemetry_and_tbptt_still_refused():
    """An unknown remat policy ("full") still raises the reference's
    ``ValueError`` before any step. Telemetry and tBPTT are ported: under a
    fault policy a telemetry fit is the same bits as one without, and
    reports the guard's ``bad_count``; a tBPTT configuration given 2-D
    features takes the standard step, as the reference's."""
    n = TNet(conf(PORT, FaultPolicy())).init(device="cpu")
    n.conf.global_conf.remat_policy = "full"
    with pytest.raises(ValueError, match="unknown remat_policy: 'full'"):
        n.fit(TDataSet(*batches(1)[0]))
    assert n.iteration == 0
    plain = TNet(conf(PORT, FaultPolicy())).init(device="cpu")
    plain.fit(TDataSet(*batches(1)[0]))
    n = TNet(conf(PORT, FaultPolicy())).init(device="cpu")
    n.conf.global_conf.telemetry = True
    n.fit(TDataSet(*batches(1)[0]))
    np.testing.assert_array_equal(n.params_flat(), plain.params_flat())
    assert int(n.step_telemetry_["bad_count"]) == 0
    assert float(n.step_telemetry_["update_norm"]) > 0
    n = TNet(conf(PORT, FaultPolicy())).init(device="cpu")
    n.conf.backprop_type = "tbptt"
    n.fit(TDataSet(*batches(1)[0]))
    np.testing.assert_array_equal(n.params_flat(), plain.params_flat())
    assert n.iteration == 1


# ------------------------------------------------------------ checkpoints
def _meta(path):
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("meta.json"))


def test_fault_state_from_a_jax_zip_into_the_port(tmp_path):
    x, y = batches(1)[0]
    pol = dict(loss_scaling=True, init_loss_scale=2.0 ** 6, scale_growth_interval=100)
    with jfaults.fault_injection(nan_grad_steps=[1]):
        jnet = JNet(conf(JAX, jfaults.FaultPolicy(**pol))).init()
        jnet.fit(JDataSet(x, y), epochs=3, batch_size=8)
    path = str(tmp_path / "jax.zip")
    JSer.write_model(jnet, path)
    mine = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    want = {k: (float(v) if np.issubdtype(np.asarray(v).dtype, np.floating) else int(v))
            for k, v in jnet.fault_state_.items()}
    got = {k: (float(v) if v.is_floating_point() else int(v))
           for k, v in mine.fault_state_.items()}
    assert got == want == _meta(path)["fault_state"]
    assert mine.bad_step_count == 1 and mine.loss_scale == 32.0
    assert mine.fault_state_["good_count"].dtype == torch.int32


def test_fault_state_from_a_port_zip_into_jax(tmp_path):
    x, y = batches(1)[0]
    with fault_injection([0]):
        n = TNet(conf(PORT, FaultPolicy(init_loss_scale=2.0 ** 9),
                      mixed_precision=True)).init(device="cpu")
        n.fit(TDataSet(x, y), epochs=3, batch_size=8)
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(n, path)
    meta = _meta(path)["fault_state"]
    assert meta == {"bad_count": 1, "consec": 0, "good_count": 2, "loss_scale": 256.0,
                    "scale_good": 2}
    theirs = JSer.restore_multi_layer_network(path)
    assert theirs.bad_step_count == 1 and theirs.loss_scale == 256.0
    assert int(theirs.fault_state_["good_count"]) == 2
    assert isinstance(theirs.conf.global_conf.fault_policy, jfaults.FaultPolicy)
    # and back: a resumed port run keeps its clock and scale
    again = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    assert again.loss_scale == 256.0 and int(again.fault_state_["scale_good"]) == 2
    assert os.path.getsize(path) > 0
