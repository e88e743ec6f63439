"""The port's data-parallel training (``parallel/``: ``TrainingMesh``,
``ParallelWrapper``, the ZeRO-1 core of ``zero.py``) against the JAX
package, on the CPU.

- The flat shard layout (groups, entry order, offsets, zero padding) and
  the opt-state conversion equal the reference's for 1 to 4 shards.
- ``apply_sharded_updates`` on one process (the reference's ``mesh=None``
  leg, 4 shards) against JAX's.
- One rank in this process (a gloo group from a ``HashStore``):
  ``MultiLayerNetwork.fit``, the replicated wrapper and the sharded one
  give the same bits.
- Several ranks: 2 and 4 gloo processes (``torch.multiprocessing`` spawn,
  a ``FileStore`` under the session's temporary directory, never a fixed
  port) run the cases of ``tests/test_sharded_update.py::TestWrapperParity``
  (``tests/test_torch_parallel_ranks.py``), held against the JAX package's
  ``ParallelWrapper`` with as many workers on the virtual CPU mesh. Each
  world size spawns once per session; the xdist workers share the result
  through a file lock.

Tolerances (float32 params, Adam slots and scores): PARITY_TOL (1e-5,
absolute). JAX averages the gradient inside one program; the ranks here
average their own rows' gradients in a collective, so sums run in another
order and a gradient moves by a few ulps; Adam's m/sqrt(v) passes that on
undamped where a gradient is near zero. The reference holds its own
sharded-vs-replicated runs at 1e-6; sharded and replicated runs of the
port agree at that bound too.

Under bf16 compute (f32 master weights and updater math): BF16_TOL (1e-3,
a tenth of Adam's lr 0.01). Torch and XLA round the bf16 activations and
gradients at different points: a single-process ``fit`` of the port is
2.3e-4 away from JAX's after the 3 steps (measured), while JAX's own
2- and 4-worker runs are within 4.0e-5 of its single-device one. The
ranks add nothing to the first; sharded and replicated runs of the port
still agree at 1e-6.
"""

import fcntl
import os
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
import test_torch_parallel_ranks as ranks
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh
from deeplearning4j_tpu_torch.parallel import zero as tzero
from deeplearning4j_tpu_torch.parallel.mesh import MeshInitError

PARITY_TOL = 1e-5
BF16_TOL = 1e-3
SPAWN_TIMEOUT_S = 240

JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_net(**opts):
    return JNet(ranks.build(JAX, **opts)).init()


def port_net(jnet, **opts):
    net = TNet(ranks.build(PORT, **opts)).init(device="cpu")
    interop.load_jax_params(net, numpy_tree(jnet.params_), numpy_tree(jnet.state_),
                            opt_state=numpy_tree(jnet.opt_state_), iteration=jnet.iteration)
    return net


def mixed_net(pkg):
    """Two updater groups: the global Adam on the first dense layer and the
    output, Nesterovs on the second dense layer; 113 params in all."""
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(9).updater(upd.Adam(0.01))
            .list()
            .layer(layers.DenseLayer(n_out=7, activation="tanh"))
            .layer(layers.DenseLayer(n_out=5, activation="relu",
                                     updater=upd.Nesterovs(1e-2, 0.9)))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(conf.InputType.feed_forward(6))
            .build())


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_layout_matches_jax(n_shards):
    jnet = JNet(mixed_net(JAX)).init()
    tnet = TNet(mixed_net(PORT)).init(device="cpu")
    jl = jzero.build_layout(jnet, n_shards)
    tl = tzero.build_layout(tnet, n_shards)
    assert len(tl.groups) == len(jl.groups) == 2
    for tg, jg in zip(tl.groups, jl.groups):
        assert type(tg.updater).__name__ == type(jg.updater).__name__
        assert (tg.total, tg.padded, tg.chunk) == (jg.total, jg.padded, jg.chunk)
        assert [(e.layer, e.name, e.shape, e.size, e.offset) for e in tg.entries] == \
            [(e.layer, e.name, e.shape, e.size, e.offset) for e in jg.entries]
    assert tl.n_padding() == jl.n_padding()
    assert tl.skip == jl.skip


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_opt_state_shards_as_jax_and_round_trips(n_shards):
    jnet = JNet(mixed_net(JAX)).init()
    rng = np.random.default_rng(n_shards)
    jopt = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), numpy_tree(jnet.opt_state_))
    tnet = TNet(mixed_net(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, numpy_tree(jnet.params_), [{} for _ in jnet.params_],
                            opt_state=jopt)
    jz = jzero.build_layout(jnet, n_shards).shard_opt_state(jopt)
    tl = tzero.build_layout(tnet, n_shards)
    tz = tzero.shard_model_opt_state(tnet, tl)
    for grp, mine, theirs in zip(tl.groups, tz, jz):
        assert sorted(mine) == sorted(theirs)
        for s in theirs:
            assert tuple(mine[s].shape) == (n_shards, grp.chunk)
            np.testing.assert_array_equal(mine[s].numpy(), np.asarray(theirs[s]))
    before = tnet.opt_state_flat()
    tzero.unshard_model_opt_state(tnet, tl, tz)
    np.testing.assert_array_equal(tnet.opt_state_flat(), before)


def test_apply_sharded_updates_matches_jax():
    """One process, 4 shards (the reference's ``mesh=None`` leg), two
    updater groups: params and slots after one update. m' and v' and the
    Nesterovs slot are the same f32 operations in both packages; p' is held
    at PARITY_TOL. The fused impls give the reference composition's bits."""
    jnet = JNet(mixed_net(JAX)).init()
    tnet = TNet(mixed_net(PORT)).init(device="cpu")
    rng = np.random.default_rng(5)

    def rand_tree(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(np.shape(a)) * scale).astype(np.float32), tree)

    params = numpy_tree(jnet.params_)
    grads = rand_tree(params, 0.1)
    opt = jax.tree_util.tree_map(np.abs, rand_tree(numpy_tree(jnet.opt_state_), 0.01))
    interop.load_jax_params(tnet, params, [{} for _ in params], opt_state=opt)
    jl = jzero.build_layout(jnet, 4)
    tl = tzero.build_layout(tnet, 4)
    jp, jz = jzero.apply_sharded_updates(jl, params, grads, jl.shard_opt_state(opt), 4, 3, 0)
    tgrads = [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads]
    tz = tzero.shard_model_opt_state(tnet, tl)
    tp, tz_new = tzero.apply_sharded_updates(tl, tnet.params_, tgrads, tz, 4, 3, 0)
    fp, fz_new = tzero.apply_sharded_updates(tl, tnet.params_, tgrads, tz, 4, 3, 0,
                                             fused_impls=fu.resolve_group_impls(tl))
    for mine, fused, theirs in zip(tp, fp, numpy_tree(jp)):
        for k in theirs:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k], rtol=0, atol=PARITY_TOL)
            assert torch.equal(mine[k], fused[k])
    for mine, fused, theirs in zip(tz_new, fz_new, numpy_tree(jz)):
        for s in theirs:
            np.testing.assert_array_equal(mine[s].numpy(), theirs[s])
            assert torch.equal(mine[s], fused[s])


# ------------------------------------------------------------- one rank here
def test_one_rank_wrapper_equals_fit_replicated_and_sharded():
    jnet = jax_net()
    nets = [port_net(jnet) for _ in range(3)]
    x, y = ranks.blobs()
    for _ in range(3):
        nets[0].fit(TDataSet(x, y))
    ParallelWrapper.builder(nets[1]).workers(1).build().fit(
        TExisting([TDataSet(x, y)]), epochs=3)
    pw = ParallelWrapper.builder(nets[2]).workers(1).sharded_update(True).build()
    pw.fit(TExisting([TDataSet(x, y)]), epochs=3)
    assert pw.mesh.n_data == 1 and pw.mesh.rank == 0
    for other in nets[1:]:
        np.testing.assert_array_equal(other.params_flat(), nets[0].params_flat())
        np.testing.assert_array_equal(other.opt_state_flat(), nets[0].opt_state_flat())
        assert other.score() == nets[0].score() and other.iteration == 3
    assert nets[2]._opt_state_sync is None


def test_graph_fit_ignores_the_sharded_update_knob():
    """``ComputationGraph.fit`` trains a configuration that sets
    ``sharded_update`` as one without it (the reference's ``fit`` never
    reads the knob; only the wrappers do)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def graph(knob):
        b = tconf.NeuralNetConfiguration.builder().seed(2).updater(tupd.Adam(1e-2))
        if knob:
            b = b.sharded_update(True)
        gb = (b.graph_builder().add_inputs("in")
              .set_input_types(tconf.InputType.feed_forward(5)))
        gb.add_layer("dense", tlayers.DenseLayer(n_out=4, activation="tanh"), "in")
        gb.add_layer("out", tlayers.OutputLayer(n_out=3, activation="softmax"), "dense")
        return ComputationGraph(gb.set_outputs("out").build()).init(device="cpu")

    a, b = graph(True), graph(False)
    assert a.conf.global_conf.sharded_update and not b.conf.global_conf.sharded_update
    x, y = ranks.blobs(8)
    a.fit(TDataSet(x, y))
    b.fit(TDataSet(x, y))
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    # and the wrapper reads it, for a graph as for a list network
    c = graph(True)
    pw = ParallelWrapper.builder(c).workers(1).build()
    assert pw.sharded_update
    pw.fit(TExisting([TDataSet(x, y)]))
    np.testing.assert_array_equal(c.params_flat(), a.params_flat())
    np.testing.assert_array_equal(c.opt_state_flat(), a.opt_state_flat())


def test_wrapper_refusals_and_knobs():
    net = port_net(jax_net())
    with pytest.raises(MeshInitError, match="one per rank|process group has"):
        ParallelWrapper.builder(net).workers(2).build()
    with pytest.warns(UserWarning, match="averaging_frequency"):
        ParallelWrapper.builder(net).averaging_frequency(5)
    pw = ParallelWrapper.builder(net).steps_per_call(4).build()
    with pytest.raises(NotImplementedError, match="bundled steps"):
        pw.fit(TExisting([TDataSet(*ranks.blobs(4))]))
    with pytest.raises(NotImplementedError, match="A3"):
        tzero.make_sharded_train_step(net, TrainingMesh(1, device="cpu"), steps_per_call=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pw = (ParallelWrapper.builder(net).workers(1).prefetch_buffer(2)
              .report_score_after_averaging(True).averaging_frequency(1).build())
    assert not pw.sharded_update


# ------------------------------------------------------------- several ranks
def _spawn(world, root):
    ctx = mp.start_processes(ranks.run, args=(world, root), nprocs=world, join=False,
                             start_method="spawn")
    try:
        deadline = SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            deadline -= 5
            if deadline <= 0:
                raise TimeoutError(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="session")
def rank_runs(tmp_path_factory):
    """world -> the rank-0 results of :func:`test_torch_parallel_ranks.run`, made
    once per session: under xdist the workers share one run per world size
    through a lock in the session's common temporary directory."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    cache = {}

    def get(world):
        if world not in cache:
            root = shared / f"torch_parallel_world{world}"
            root.mkdir(exist_ok=True)
            with open(shared / f"torch_parallel_world{world}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                out = root / "out.npz"
                if not out.exists():
                    jnet = jax_net()
                    np.savez(root / "init.npz", **{f"p{i}/{k}": np.asarray(v)
                                                   for i, p in enumerate(jnet.params_)
                                                   for k, v in p.items()})
                    _spawn(world, str(root))
                cache[world] = dict(np.load(out))
        return cache[world]

    return get


def jax_fit(world, sharded, epochs, it=None, **opts):
    net = jax_net(**opts)
    ds = JDataSet(*ranks.blobs())
    pw = JWrapper.builder(net).workers(world).sharded_update(sharded).build()
    pw.fit(it if it is not None else JExisting([ds]), epochs=epochs)
    return net, pw


def assert_close(out, key, jnet, tol=PARITY_TOL):
    np.testing.assert_allclose(out[f"{key}/params"], jnet.params_flat(), rtol=0, atol=tol)
    np.testing.assert_allclose(out[f"{key}/opt"], jnet.opt_state_flat(), rtol=0, atol=tol)
    assert int(out[f"{key}/iteration"]) == jnet.iteration


WORLDS = [2, 4]


@pytest.mark.parametrize("case", sorted(ranks.VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_track_jax_replicated_and_sharded(rank_runs, world, case):
    out = rank_runs(world)
    opts = ranks.VARIANTS[case]
    ref, _ = jax_fit(world, False, 3, **opts)
    zer, jpw = jax_fit(world, True, 3, **opts)
    tol = BF16_TOL if opts.get("mixed_precision") else PARITY_TOL
    assert_close(out, f"{case}/repl", ref, tol)
    assert_close(out, f"{case}/sharded", zer, tol)
    assert abs(float(out[f"{case}/sharded/score"]) - float(zer.score())) <= tol
    # sharded and replicated runs of the port agree at the reference's own bound
    np.testing.assert_allclose(out[f"{case}/sharded/params"], out[f"{case}/repl/params"],
                               rtol=0, atol=1e-6)
    assert int(out[f"{case}/n_padding"]) == jpw._zlayout.n_padding()


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_odd_param_count_pads(rank_runs, world):
    """66 trainable params: zero padding over 4 ranks, none over 2."""
    out = rank_runs(world)
    assert int(out["f32/n_padding"]) == (2 if world == 4 else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_config_knob_enables_sharding(rank_runs, world):
    out = rank_runs(world)
    assert bool(out["knob/on"]) and bool(out["knob/json"])
    ref, _ = jax_fit(world, True, 1, sharded_knob=True)
    assert_close(out, "knob", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_midfit_checkpoint_gathers_opt_state(rank_runs, world):
    out = rank_runs(world)
    assert bool(out["midfit/hook_cleared"])
    ref, _ = jax_fit(world, False, 2)
    assert_close(out, "midfit", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_save_load_resume(rank_runs, world):
    out = rank_runs(world)
    assert int(out["resume/restored_at"]) == 2 * 100 + 2
    ref, _ = jax_fit(world, False, 4)
    assert_close(out, "resume", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_ragged_last_batch(rank_runs, world):
    out = rank_runs(world)
    x, y = ranks.blobs(29, seed=4)
    for sharded in (False, True):
        ref, _ = jax_fit(world, sharded, 2, it=JList(JDataSet(x, y), 8))
        assert_close(out, f"ragged/{'sharded' if sharded else 'repl'}", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_refuse_batch_statistics(rank_runs, world):
    assert bool(rank_runs(world)["bn/refused"])
