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
  ``ParallelWrapper`` with as many workers on the virtual CPU mesh; and
  bundled steps (``steps_per_call`` 2), replicated and ZeRO-1, against the
  same ranks at 1 (bit for bit) and the JAX wrapper's bundled fit. The same
  runs train networks with batch statistics (a ``BatchNormalization``
  network, two narrow fused bottlenecks; f32 and bf16; ragged and bundled)
  with the global batch's statistics, and the BN network once with each
  rank's own (farther from JAX than the tolerance); and
  ``SharedTrainingMaster`` against JAX's master on as many virtual devices
  (messages index for index where the selection has a margin, params and
  slots, bundled, mid-fit checkpoint, refusals, and JAX's convergence and
  direction tests). Each world size spawns once per session; the xdist
  workers share the result through a file lock.

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
from deeplearning4j_tpu.parallel import SharedTrainingMaster as JMaster
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu.parallel.mesh import TrainingMesh as JMesh
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
from deeplearning4j_tpu_torch.train.faults import FaultPolicy

PARITY_TOL = 1e-5
BF16_TOL = 1e-3
NOISE_FACTOR = 2.0
#: the shared-training cases' selection margin: no |work| within it of the
#: threshold or of the capacity's cut
SELECTION_MARGIN = 1e-5
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


def test_one_rank_wrapper_takes_batch_statistics_without_collectives():
    """On one rank the rows are the global batch: the BN network through the
    replicated and the sharded wrapper equals ``fit`` bit for bit, running
    statistics included, and no batch-statistics collective runs."""
    from deeplearning4j_tpu_torch.nn.ops import launch
    from deeplearning4j_tpu_torch.parallel import mesh

    jnet = jax_net(bn=True)
    nets = [port_net(jnet, bn=True) for _ in range(3)]
    x, y = ranks.blobs()
    for _ in range(3):
        nets[0].fit(TDataSet(x, y))
    launch.reset_launch_counts()
    ParallelWrapper.builder(nets[1]).workers(1).build().fit(
        TExisting([TDataSet(x, y)]), epochs=3)
    ParallelWrapper.builder(nets[2]).workers(1).sharded_update(True).build().fit(
        TExisting([TDataSet(x, y)]), epochs=3)
    assert not {mesh.STATS_FORWARD, mesh.STATS_BACKWARD} & {
        k for k, n in launch.launch_counts.items() if n}
    for other in nets[1:]:
        np.testing.assert_array_equal(other.params_flat(), nets[0].params_flat())
        np.testing.assert_array_equal(other.opt_state_flat(), nets[0].opt_state_flat())
        np.testing.assert_array_equal(ranks.state_flat(other), ranks.state_flat(nets[0]))
        assert other.score() == nets[0].score()


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
    telemetry = port_net(jax_net())
    telemetry.conf.global_conf.telemetry = True
    pw = ParallelWrapper.builder(telemetry).steps_per_call(4).build()
    with pytest.raises(NotImplementedError, match="telemetry"):
        pw.fit(TExisting([TDataSet(*ranks.blobs(4))]))
    # the guarded sharded step is in; the telemetry one still raises
    tzero.make_sharded_train_step(net, TrainingMesh(1, device="cpu"), steps_per_call=2,
                                  policy=FaultPolicy())
    with pytest.raises(NotImplementedError, match="telemetry"):
        tzero.make_sharded_train_step(net, TrainingMesh(1, device="cpu"),
                                      steps_per_call=2, telemetry=True)
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
                    init = {}
                    for a, opts in ranks.ARCHS.items():
                        jnet = jax_net(**opts)
                        for tag, tree in (("p", jnet.params_), ("s", jnet.state_)):
                            init.update({f"{a}/{tag}{i}/{k}": np.asarray(v)
                                         for i, d in enumerate(tree) for k, v in d.items()})
                    np.savez(root / "init.npz", **init)
                    _spawn(world, str(root))
                cache[world] = dict(np.load(out))
        return cache[world]

    return get


def jax_fit(world, sharded, epochs, it=None, **opts):
    net = jax_net(**opts)
    ds = JDataSet(*ranks.batch_for(opts, world))
    pw = JWrapper.builder(net).workers(world).sharded_update(sharded).build()
    pw.fit(it if it is not None else JExisting([ds]), epochs=epochs)
    return net, pw


def jax_state_flat(jnet) -> np.ndarray:
    """The JAX network's layer state in ``ranks.state_flat``'s order."""
    chunks = [np.asarray(d[k], np.float32).reshape(-1) for d in jnet.state_ for k in sorted(d)]
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def assert_close(out, key, jnet, tol=PARITY_TOL):
    """Params, updater state and layer state (BN running statistics)."""
    np.testing.assert_allclose(out[f"{key}/params"], jnet.params_flat(), rtol=0, atol=tol)
    np.testing.assert_allclose(out[f"{key}/opt"], jnet.opt_state_flat(), rtol=0, atol=tol)
    np.testing.assert_allclose(out[f"{key}/state"], jax_state_flat(jnet), rtol=0, atol=tol)
    assert int(out[f"{key}/iteration"]) == jnet.iteration


WORLDS = [2, 4]


#: bf16 compute with batch statistics: after Adam's steps, noise (below)
NOISY = ("bn_bf16", "fused_bf16")


@pytest.mark.parametrize("case", sorted(c for c in ranks.VARIANTS if c not in NOISY))
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


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_bundled_steps_equal_single_steps_and_track_jax(rank_runs, world, sharded):
    """``steps_per_call`` 2 on 2 and 4 gloo ranks, replicated and ZeRO-1,
    over five batches (two bundles and a ragged single step an epoch), two
    epochs: bit-equal to the same ranks at 1, and within PARITY_TOL of the
    JAX wrapper's bundled fit (``test_pipeline.py::TestDataParallelBundling::
    test_parallel_wrapper_bundled_parity`` and ``::test_parallel_wrapper_zero1_bundled_parity``)."""
    out = rank_runs(world)
    key = f"bundle/{'sharded' if sharded else 'repl'}"
    for what in ("params", "opt", "score", "iteration"):
        np.testing.assert_array_equal(out[f"{key}/k2/{what}"], out[f"{key}/k1/{what}"])
    assert int(out[f"{key}/k2/iteration"]) == 10
    data = JExisting([JDataSet(x, y) for x, y in ranks.bundle_batches()])
    ref, _ = jax_fit(world, sharded, 2, it=data, steps=2)
    assert_close(out, f"{key}/k2", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_skip_bundling_when_always_padding(rank_runs, world):
    """Batches of 5 rows, which every rank count here must pad: no bundled
    step is built (the reference clamps to k = 1 up front,
    ``test_pipeline.py::test_parallel_wrapper_skips_bundling_when_always_padding``),
    and the fit equals k = 1's bit for bit and the JAX wrapper's within
    PARITY_TOL."""
    out = rank_runs(world)
    assert bool(out["padding/no_bundled_step"])
    np.testing.assert_array_equal(out["padding/k2/params"], out["padding/k1/params"])
    np.testing.assert_array_equal(out["padding/k2/opt"], out["padding/k1/opt"])
    data = JExisting([JDataSet(x, y) for x, y in ranks.padded_batches()])
    ref, jpw = jax_fit(world, False, 1, it=data, steps=2)
    assert jpw._bstep is None
    assert_close(out, "padding/k2", ref)


# ----------------------------------------------------------- the guard
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_guarded_wrapper_skips_the_poisoned_step(rank_runs, world):
    """The fault policy on 2 and 4 ranks with NaN at step 1 of 3: the
    replicated wrapper tracks JAX's unguarded wrapper on the batches with
    the poisoned one removed (2 steps) at PARITY_TOL, ZeRO-1 (its verdict on
    each rank's chunks of the summed gradient, agreed by one collective)
    matches replicated at 1e-6, and every rank counts one skipped step."""
    out = rank_runs(world)
    removed, _ = jax_fit(world, False, 2)
    # the host iteration counts every batch seen, the skipped one too
    removed.iteration += 1
    assert_close(out, "guard/repl", removed)
    for what in ("params", "opt"):
        np.testing.assert_allclose(out[f"guard/sharded/{what}"], out[f"guard/repl/{what}"],
                                   rtol=0, atol=1e-6)
    for key in ("guard/repl", "guard/sharded"):
        assert out[f"{key}/bad_counts"].tolist() == [1] * world
        assert int(out[f"{key}/good_count"]) == 2 and int(out[f"{key}/iteration"]) == 3


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_guarded_master_keeps_params_and_residual(rank_runs, world):
    """SharedTrainingMaster with the fault policy (the skip guard alone):
    the poisoned step leaves the params and the residual unchanged on every
    rank, and training then goes on, finite."""
    out = rank_runs(world)
    assert bool(out["guard/master/params_kept"]) and bool(out["guard/master/residual_kept"])
    assert bool(out["guard/master/finite"]) and bool(out["guard/master/moved"])
    assert out["guard/master/bad_counts"].tolist() == [1] * world
    assert int(out["guard/master/good_count"]) == 2


# ----------------------------------------------------- batch statistics
def _max_err(out, key, jnet) -> dict:
    return {"params": np.abs(out[f"{key}/params"] - jnet.params_flat()).max(),
            "opt": np.abs(out[f"{key}/opt"] - jnet.opt_state_flat()).max(),
            "state": np.abs(out[f"{key}/state"] - jax_state_flat(jnet)).max()}


@pytest.mark.parametrize("case", NOISY)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_bf16_batch_statistics_track_jax(rank_runs, world, case):
    """bf16 compute with BatchNormalization or the fused bottleneck, on 2
    and 4 ranks, replicated and sharded, against JAX's wrapper with as
    many workers.

    After the first step the BN running statistics and the score, which
    come from the first forward, are held at BF16_TOL (measured: 2.6e-5 and
    6e-8 from JAX's; a rank's own rows move them by ~1e-2). So is the
    backward through the cross-rank sums: after one step from zero slots
    Adam's m is 0.1 g and v 0.001 g², so the slots carry the mean gradient.
    The ranks' slots are within BF16_TOL of the port's one-process step on
    the global batch (measured at 2 ranks: 1.5e-4 BN, 2.2e-4 fused; with
    the backward's sum left out 1.2e-2 and 3.2e-2), and no farther from
    JAX's wrapper than that one-process step is from JAX's one-device
    step (which equals JAX's wrapper's), give or take BF16_TOL (the fused
    net's bf16 gradient is 1.1e-2 from JAX's in one process already).

    After three Adam(0.01) steps the params are bf16 noise in both
    packages: Adam moves a param by ~lr whatever the size of its gradient,
    so a gradient that bf16 rounding flips moves it by 2 lr. JAX's own
    2-worker fit of the fused network is 0.059 from its one-device fit
    (the order of the statistics' sums changes bf16 roundings), the port's
    one-process fit 0.059 from JAX's. So the three-step params, slots and
    statistics are held to NOISE_FACTOR times the larger of those two
    distances, as ``tests/test_torch_train.py`` holds bf16 gradients."""
    out = rank_runs(world)
    opts = ranks.VARIANTS[case]
    x, y = ranks.batch_for(opts, world)
    step1_device = jax_net(**opts)
    step1_device.fit(JDataSet(x, y), epochs=1, batch_size=len(x))
    step1_process = port_net(jax_net(**opts), **opts)
    step1_process.fit(TDataSet(x, y), epochs=1, batch_size=len(x))
    step1_noise = np.abs(step1_process.opt_state_flat() - step1_device.opt_state_flat()).max()
    one_device = jax_net(**opts)
    one_device.fit(JDataSet(x, y), epochs=3, batch_size=len(x))
    one_process = port_net(jax_net(**opts), **opts)
    one_process.fit(TDataSet(x, y), epochs=3, batch_size=len(x))
    for sharded in (False, True):
        key = f"{case}/{'sharded' if sharded else 'repl'}"
        first, _ = jax_fit(world, sharded, 1, **opts)
        np.testing.assert_allclose(out[f"{key}/step1/state"], jax_state_flat(first),
                                   rtol=0, atol=BF16_TOL)
        assert abs(float(out[f"{key}/step1/score"]) - float(first.score())) <= BF16_TOL
        np.testing.assert_allclose(out[f"{key}/step1/opt"], step1_process.opt_state_flat(),
                                   rtol=0, atol=BF16_TOL)
        to_jax = np.abs(out[f"{key}/step1/opt"] - first.opt_state_flat()).max()
        assert to_jax <= step1_noise + BF16_TOL, (key, to_jax, step1_noise)
        ref, _ = jax_fit(world, sharded, 3, **opts)
        noise = {"params": max(np.abs(ref.params_flat() - one_device.params_flat()).max(),
                               np.abs(one_process.params_flat()
                                      - one_device.params_flat()).max()),
                 "opt": max(np.abs(ref.opt_state_flat() - one_device.opt_state_flat()).max(),
                            np.abs(one_process.opt_state_flat()
                                   - one_device.opt_state_flat()).max()),
                 "state": max(np.abs(jax_state_flat(ref) - jax_state_flat(one_device)).max(),
                              np.abs(ranks.state_flat(one_process)
                                     - jax_state_flat(one_device)).max())}
        for what, err in _max_err(out, key, ref).items():
            assert err <= NOISE_FACTOR * noise[what] + BF16_TOL, (key, what, err, noise[what])
        assert int(out[f"{key}/iteration"]) == ref.iteration == 3
    np.testing.assert_allclose(out[f"{case}/sharded/params"], out[f"{case}/repl/params"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_per_rank_statistics_miss_jax(rank_runs, world):
    """Non-vacuity: the f32 BN network trained with each rank's own
    statistics (the batch-statistics context left out) is farther from
    JAX's wrapper than PARITY_TOL, in params and running statistics, where
    the cross-rank run is within it (``test_ranks_track_jax_replicated_and_sharded``)."""
    out = rank_runs(world)
    ref, _ = jax_fit(world, False, 3, bn=True)
    err = _max_err(out, "bn_f32/per_rank", ref)
    assert err["params"] > 10 * PARITY_TOL and err["state"] > 10 * PARITY_TOL, err
    assert_close(out, "bn_f32/repl", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_ragged_last_batch_enters_the_batch_statistics(rank_runs, world):
    """The BN network over 29 rows in batches of 8: the last batch is padded
    to the rank count with cycled real rows whose loss weight is 0, and
    those rows enter the batch statistics, as in JAX's wrapper."""
    out = rank_runs(world)
    x, y = ranks.blobs(29, seed=4)
    for sharded in (False, True):
        ref, _ = jax_fit(world, sharded, 2, it=JList(JDataSet(x, y), 8), bn=True)
        assert_close(out, f"ragged_bn/{'sharded' if sharded else 'repl'}", ref)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_bundled_batch_statistics_equal_single_steps(rank_runs, world, sharded):
    """The BN network at ``steps_per_call`` 2 over five batches of 8, two
    epochs: bit-equal to the same ranks at 1 (params, slots, running
    statistics, score), and within PARITY_TOL of JAX's bundled wrapper."""
    out = rank_runs(world)
    key = f"bundle_bn/{'sharded' if sharded else 'repl'}"
    for what in ("params", "opt", "state", "score", "iteration"):
        np.testing.assert_array_equal(out[f"{key}/k2/{what}"], out[f"{key}/k1/{what}"])
    data = JExisting([JDataSet(x, y) for x, y in ranks.bundle_batches()])
    ref, _ = jax_fit(world, sharded, 2, it=data, steps=2, bn=True)
    assert_close(out, f"{key}/k2", ref)


# ----------------------------------------------------- shared training
def jax_master(world, sharded=False, threshold=ranks.SHARED_THRESHOLD, **opts):
    return (JMaster.builder(threshold).mesh(JMesh(data=world, devices=jax.devices()[:world]))
            .sharded_update(sharded).build())


def _selection_margin(work, threshold, capacity) -> float:
    """How far every |work| of one rank lies from the threshold and, when
    more elements qualify than the message holds, from the capacity's cut."""
    mag = np.abs(work.astype(np.float64))
    gap = np.abs(mag - threshold).min()
    over = np.sort(mag[mag >= threshold])[::-1]
    if over.size > capacity:
        gap = min(gap, over[capacity - 1] - over[capacity])
    return float(gap)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_tracks_jax(rank_runs, world, sharded):
    """``SharedTrainingMaster`` at threshold 1e-5 on ``TestSharedMasterSharded``'s
    network, one epoch of 32 rows a fit, three fits, against JAX's master on
    as many virtual devices. JAX's message is not observable, its residual
    is: an element it sent moved its residual by the threshold, so at each
    step the ranks' work vectors (within ~1e-9 of JAX's) tell which
    elements JAX sent, and JAX's work is its residual plus what it sent.
    Selection is discontinuous, so each step first asserts the margin: no
    |work| of JAX's within SELECTION_MARGIN of the threshold or of the
    capacity's cut. Then every rank's message holds exactly the elements
    JAX sent, and params, slots, score, residual and
    ``residual_magnitude()`` are within PARITY_TOL."""
    out = rank_runs(world)
    key = f"shared/{'sharded' if sharded else 'repl'}"
    thr = ranks.SHARED_THRESHOLD
    capacity = int(out[f"{key}/capacity"])
    net = jax_net()
    master = jax_master(world, sharded)
    ds = JDataSet(*ranks.blobs())
    for step in range(ranks.SHARED_STEPS):
        master.fit(net, JExisting([ds]), epochs=1)
        residual = np.asarray(master._residual)
        work = out[f"{key}/work{step}"]
        sent = np.abs(work - residual) > thr / 2
        jax_work = residual + thr * np.sign(work - residual) * sent
        for r in range(world):
            assert _selection_margin(jax_work[r], thr, capacity) > SELECTION_MARGIN, (step, r)
            idx = out[f"{key}/indices{step}"][r]
            assert sorted(idx[idx >= 0].tolist()) == np.flatnonzero(sent[r]).tolist(), (step, r)
            assert int(out[f"{key}/count{step}"][r][0]) == int(sent[r].sum())
        np.testing.assert_allclose(out[f"{key}/residual{step}"], residual, rtol=0,
                                   atol=PARITY_TOL)
    assert_close(out, key, net)
    assert abs(float(out[f"{key}/score"]) - float(net.score_)) <= PARITY_TOL
    assert abs(float(out[f"{key}/residual_magnitude"])
               - master.residual_magnitude()) <= PARITY_TOL * 1e-2
    assert (master._layout is not None) == sharded


@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_config_knob_enables_sharding(rank_runs, world):
    out = rank_runs(world)
    assert bool(out["shared/knob/on"])
    net = jax_net(sharded_knob=True)
    master = jax_master(world)
    master.fit(net, JExisting([JDataSet(*ranks.blobs())]), epochs=1)
    assert master._layout is not None
    assert_close(out, "shared/knob", net)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_bundled_steps_equal_single_steps(rank_runs, world, sharded):
    """``steps_per_call`` 2 over five batches of 8 (two bundles and a single
    step an epoch), two epochs: params, slots, score and every rank's
    residual bit-equal to the same master at 1."""
    out = rank_runs(world)
    key = f"shared/bundle/{'sharded' if sharded else 'repl'}"
    for what in ("params", "opt", "score", "iteration", "residual"):
        np.testing.assert_array_equal(out[f"{key}/k2/{what}"], out[f"{key}/k1/{what}"])
    assert int(out[f"{key}/k2/iteration"]) == 10


@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_midfit_checkpoint_gathers_opt_state(rank_runs, world):
    """A zip written in the middle of a sharded master's fit (at iteration
    2) holds the gathered updater state of that iteration: JAX's master
    after two steps."""
    out = rank_runs(world)
    assert bool(out["shared/midfit/hook_cleared"])
    net = jax_net()
    master = jax_master(world, True)
    master.fit(net, JExisting([JDataSet(*ranks.blobs())] * 2), epochs=1)
    assert_close(out, "shared/midfit", net)


@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_refusals(rank_runs, world):
    """A model with layer state, a second model and a batch that does not
    divide by the ranks raise ``ValueError``, as JAX's master does."""
    out = rank_runs(world)
    for what in ("stateful", "second_model", "indivisible"):
        assert bool(out[f"shared/refuses/{what}"]), what


@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_converges(rank_runs, world):
    """``tests/test_parity_tail.py::TestSharedTrainingMaster::test_compressed_dp_converges``
    on the ranks: the last of 60 scores is below half the first."""
    out = rank_runs(world)
    scores = out["shared/converge/scores"]
    assert scores[-1] < 0.5 * scores[0], (scores[0], scores[-1])
    assert np.isfinite(float(out["shared/converge/residual_magnitude"]))


@pytest.mark.parametrize("world", WORLDS)
def test_shared_master_tracks_exact_dp_direction(rank_runs, world):
    """``::test_compressed_updates_track_exact_dp_direction`` on the ranks:
    after 20 fits the master's accumulated update has a cosine above 0.7
    with the port's replicated wrapper's."""
    out = rank_runs(world)
    d_exact, d_comp = out["shared/direction/exact"], out["shared/direction/compressed"]
    cos = float(d_exact @ d_comp / (np.linalg.norm(d_exact) * np.linalg.norm(d_comp) + 1e-12))
    assert cos > 0.7, cos
