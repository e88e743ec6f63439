"""The rank side of ``tests/test_torch_parallel.py``'s multi-process runs.

Each rank of a gloo group (``torch.multiprocessing`` spawn, a ``FileStore``
under the test's temporary directory) builds the port's networks from the
JAX package's initial params (carried as arrays in ``init.npz``), trains
them through ``ParallelWrapper`` and, on rank 0, writes what it got to
``out.npz`` for the test to hold against the JAX package's
``ParallelWrapper`` and ``SharedTrainingMaster``. The networks and
datasets are the ones of ``tests/test_sharded_update.py::TestWrapperParity``
and ``::TestSharedMasterSharded``, for bundled steps
``tests/test_pipeline.py``'s ``_batches``-style data, and for the master's
behaviour ``tests/test_parity_tail.py::TestSharedTrainingMaster``'s; the
networks with batch statistics put a ``BatchNormalization`` into the first,
or are two narrow fused ResNet bottlenecks on 8x8 images. Imports no JAX,
and holds no tests itself: its name keeps it among the port's test files.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

N_IN, N_HID, N_OUT = 5, 7, 3
#: the fused network's images (8 rows a rank) and bottleneck width
IMAGE, CHANNELS, WIDTH, ROWS_PER_RANK = 8, 3, 8, 8
#: the shared-training cases' threshold (TestSharedMasterSharded's)
SHARED_THRESHOLD = 1e-5
SHARED_STEPS = 3


def build(pkg, mixed_precision=False, sharded_knob=False, gradnorm=False, bn=False,
          fused=False, steps=1):
    """The TestWrapperParity network in ``pkg`` = (conf, layers, updaters),
    with a BatchNormalization after its first layer (``bn``), or the fused
    bottleneck network (``fused``); ``steps``: its ``steps_per_call``."""
    conf, layers, upd = pkg
    b = conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
    if steps > 1:
        b = b.steps_per_call(steps)
    if mixed_precision:
        b = b.compute_dtype("bfloat16")
    if sharded_knob:
        b = b.sharded_update(True)
    if fused:
        return (b.list()
                .layer(layers.FusedResNetBottleneck(width=WIDTH, project=True))
                .layer(layers.FusedResNetBottleneck(width=WIDTH))
                .layer(layers.GlobalPoolingLayer(pooling_type="avg"))
                .layer(layers.OutputLayer(n_out=N_OUT, activation="softmax"))
                .set_input_type(conf.InputType.convolutional(IMAGE, IMAGE, CHANNELS))
                .build())
    kw = {"gradient_normalization": "renormalize_l2_per_layer"} if gradnorm else {}
    b = b.list().layer(layers.DenseLayer(n_out=N_HID, activation="tanh", **kw))
    if bn:
        b = b.layer(layers.BatchNormalization())
    return (b.layer(layers.OutputLayer(n_out=N_OUT, activation="softmax", **kw))
            .set_input_type(conf.InputType.feed_forward(N_IN)).build())


def arch(opts) -> str:
    """The key of a network's initial params in ``init.npz``."""
    return "fused" if opts.get("fused") else "bn" if opts.get("bn") else "dense"


#: architecture -> the network options that build it
ARCHS = {"dense": {}, "bn": {"bn": True}, "fused": {"fused": True}}


def blobs(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, n)]
    return x, y


def images(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, IMAGE, IMAGE, CHANNELS)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, n)]
    return x, y


def batch_for(opts, world):
    """The one global batch a case trains on: 32 blobs, or for the fused
    network ROWS_PER_RANK images a rank."""
    return images(ROWS_PER_RANK * world) if opts.get("fused") else blobs()


def clusters(n=64, seed=0):
    """TestSharedTrainingMaster's three separable clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, 5)) * 2
    cls = rng.integers(0, 3, n)
    x = (centers[cls] + rng.standard_normal((n, 5)) * 0.3).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[cls]


def bundle_batches():
    """Five batches of 8 rows: at ``steps_per_call`` 2, two bundles and a
    ragged single step an epoch."""
    return [blobs(8, seed=20 + i) for i in range(5)]


def padded_batches():
    """Four batches of 5 rows, which 2 and 4 ranks must both pad."""
    return [blobs(5, seed=30 + i) for i in range(4)]


#: case -> the network options of its replicated and sharded runs
VARIANTS = {"f32": {}, "bf16": {"mixed_precision": True}, "gradnorm": {"gradnorm": True},
            "bn_f32": {"bn": True}, "bn_bf16": {"bn": True, "mixed_precision": True},
            "fused_f32": {"fused": True}, "fused_bf16": {"fused": True, "mixed_precision": True}}


def _port():
    import deeplearning4j_tpu_torch.nn.conf as tconf
    from deeplearning4j_tpu_torch import updaters as tupd
    from deeplearning4j_tpu_torch.nn.conf import layers as tlayers

    return tconf, tlayers, tupd


def _net(init, **opts):
    """The port's network of ``opts`` holding the JAX package's initial
    params and layer state."""
    from deeplearning4j_tpu_torch.interop import load_jax_params
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(build(_port(), **opts)).init(device="cpu")
    a = arch(opts)
    params = [{k: init[f"{a}/p{i}/{k}"] for k in p} for i, p in enumerate(net.params_)]
    state = [{k: init[f"{a}/s{i}/{k}"] for k in s} for i, s in enumerate(net.state_)]
    load_jax_params(net, params, state)
    return net


def state_flat(net) -> np.ndarray:
    """The layer state (BN running statistics) as one f32 vector, layer by
    layer, names sorted."""
    from deeplearning4j_tpu_torch.nn.multilayer import flatten_tensors

    return flatten_tensors(net.state_)


def run(rank, world, root):
    """Every case on this rank; rank 0 saves the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = _cases(rank, world, root)
        if rank == 0:
            np.savez(os.path.join(root, "out.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _cases(rank, world, root):
    from deeplearning4j_tpu_torch.data import (
        DataSet,
        ExistingDataSetIterator,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    init = dict(np.load(os.path.join(root, "init.npz")))
    ds = DataSet(*blobs())
    out = {}

    def save(key, net):
        out[f"{key}/params"] = net.params_flat()
        out[f"{key}/opt"] = net.opt_state_flat()
        out[f"{key}/state"] = state_flat(net)
        out[f"{key}/score"] = np.float32(np.nan if net.score_ is None else net.score())
        out[f"{key}/iteration"] = np.int64(net.iteration)

    def fit(net, sharded, epochs, it=None):
        pw = ParallelWrapper.builder(net).workers(world).sharded_update(sharded).build()
        pw.fit(it if it is not None else ExistingDataSetIterator([ds]), epochs=epochs)
        return pw

    # replicated and sharded, 3 epochs of one batch (f32, bf16 compute,
    # gradient normalization, batch statistics), read after the first too;
    # the padding of the flat groups
    for case, opts in VARIANTS.items():
        data = ExistingDataSetIterator([DataSet(*batch_for(opts, world))])
        for sharded in (False, True):
            key = f"{case}/{'sharded' if sharded else 'repl'}"
            net = _net(init, **opts)
            fit(net, sharded, 1, data)
            save(f"{key}/step1", net)
            pw = fit(net, sharded, 2, data)
            save(key, net)
            if sharded:
                out[f"{case}/n_padding"] = np.int64(pw._zlayout.n_padding())

    # the BN network with each rank's own statistics (the batch-statistics
    # context left out): what the cross-rank statistics repair
    from deeplearning4j_tpu_torch.parallel import TrainingMesh

    saved = TrainingMesh.batch_stats
    TrainingMesh.batch_stats = lambda self: contextlib.nullcontext()
    try:
        net = _net(init, bn=True)
        fit(net, False, 3)
        save("bn_f32/per_rank", net)
    finally:
        TrainingMesh.batch_stats = saved

    # the configuration's knob turns the sharded update on
    net = _net(init, sharded_knob=True)
    pw = ParallelWrapper.builder(net).workers(world).build()
    pw.fit(ExistingDataSetIterator([ds]), epochs=1)
    out["knob/on"] = np.bool_(pw.sharded_update and pw._zlayout is not None)
    clone = type(net.conf).from_json(net.conf.to_json())
    out["knob/json"] = np.bool_(clone.global_conf.sharded_update is True)
    save("knob", net)

    # a checkpoint written in the middle of a sharded fit (by the data
    # iterator, as user code in a listener would) holds that iteration's
    # gathered updater state; every rank writes, the gather is a collective
    class CheckpointingIterator(ExistingDataSetIterator):
        def __init__(self, net, at, path, batches=None):
            super().__init__(batches or [ds])
            self.net, self.at, self.path = net, at, path

        def next(self):
            if self.net.iteration == self.at:
                ModelSerializer.write_model(self.net, self.path)
            return super().next()

    net = _net(init)
    mid = os.path.join(root, f"mid{rank}.zip")
    fit(net, True, 4, CheckpointingIterator(net, 2, mid))
    out["midfit/hook_cleared"] = np.bool_(getattr(net, "_opt_state_sync", None) is None)
    save("midfit", ModelSerializer.restore_multi_layer_network(mid, device="cpu"))

    # 2 sharded epochs, save, restore, 2 more sharded epochs
    net = _net(init)
    fit(net, True, 2)
    path = os.path.join(root, f"ckpt{rank}.zip")
    ModelSerializer.write_model(net, path)
    resumed = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    out["resume/restored_at"] = np.int64(resumed.iteration * 100 + resumed.epoch)
    fit(resumed, True, 2)
    save("resume", resumed)

    # a ragged last batch (29 rows in batches of 8: the last 5 rows padded
    # to the rank count), replicated and sharded; with batch statistics the
    # padded rows enter them
    x, y = blobs(29, seed=4)
    for prefix, opts in (("ragged", {}), ("ragged_bn", {"bn": True})):
        for sharded in (False, True):
            net = _net(init, **opts)
            fit(net, sharded, 2, ListDataSetIterator(DataSet(x, y), 8))
            save(f"{prefix}/{'sharded' if sharded else 'repl'}", net)

    # bundled steps (steps_per_call 2) against single steps, replicated and
    # sharded, 2 epochs; batches every rank count must pad never bundle
    for prefix, opts in (("bundle", {}), ("bundle_bn", {"bn": True})):
        for sharded in (False, True):
            for k in (1, 2):
                net = _net(init, steps=k, **opts)
                fit(net, sharded, 2, ExistingDataSetIterator(
                    [DataSet(x, y) for x, y in bundle_batches()]))
                save(f"{prefix}/{'sharded' if sharded else 'repl'}/k{k}", net)
    for k in (1, 2):
        net = _net(init, steps=k)
        pw = fit(net, False, 1, ExistingDataSetIterator(
            [DataSet(x, y) for x, y in padded_batches()]))
        save(f"padding/k{k}", net)
    out["padding/no_bundled_step"] = np.bool_(pw._bstep is None)

    out.update(_guard_cases(world, init, save, ds))
    out.update(_shared_cases(rank, world, root, init, save, CheckpointingIterator))
    return out


def _guard_cases(world, init, save, ds):
    """The fault policy on the wrapper, replicated and ZeRO-1, and on the
    master: 3 epochs of the 32 blobs with NaN injected at step 1 (the
    skipped step), every rank's bad-step count gathered; the master's
    params and residual around the poisoned step, and its updater clock."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection

    out = {}

    def bad_counts(net):
        t = torch.tensor([net.bad_step_count], dtype=torch.int64)
        rows = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(rows, t)
        return torch.cat(rows).numpy()

    for sharded in (False, True):
        key = f"guard/{'sharded' if sharded else 'repl'}"
        net = _net(init)
        net.set_fault_policy(FaultPolicy())
        with fault_injection([1]):
            (ParallelWrapper.builder(net).workers(world).sharded_update(sharded).build()
             .fit(ExistingDataSetIterator([ds]), epochs=3))
        save(key, net)
        out[f"{key}/bad_counts"] = bad_counts(net)
        out[f"{key}/good_count"] = np.int64(net.fault_state_["good_count"])

    net = _net(init)
    net.set_fault_policy(FaultPolicy())
    master = SharedTrainingMaster.builder(SHARED_THRESHOLD).build()
    it = ExistingDataSetIterator([ds])
    with fault_injection([1]):
        master.fit(net, it)
        before = (net.params_flat().copy(), master._residual.clone())
        master.fit(net, it)  # iteration 1: poisoned, skipped
        out["guard/master/params_kept"] = np.bool_(np.array_equal(before[0], net.params_flat()))
        out["guard/master/residual_kept"] = np.bool_(torch.equal(before[1], master._residual))
        master.fit(net, it)
    out["guard/master/bad_counts"] = bad_counts(net)
    out["guard/master/good_count"] = np.int64(net.fault_state_["good_count"])
    out["guard/master/finite"] = np.bool_(np.isfinite(net.params_flat()).all())
    out["guard/master/moved"] = np.bool_(not np.array_equal(before[0], net.params_flat()))
    return out


def _shared_cases(rank, world, root, init, save, CheckpointingIterator):
    """SharedTrainingMaster: TestSharedMasterSharded's network at
    SHARED_THRESHOLD, one epoch of the 32 blobs per fit, replicated and
    sharded, with every rank's work vector and message recorded at each
    step; the configuration's knob; bundled against single steps; a
    checkpoint in the middle of a sharded fit; the refusals; and
    TestSharedTrainingMaster's convergence and direction runs."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper,
        SharedTrainingMaster,
        TrainingMesh,
    )
    from deeplearning4j_tpu_torch.parallel import shared_training as st
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    out = {}
    ds = DataSet(*blobs())
    mesh = TrainingMesh(world, device="cpu")

    def gathered(t):
        rows = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(rows, t.contiguous())
        return torch.stack(rows).numpy()

    encode = st.threshold_encode
    for sharded in (False, True):
        key = f"shared/{'sharded' if sharded else 'repl'}"
        seen = []

        def recording(work, thr, cap):
            msg, residual = encode(work, thr, cap)
            seen.append((work.clone(), msg.indices.clone(), msg.count.clone()))
            return msg, residual

        st.threshold_encode = recording
        try:
            net = _net(init)
            master = (SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh)
                      .sharded_update(sharded).build())
            for step in range(SHARED_STEPS):
                master.fit(net, ExistingDataSetIterator([ds]))
                work, idx, count = seen[step]
                out[f"{key}/work{step}"] = gathered(work)
                out[f"{key}/indices{step}"] = gathered(idx)
                out[f"{key}/count{step}"] = gathered(count.reshape(1))
                out[f"{key}/residual{step}"] = gathered(master._residual)
        finally:
            st.threshold_encode = encode
        save(key, net)
        out[f"{key}/capacity"] = np.int64(master._capacity)
        out[f"{key}/residual_magnitude"] = np.float64(master.residual_magnitude())

    # the configuration's knob reaches a default-built master
    net = _net(init, sharded_knob=True)
    master = SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh).build()
    master.fit(net, ExistingDataSetIterator([ds]))
    out["shared/knob/on"] = np.bool_(master._layout is not None)
    save("shared/knob", net)

    # bundled (steps_per_call 2) against single steps, replicated and
    # sharded: five batches of 8 an epoch, 2 epochs
    for sharded in (False, True):
        for k in (1, 2):
            net = _net(init, steps=k)
            master = (SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh)
                      .sharded_update(sharded).build())
            master.fit(net, ExistingDataSetIterator(
                [DataSet(x, y) for x, y in bundle_batches()]), epochs=2)
            key = f"shared/bundle/{'sharded' if sharded else 'repl'}/k{k}"
            save(key, net)
            out[f"{key}/residual"] = master._residual.numpy()

    # a checkpoint written in the middle of a sharded fit holds the
    # gathered updater state of its iteration
    net = _net(init)
    mid = os.path.join(root, f"shared_mid{rank}.zip")
    master = (SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh)
              .sharded_update(True).build())
    master.fit(net, CheckpointingIterator(net, 2, mid, [ds] * SHARED_STEPS))
    out["shared/midfit/hook_cleared"] = np.bool_(getattr(net, "_opt_state_sync", None) is None)
    save("shared/midfit", ModelSerializer.restore_multi_layer_network(mid, device="cpu"))

    # refusals: a model with layer state, a second model, a batch that does
    # not divide by the ranks
    def refused(fn, match):
        try:
            fn()
        except ValueError as e:
            return match in str(e)
        return False

    master = SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh).build()
    out["shared/refuses/stateful"] = np.bool_(refused(
        lambda: master.fit(_net(init, bn=True), ExistingDataSetIterator([ds])),
        "does not propagate layer state"))
    master.fit(_net(init), ExistingDataSetIterator([ds]))
    out["shared/refuses/second_model"] = np.bool_(refused(
        lambda: master.fit(_net(init), ExistingDataSetIterator([ds])), "bound to its first"))
    odd = DataSet(*blobs(4 * world + 1, seed=6))
    out["shared/refuses/indivisible"] = np.bool_(refused(
        lambda: SharedTrainingMaster.builder(SHARED_THRESHOLD).mesh(mesh).build().fit(
            _net(init), ExistingDataSetIterator([odd])), "not divisible"))

    # TestSharedTrainingMaster: convergence (Sgd(1.0), threshold 0.02,
    # capacity 512, 60 fits of 64 rows) and the accumulated update's
    # direction against the replicated wrapper (Sgd(0.05), threshold 0.005,
    # capacity = every param, 20 fits of 32 rows)
    def behaviour_net(seed, lr):
        import deeplearning4j_tpu_torch.nn.conf as conf
        from deeplearning4j_tpu_torch import updaters as upd
        from deeplearning4j_tpu_torch.nn.conf import layers

        c = (conf.NeuralNetConfiguration.builder().seed(seed).updater(upd.Sgd(lr))
             .weight_init("xavier").list()
             .layer(layers.DenseLayer(n_out=16, activation="tanh"))
             .layer(layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(conf.InputType.feed_forward(5)).build())
        return MultiLayerNetwork(c).init(device="cpu")

    net = behaviour_net(3, 1.0)
    master = (SharedTrainingMaster.builder(threshold=0.02).update_capacity(512)
              .mesh(mesh).build())
    data = DataSet(*clusters())
    scores = []
    for _ in range(60):
        master.fit(net, ExistingDataSetIterator([data]))
        scores.append(net.score())
    out["shared/converge/scores"] = np.asarray(scores, np.float64)
    out["shared/converge/residual_magnitude"] = np.float64(master.residual_magnitude())

    data = DataSet(*clusters(n=32, seed=5))
    exact, comp = behaviour_net(9, 0.05), behaviour_net(9, 0.05)
    start = exact.params_flat().copy()
    pw = ParallelWrapper(exact, mesh=mesh)
    master = (SharedTrainingMaster.builder(threshold=0.005)
              .update_capacity(comp.num_params()).mesh(mesh).build())
    for _ in range(20):
        pw.fit(ExistingDataSetIterator([data]))
        master.fit(comp, ExistingDataSetIterator([data]))
    out["shared/direction/exact"] = exact.params_flat() - start
    out["shared/direction/compressed"] = comp.params_flat() - start
    return out
