"""The rank side of ``tests/test_torch_parallel.py``'s multi-process runs.

Each rank of a gloo group (``torch.multiprocessing`` spawn, a ``FileStore``
under the test's temporary directory) builds the port's networks from the
JAX package's initial params (carried as arrays in ``init.npz``), trains
them through ``ParallelWrapper`` and, on rank 0, writes what it got to
``out.npz`` for the test to hold against the JAX package's
``ParallelWrapper``. The networks and datasets are the ones of
``tests/test_sharded_update.py::TestWrapperParity``. Imports no JAX, and
holds no tests itself: its name keeps it among the port's test files.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

N_IN, N_HID, N_OUT = 5, 7, 3


def build(pkg, mixed_precision=False, sharded_knob=False, gradnorm=False, bn=False):
    """The TestWrapperParity network in ``pkg`` = (conf, layers, updaters)."""
    conf, layers, upd = pkg
    b = conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(0.01))
    if mixed_precision:
        b = b.compute_dtype("bfloat16")
    if sharded_knob:
        b = b.sharded_update(True)
    kw = {"gradient_normalization": "renormalize_l2_per_layer"} if gradnorm else {}
    b = b.list().layer(layers.DenseLayer(n_out=N_HID, activation="tanh", **kw))
    if bn:
        b = b.layer(layers.BatchNormalization())
    return (b.layer(layers.OutputLayer(n_out=N_OUT, activation="softmax", **kw))
            .set_input_type(conf.InputType.feed_forward(N_IN)).build())


def blobs(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, n)]
    return x, y


#: case -> the network options of its replicated and sharded runs
VARIANTS = {"f32": {}, "bf16": {"mixed_precision": True}, "gradnorm": {"gradnorm": True}}


def _port():
    import deeplearning4j_tpu_torch.nn.conf as tconf
    from deeplearning4j_tpu_torch import updaters as tupd
    from deeplearning4j_tpu_torch.nn.conf import layers as tlayers

    return tconf, tlayers, tupd


def _net(init, **opts):
    from deeplearning4j_tpu_torch.interop import load_jax_params
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(build(_port(), **opts)).init(device="cpu")
    params = [{k: init[f"p{i}/{k}"] for k in p} for i, p in enumerate(net.params_)]
    load_jax_params(net, params, [{} for _ in net.params_])
    return net


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
    from deeplearning4j_tpu_torch.parallel.wrapper import CrossRankBatchStatsError
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    init = dict(np.load(os.path.join(root, "init.npz")))
    ds = DataSet(*blobs())
    out = {}

    def save(key, net):
        out[f"{key}/params"] = net.params_flat()
        out[f"{key}/opt"] = net.opt_state_flat()
        out[f"{key}/score"] = np.float32(np.nan if net.score_ is None else net.score())
        out[f"{key}/iteration"] = np.int64(net.iteration)

    def fit(net, sharded, epochs, it=None):
        pw = ParallelWrapper.builder(net).workers(world).sharded_update(sharded).build()
        pw.fit(it if it is not None else ExistingDataSetIterator([ds]), epochs=epochs)
        return pw

    # replicated and sharded, 3 epochs of one batch (f32, bf16 compute,
    # gradient normalization); the padding of the flat groups
    for case, opts in VARIANTS.items():
        for sharded in (False, True):
            net = _net(init, **opts)
            pw = fit(net, sharded, 3)
            save(f"{case}/{'sharded' if sharded else 'repl'}", net)
            if sharded:
                out[f"{case}/n_padding"] = np.int64(pw._zlayout.n_padding())

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
        def __init__(self, net, at, path):
            super().__init__([ds])
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
    # to the rank count), replicated and sharded
    x, y = blobs(29, seed=4)
    for sharded in (False, True):
        net = _net(init)
        fit(net, sharded, 2, ListDataSetIterator(DataSet(x, y), 8))
        save(f"ragged/{'sharded' if sharded else 'repl'}", net)

    # batch statistics on several ranks are refused
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    bn = MultiLayerNetwork(build(_port(), bn=True)).init(device="cpu")
    try:
        fit(bn, False, 1)
        out["bn/refused"] = np.bool_(False)
    except CrossRankBatchStatsError:
        out["bn/refused"] = np.bool_(True)
    return out
