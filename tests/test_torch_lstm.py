"""The port's LSTM cell, recurrent layers and TextGenerationLSTM against the
JAX package on the CPU.

- Cell: the port's plain cell (``reference_lstm_cell``) equals JAX's
  reference cell within 1e-6 in f32 (f32 matmul order), and JAX's Pallas
  kernel run in interpret mode within that kernel's own probe tolerances,
  1e-5 in f32 and 2e-2 in bf16 (``fused_lstm.py:314``). The interpret leg
  is not a bit-exact oracle on this host (it differs from JAX's reference by
  ~1e-6), so the port is held to the reference, and to the interpret leg
  only at the probe's tolerance. With bf16 ``x`` and weights and f32
  carries (the compute-dtype flow) both promote to f32: within 1e-2 (a bf16
  product's rounding).
- Layers and networks, weights carried from JAX with ``load_jax_params``
  (never by seed): f32 outputs within 1e-5, with and without masks; int8
  ``RnnOutputLayer`` within 1e-5; under ``compute_dtype="bfloat16"`` within
  twice JAX's own bf16-vs-f32 distance.
- ``lstm_adam_v1.zip`` restored by the port matches its golden at atol 1e-6,
  the reference's own bound (``test_regression_format.py:52-57``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.models.textgen_lstm import TextGenerationLSTM as JTextGen
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import preprocessors as jprep
from deeplearning4j_tpu.nn.conf.builders import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.conf.builders import infer_preprocessor as j_infer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.ops import fused_lstm as jfl
from deeplearning4j_tpu.nn.ops.int8_matmul import quantize_layer_params as jquant
from deeplearning4j_tpu.train.model_serializer import ModelSerializer as JSer
from deeplearning4j_tpu.updaters import RmsProp as JRmsProp
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.interop import export_params, load_jax_params
from deeplearning4j_tpu_torch.models import ZOO, TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tprep
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.builders import infer_preprocessor as t_infer
from deeplearning4j_tpu_torch.nn.conf.serde import encode
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.ops import fused_lstm as tfl
from deeplearning4j_tpu_torch.nn.ops.int8_matmul import quantize_layer_params as tquant
from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer
from tests.torch_mln_pairs import numpy_tree

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regression")
J = (jconf, jlayers)
T = (tconf, tlayers)


# ---------------------------------------------------------------------- cell
def _cell_args(b, n_in, n, peephole, seed):
    rng = np.random.default_rng(seed)

    def mk(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = [mk((b, n_in)), mk((b, n), 0.5), mk((b, n)), mk((n_in, 4 * n), (n_in + n) ** -0.5),
            mk((n, 4 * n), (2 * n) ** -0.5), mk((4 * n,), 0.2)]
    if peephole:
        args += [mk((n,), 0.3) for _ in range(3)]
    return args


def _torch(args, dtypes):
    return [torch.from_numpy(a).to(dt) for a, dt in zip(args, dtypes)]


def _jax(args, dtypes):
    return [jnp.asarray(a).astype(dt) for a, dt in zip(args, dtypes)]


CELL_SHAPES = [(4, 8, 16), (3, 33, 100), (2, 77, 40)]


@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("b,n_in,n", CELL_SHAPES)
def test_plain_cell_matches_jax_reference_f32(b, n_in, n, peephole):
    args = _cell_args(b, n_in, n, peephole, seed=b * 100 + n)
    h, c = tfl.reference_lstm_cell(*_torch(args, [torch.float32] * len(args)))
    hj, cj = jfl.reference_lstm_cell(*[jnp.asarray(a) for a in args])
    assert h.dtype == c.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("peephole", [False, True])
def test_plain_cell_matches_the_pallas_kernel_in_interpret_mode(peephole, dtype):
    """The ragged case (B 3, n_in 33, n 100) against ``fused_lstm_cell(...,
    interpret=True)`` at the probe's tolerance."""
    args = _cell_args(3, 33, 100, peephole, seed=7)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    h, c = tfl.fused_lstm_cell(*_torch(args, [tdt] * len(args)))
    hj, cj = jfl.fused_lstm_cell(*_jax(args, [jdt] * len(args)), interpret=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert h.dtype == tdt
    for a, b_ in ((h, hj), (c, cj)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b_, np.float32),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("peephole", [False, True])
def test_mixed_dtypes_promote_like_jax(peephole):
    """bf16 x and weights with f32 carries: the compute-dtype flow of the
    reference (``_init_carries`` gives f32 carries) computes in f32."""
    args = _cell_args(4, 12, 24, peephole, seed=3)
    dts = [torch.bfloat16, torch.float32, torch.float32] + [torch.bfloat16] * (len(args) - 3)
    jdts = [jnp.bfloat16, jnp.float32, jnp.float32] + [jnp.bfloat16] * (len(args) - 3)
    h, c = tfl.fused_lstm_cell(*_torch(args, dts))
    hj, cj = jfl.reference_lstm_cell(*_jax(args, jdts))
    assert h.dtype == c.dtype == torch.float32 and hj.dtype == jnp.float32
    assert tfl.output_dtype(*_torch(args[:2], dts[:2]), _torch(args[3:4], dts[3:4])[0]) \
        == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=1e-2)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-2)


def test_cell_for_routes_like_the_reference():
    """Only a tanh/sigmoid cell qualifies (``fused_lstm.py:340-342``); a
    GravesLSTM takes the peepholes, a plain LSTM none."""
    g = tlayers.GravesLSTM(n_in=3, n_out=4, activation="tanh")
    plain = tlayers.LSTM(n_in=3, n_out=4, activation="tanh")
    assert tfl.cell_for(tlayers.LSTM(n_in=3, n_out=4, activation="relu")) is None
    assert tfl.cell_for(tlayers.GravesLSTM(n_in=3, n_out=4, activation="tanh",
                                           gate_activation="relu")) is None
    args = _torch(_cell_args(2, 3, 4, True, seed=1), [torch.float32] * 9)
    h, _ = tfl.cell_for(g)(*args)
    assert torch.equal(h, tfl.reference_lstm_cell(*args)[0])
    with pytest.raises(ValueError, match="needs peepholes"):
        tfl.cell_for(g)(*args[:6])
    with pytest.raises(ValueError, match="takes no peepholes"):
        tfl.cell_for(plain)(*args)


# ------------------------------------------------ the kernel's host side
# The CUDA kernel runs only on the card (tests/test_torch_cuda.py); its
# plan, its routes and the wrapper's checks are host code, held here.
# (B, n_in, n): TextGenerationLSTM's two cells at the prefill row and the
# decode batches, batches past one row tile, the ragged card case, a narrow
# cell, a long depth, a wide batch, one hidden unit
TILE_SHAPES = ([(b, n_in, 256) for n_in in (77, 256) for b in (1, 8, 32, 33, 64, 65)]
               + [(3, 33, 100), (4, 8, 16), (1, 1200, 256), (1000, 77, 256), (5, 3, 1)])


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("w_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n_in,n", TILE_SHAPES, ids=[f"{b}x{i}x{n}" for b, i, n in TILE_SHAPES])
def test_lstm_tiles_cover_n_and_b(b, n_in, n, w_bf16, sms):
    """A tile the kernel has (4 units only with f32 weights), a grid that
    covers the hidden units and the rows with no block wholly past them,
    stages that cover n_in and n, and one wave of blocks whenever some tile
    fits one."""
    t = tfl.lstm_tiles(b, n_in, n, w_bf16, sms)
    units = tfl.UNITS_BF16 if w_bf16 else tfl.UNITS_F32
    assert t.units in units and t.rows in tfl.ROWS
    gx, gy = -(-n // t.units), -(-b // t.rows)
    assert (gx - 1) * t.units < n <= gx * t.units
    assert (gy - 1) * t.rows < b <= gy * t.rows
    assert (t.x_stages - 1) * t.depth < n_in <= t.x_stages * t.depth
    assert (t.h_stages - 1) * t.depth < n <= t.h_stages * t.depth
    fits = any(-(-n // u) * -(-b // r) <= sms for u in units for r in tfl.ROWS)
    assert (gx * gy <= sms) == fits


@pytest.mark.parametrize("n_in,n", [(77, 256), (256, 256), (33, 100), (1200, 256), (8, 16)])
def test_lstm_tiles_split_the_depth_the_same_way_for_every_batch_and_tile(n_in, n):
    """The depth split (stage depth, x and h stages, each warp's depths)
    depends on n_in and n alone: the same at every batch, for either
    weight type and SM count, whichever tile the batch gets."""
    plans = [tfl.lstm_tiles(b, n_in, n, w, sms) for b in range(1, 131)
             for w in (False, True) for sms in (132, 1)]
    assert {p[2:] for p in plans} == {(tfl.STAGE_DEPTH, -(-n_in // tfl.STAGE_DEPTH),
                                       -(-n // tfl.STAGE_DEPTH),
                                       tfl.STAGE_DEPTH // tfl.DEPTH_WARPS)}
    assert len({p[:2] for p in plans}) > 2  # the tiles do change with the batch


@pytest.mark.parametrize("n_in", [77, 256])
def test_lstm_tiles_fill_about_one_wave_at_textgens_shapes(n_in):
    """On 132 SMs: every 4-unit slice of n 256 at B 1 and 8 (64 blocks, the
    most without splitting the depth across blocks), 128 blocks of 8 units
    at B 32 and 64; bf16 weights (8 units) 32, 32, 128 and 128."""
    f32 = {b: tfl.lstm_tiles(b, n_in, 256, False, 132)[:2] for b in (1, 8, 32, 64)}
    bf16 = {b: tfl.lstm_tiles(b, n_in, 256, True, 132)[:2] for b in (1, 8, 32, 64)}
    assert f32 == {1: (4, 8), 8: (4, 8), 32: (8, 8), 64: (8, 16)}
    assert bf16 == {1: (8, 8), 8: (8, 8), 32: (8, 8), 64: (8, 16)}
    for plans in (f32, bf16):
        assert [-(-256 // u) * -(-b // r) for b, (u, r) in plans.items()] == \
            ([64, 64, 128, 128] if plans is f32 else [32, 32, 128, 128])


@pytest.mark.parametrize("row_bytes,address,route", [
    (1024, 0, tfl.ROUTE_WIDE), (512, 4096, tfl.ROUTE_WIDE), (400, 512, tfl.ROUTE_WIDE),
    (200, 0, tfl.ROUTE_WORDS), (308, 0, tfl.ROUTE_WORDS), (1024, 4, tfl.ROUTE_WORDS),
    (1024, 8, tfl.ROUTE_WORDS), (20, 12, tfl.ROUTE_WORDS),
    (154, 0, tfl.ROUTE_ELEMENTS), (66, 0, tfl.ROUTE_ELEMENTS), (1024, 2, tfl.ROUTE_ELEMENTS),
    (2, 0, tfl.ROUTE_ELEMENTS)])
def test_lstm_route_follows_the_row_length_and_the_base(row_bytes, address, route):
    """An operand goes by TMA (the weights) or 16-byte copies (x, h) only
    where every row starts on a 16-byte boundary: n 256 in f32 or bf16, n
    100 in f32; by 4-byte cp.async where they start on 4-byte ones: n 100
    in bf16, n_in 77 in f32, a base 4 or 8 bytes off; else element by
    element: n_in 77 or n 33 in bf16, a base 2 bytes off."""
    assert tfl.lstm_route(row_bytes, address) == route


def _stub_kernel(monkeypatch, sms=132):
    """The kernel route on "meta" tensors with the library and the launch
    stubbed, the wrapper's checks run but for the last, the device type:
    returns the argument tuples the C entry would get."""
    import contextlib

    calls = []
    check = tfl.check_kernel_args

    def checks_but_the_device(op, x, specs):
        try:
            check(op, x, specs)
        except ValueError as e:  # the last check: "meta" is not CUDA
            if "CUDA tensors" not in str(e):
                raise
        else:
            raise AssertionError("a meta tensor passed the device check")

    monkeypatch.setattr(tfl._LIB, "get", lambda: type("H", (), {"dl4j_fused_lstm_cell": None})())
    monkeypatch.setattr(tfl, "launch", lambda fn, op, args: calls.append(args))
    monkeypatch.setattr(tfl, "check_kernel_args", checks_but_the_device)
    monkeypatch.setattr(tfl, "sm_count", lambda index: sms)
    monkeypatch.setattr(tfl.torch.cuda, "device", lambda d: contextlib.nullcontext())
    return calls


def _meta_cell(b, n_in, n, peephole, dtypes):
    tx, tw, ts = dtypes
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device="meta")  # noqa: E731
    args = [z((b, n_in), tx), z((b, n), ts), z((b, n), ts), z((n_in, 4 * n), tw),
            z((n, 4 * n), tw), z((4 * n,), tw)]
    return args, ([z((n,), tw) for _ in range(3)] if peephole else None)


META_DTYPES = {"f32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3,
               "mixed": (torch.bfloat16, torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("dt", sorted(META_DTYPES))
@pytest.mark.parametrize("n_in,n", [(77, 256), (256, 256), (33, 100)], ids=["77", "256", "33x100"])
def test_kernel_route_plans_the_same_depth_split_for_every_batch(monkeypatch, n_in, n, dt,
                                                                  peephole):
    """At B 1, 8, 32, 33, 64 and 65 the wrapper checks the operands, hands
    the kernel the planner's tile (whose depth split is the same at every
    B), the routes of the operands' row lengths (a "meta" tensor's base is
    0), the type flags, and outputs of the reference's promotion."""
    calls = _stub_kernel(monkeypatch)
    tx, tw, ts = META_DTYPES[dt]
    splits = set()
    for b in (1, 8, 32, 33, 64, 65):
        args, peeps = _meta_cell(b, n_in, n, peephole, META_DTYPES[dt])
        h, c = tfl._kernel(*args, peeps)
        odt = torch.bfloat16 if dt == "bf16" else torch.float32
        assert h.shape == c.shape == (b, n) and h.dtype == c.dtype == odt
        ints = calls[-1][11:]
        assert len(calls[-1]) == 11 + 12
        bk, ik, nk, xb, wb, sb, pe, units, rows, w_route, x_route, h_route = ints
        assert (bk, ik, nk, pe) == (b, n_in, n, int(peephole))
        assert (xb, wb, sb) == tuple(int(t == torch.bfloat16) for t in (tx, tw, ts))
        plan = tfl.lstm_tiles(b, n_in, n, tw == torch.bfloat16, 132)
        assert (units, rows) == plan[:2]
        assert (w_route, x_route, h_route) == (
            tfl.lstm_route(n * args[3].element_size(), 0),
            tfl.lstm_route(n_in * args[0].element_size(), 0),
            tfl.lstm_route(n * args[1].element_size(), 0))
        splits.add(plan[2:])
    assert len(splits) == 1


def test_kernel_route_refuses_what_it_does_not_take(monkeypatch):
    """On "meta" tensors the wrapper refuses f16, carries of two types, a
    wrong shape, a strided view and n_in 0 before it launches anything."""
    calls = _stub_kernel(monkeypatch)
    args, peeps = _meta_cell(4, 8, 16, True, META_DTYPES["f32"])
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfl._kernel(args[0].half(), *args[1:], peeps)
    with pytest.raises(TypeError):
        tfl._kernel(args[0], args[1], args[2].bfloat16(), *args[3:], peeps)
    with pytest.raises(ValueError, match="shape"):
        tfl._kernel(args[0], args[1], args[2], args[3][:7], args[4], args[5], peeps)
    with pytest.raises(ValueError, match="contiguous"):
        tfl._kernel(torch.zeros(8, 4, device="meta").t(), *args[1:], peeps)
    with pytest.raises(ValueError, match="n_in >= 1"):
        empty, _ = _meta_cell(4, 0, 16, False, META_DTYPES["f32"])
        tfl._kernel(*empty, None)
    assert calls == []


def test_serve_profile_groups_the_kernels_by_their_current_names():
    """``scripts/torch_serve_profile.py`` puts the LSTM cell's and the int8
    matmul's kernels, as the profiler names them, in their own groups, not
    in "other"."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_serve_profile.py")
    spec = importlib.util.spec_from_file_location("torch_serve_profile", path)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    names = {
        "void (anonymous namespace)::lstm_cell_kernel_sm90<float, float, float, 4, 2>"
        "(CUtensorMap, CUtensorMap, (anonymous namespace)::Args)": "fused LSTM cell kernels",
        "void (anonymous namespace)::int8_planes_kernel<float, 3>(float const*, "
        "__nv_bfloat16*, int, int, int)": "int8_matmul kernels",
        "void (anonymous namespace)::int8_matmul_kernel_sm90<3>(CUtensorMap, CUtensorMap, "
        "(anonymous namespace)::Args)": "int8_matmul kernels",
        "void (anonymous namespace)::int8_reduce_kernel<float>(float const*, float const*, "
        "float*, int, int, int)": "int8_matmul kernels",
    }
    for name, group in names.items():
        out = prof.groups([{"name": name, "device_us": 1.0}])
        assert out[group] == 1.0 and out["other"] == 0.0, name


# -------------------------------------------------------------------- layers
def _net(pkg, body, n_in=5, head="rnn", compute_dtype=None):
    """``body`` (a function of the layer module) on recurrent input of
    ``n_in``, then a softmax head: per-timestep (``rnn``), a feed-forward
    output layer (``ff``), or an RnnLossLayer (``loss``)."""
    conf, layers = pkg
    b = conf.NeuralNetConfiguration.builder().seed(11)
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    b = b.list()
    for layer in body(layers):
        b = b.layer(layer)
    if head == "rnn":
        b = b.layer(layers.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"))
    elif head == "ff":
        b = b.layer(layers.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
    else:
        b = b.layer(layers.RnnLossLayer(loss="mcxent", activation="softmax"))
    return b.set_input_type(conf.InputType.recurrent(n_in)).build()


def _perturb(params, seed):
    """Give peepholes and biases seeded values (JAX inits them to 0/1), so
    every term of the cell is live."""
    rng = np.random.default_rng(seed)

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("pI", "pF", "pO", "b"):
                d[k] = (np.asarray(v) + rng.standard_normal(v.shape) * 0.3).astype(np.float32)

    for p in params:
        walk(p)
    return params


def _pair(body, head="rnn", compute_dtype=None, n_in=5):
    jnet = JNet(_net(J, body, n_in, head, compute_dtype)).init()
    params = _perturb(numpy_tree(jnet.params_), seed=5)
    jnet.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TNet(_net(T, body, n_in, head, compute_dtype)).init(device="cpu")
    load_jax_params(tnet, params, numpy_tree(jnet.state_))
    return jnet, tnet


def _seq(b=3, t=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[0, 5:] = 0.0
    mask[-1, 2:] = 0.0
    return x, mask


BODIES = {
    "lstm": lambda L: [L.LSTM(n_out=6)],
    "graves_lstm": lambda L: [L.GravesLSTM(n_out=6, activation="tanh")],
    "graves_x2": lambda L: [L.GravesLSTM(n_out=6), L.GravesLSTM(n_out=5)],
    "lstm_relu": lambda L: [L.LSTM(n_out=6, activation="relu")],
    "simple_rnn": lambda L: [L.SimpleRnn(n_out=6)],
    "bidir_concat": lambda L: [L.Bidirectional(L.LSTM(n_out=6), mode="concat")],
    "bidir_add": lambda L: [L.Bidirectional(L.GravesLSTM(n_out=6), mode="add")],
    "bidir_mul": lambda L: [L.Bidirectional(L.LSTM(n_out=6), mode="mul")],
    "bidir_ave": lambda L: [L.Bidirectional(L.SimpleRnn(n_out=6), mode="ave")],
    "graves_bidir": lambda L: [L.GravesBidirectionalLSTM(n_out=5)],
    "mask_zero": lambda L: [L.MaskZeroLayer(L.LSTM(n_out=6), masking_value=0.5)],
    "dense_per_step": lambda L: [L.LSTM(n_out=6), L.DenseLayer(n_out=7, activation="relu")],
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_recurrent_network_matches_jax(name, masked):
    jnet, tnet = _pair(BODIES[name])
    x, mask = _seq(seed=len(name))
    m = mask if masked else None
    y = tnet.output(x, mask=m)
    yj = np.asarray(jnet.output(x, mask=m))
    assert y.shape == yj.shape == (3, 7, 4)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)
    if masked:
        assert np.all(y[2, 2:] == 0)  # masked steps output zeros


FF_BODIES = {
    "last_step": lambda L: [L.LastTimeStep(L.LSTM(n_out=6))],
    "last_step_graves": lambda L: [L.LastTimeStep(L.GravesLSTM(n_out=6))],
    "pool_max": lambda L: [L.LSTM(n_out=6), L.GlobalPoolingLayer(pooling_type="max")],
    "pool_avg": lambda L: [L.LSTM(n_out=6), L.GlobalPoolingLayer(pooling_type="avg")],
    "pool_sum": lambda L: [L.LSTM(n_out=6), L.GlobalPoolingLayer(pooling_type="sum")],
    "pool_pnorm": lambda L: [L.LSTM(n_out=6), L.GlobalPoolingLayer(pooling_type="pnorm",
                                                                   pnorm=3)],
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(FF_BODIES))
def test_sequence_to_vector_layers_match_jax(name, masked):
    jnet, tnet = _pair(FF_BODIES[name], head="ff")
    x, mask = _seq(seed=3)
    m = mask if masked else None
    y = tnet.output(x, mask=m)
    yj = np.asarray(jnet.output(x, mask=m))
    assert y.shape == yj.shape == (3, 4)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_rnn_loss_layer_head_matches_jax(masked):
    jnet, tnet = _pair(lambda L: [L.LSTM(n_out=6)], head="loss")
    x, mask = _seq(seed=4)
    m = mask if masked else None
    np.testing.assert_allclose(tnet.output(x, mask=m), np.asarray(jnet.output(x, mask=m)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_int8_rnn_output_layer_matches_jax(masked):
    """The head on int8 params (``W_q8``/``W_scale``), rank-3 input, through
    ``serving_matmul``: the same quantized arrays as JAX's, the same answer."""
    jl = jlayers.RnnOutputLayer(n_in=6, n_out=4, activation="softmax")
    tl = tlayers.RnnOutputLayer(n_in=6, n_out=4, activation="softmax")
    rng = np.random.default_rng(9)
    p = {"W": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    jq = jquant({k: jnp.asarray(v) for k, v in p.items()})
    tq = tquant({k: torch.from_numpy(v) for k, v in p.items()})
    assert set(tq) == set(jq) == {"W_q8", "W_scale", "b"}
    np.testing.assert_array_equal(tq["W_q8"].numpy(), np.asarray(jq["W_q8"]))
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    mask = _seq()[1] if masked else None
    y, _ = tl.apply(tq, torch.from_numpy(x),
                    mask=None if mask is None else torch.from_numpy(mask))
    yj, _ = jl.apply(jq, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_bf16_compute_matches_jax_within_its_own_bf16_noise():
    """Unmasked: under compute_dtype JAX's masked scan refuses its own
    promoted carry (bf16 carries, an f32 mask: ``lax.scan`` carry type
    mismatch), so there is no masked bf16 oracle."""
    jnet, tnet = _pair(BODIES["graves_x2"], compute_dtype="bfloat16")
    _, tnet32 = _pair(BODIES["graves_x2"])
    x, _ = _seq(seed=8)
    got, want = tnet.output(x), np.asarray(jnet.output(x))
    noise = float(np.abs(want - tnet32.output(x)).max())
    assert got.dtype == np.float32 and noise > 0
    assert float(np.abs(got - want).max()) <= 2 * noise


def test_rnn_time_step_in_chunks_equals_the_full_output():
    _, tnet = _pair(BODIES["graves_x2"])
    x, _ = _seq(b=2, t=9, seed=6)
    full = tnet.output(x)
    parts = [tnet.rnn_time_step(x[:, :4]), tnet.rnn_time_step(x[:, 4:5]),
             tnet.rnn_time_step(x[:, 5, :])[:, None, :]]
    state = tnet.rnn_get_previous_state()
    parts.append(tnet.rnn_time_step(x[:, 6:]))
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full, rtol=0, atol=1e-6)
    # a saved state resumes the stream
    tnet.rnn_set_previous_state(state)
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, 6:]), full[:, 6:], rtol=0, atol=1e-6)
    tnet.rnn_clear_previous_state()
    assert tnet.rnn_get_previous_state() is None
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :4]), full[:, :4], rtol=0, atol=1e-6)


def test_rnn_time_step_matches_jax():
    jnet, tnet = _pair(BODIES["lstm"])
    x, _ = _seq(seed=2)
    for sl in (slice(0, 3), slice(3, 4), slice(4, 7)):
        np.testing.assert_allclose(tnet.rnn_time_step(x[:, sl]),
                                   np.asarray(jnet.rnn_time_step(x[:, sl])), rtol=0, atol=1e-5)
    ts, js = tnet.rnn_get_previous_state(), jnet.rnn_get_previous_state()
    np.testing.assert_allclose(ts[0][1], np.asarray(js[0][1]), rtol=0, atol=1e-5)


# ------------------------------------------------------------- preprocessors
def test_preprocessors_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32)
    for t_p, j_p, arg in ((tprep.RnnToFeedForwardPreProcessor(),
                           jprep.RnnToFeedForwardPreProcessor(), x),
                          (tprep.FeedForwardToRnnPreProcessor(4),
                           jprep.FeedForwardToRnnPreProcessor(4), x.reshape(12, 5))):
        np.testing.assert_array_equal(t_p.pre_process(torch.from_numpy(arg)).numpy(),
                                      np.asarray(j_p.pre_process(jnp.asarray(arg))))
        tm, jm = t_p.feed_forward_mask(torch.from_numpy(mask)), j_p.feed_forward_mask(mask)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert encode(t_p) == jconf.serde.encode(j_p)
        it = tconf.InputType.recurrent(5, 4) if "Rnn" == type(t_p).__name__[:3] \
            else tconf.InputType.feed_forward(5)
        jt = jconf.InputType.from_dict(it.to_dict())
        assert t_p.get_output_type(it).to_dict() == j_p.get_output_type(jt).to_dict()
    with pytest.raises(ValueError, match="timesteps"):
        tprep.FeedForwardToRnnPreProcessor().pre_process(torch.zeros(4, 5))


def test_preprocessor_inference_matches_jax():
    for kind in ("recurrent", "feedforward"):
        for name, kw in (("DenseLayer", {"n_out": 3}), ("OutputLayer", {"n_out": 3}),
                         ("LSTM", {"n_out": 3}), ("RnnOutputLayer", {"n_out": 3})):
            it_t = (tconf.InputType.recurrent(5) if kind == "recurrent"
                    else tconf.InputType.feed_forward(5))
            it_j = jconf.InputType.from_dict(it_t.to_dict())
            outcomes = []
            for infer, layer, it in ((t_infer, getattr(tlayers, name)(**kw), it_t),
                                     (j_infer, getattr(jlayers, name)(**kw), it_j)):
                try:
                    p = infer(it, layer)
                    outcomes.append(None if p is None else type(p).__name__)
                except ValueError:
                    outcomes.append("ValueError")
            assert outcomes[0] == outcomes[1], (kind, name, outcomes)


# ---------------------------------------------------- configuration, the zoo
def test_textgen_conf_json_loads_in_both_directions():
    j, t = JTextGen().conf(), TextGenerationLSTM().conf()
    assert t.to_dict() == j.to_dict()
    assert t.backprop_type == "tbptt" and t.tbptt_fwd_length == t.tbptt_back_length == 40
    from_jax, from_port = TConf.from_json(j.to_json()), JConf.from_json(t.to_json())
    assert from_jax == t and from_jax.to_json() == j.to_json()
    assert from_port == j and from_port.to_json() == t.to_json()
    assert "textgenlstm" in ZOO and TextGenerationLSTM.serving_seq_buckets == (8, 16, 32, 64)
    assert encode(tupd.RmsProp(1e-2)) == jconf.serde.encode(JRmsProp(1e-2))


@pytest.mark.parametrize("name", ["bidir_add", "graves_bidir", "mask_zero"])
def test_wrapper_conf_json_loads_in_both_directions(name):
    j, t = _net(J, BODIES[name]), _net(T, BODIES[name])
    assert t.to_dict() == j.to_dict()
    assert TConf.from_json(j.to_json()) == t and JConf.from_json(t.to_json()) == j


def test_training_surfaces_refuse():
    """Nothing refuses any more: the recurrent head's score is JAX's (with
    its label mask), and a fit on per-timestep labels takes one step whose
    score is that score's mean plus nothing (no regularization)."""
    jnet, tnet = _pair(BODIES["lstm"])
    x, mask = _seq()
    rng = np.random.default_rng(4)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, x.shape[:2])]
    h = rng.standard_normal((3, 7, 6)).astype(np.float32)
    mine = tnet.layers[-1].compute_score(tnet.params_[-1], torch.from_numpy(h),
                                         torch.from_numpy(y), torch.from_numpy(mask))
    theirs = jnet.layers[-1].compute_score(jnet.params_[-1], jnp.asarray(h), jnp.asarray(y),
                                           jnp.asarray(mask))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
    tnet.fit(x, y)
    assert tnet.iteration == 1 and np.isfinite(tnet.score())
    # RmsProp, the TextGen configuration's updater, now trains: its update
    # is the reference's
    g = torch.tensor([0.5, -2.0])
    mine, slots = tupd.RmsProp(1e-2).apply(g, {"r": torch.zeros(2)}, 1, 0, 0)
    theirs, jslots = JRmsProp(1e-2).apply(jnp.asarray(g.numpy()), {"r": jnp.zeros(2)}, 1, 0, 0)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6)
    np.testing.assert_allclose(slots["r"].numpy(), np.asarray(jslots["r"]), rtol=1e-6)
    assert set(tupd.RmsProp().init_state(torch.zeros(3))) == {"r"}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_narrow_textgen_output_matches_jax(masked):
    jnet = JTextGen(num_classes=12, units=16).init()
    params = _perturb(numpy_tree(jnet.params_), seed=2)
    jnet.params_ = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TextGenerationLSTM(num_classes=12, units=16).init(device="cpu")
    load_jax_params(tnet, params, numpy_tree(jnet.state_))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, (4, 10))
    x = np.eye(12, dtype=np.float32)[ids]
    mask = (np.arange(10)[None, :] < np.array([[10], [3], [7], [1]])).astype(np.float32)
    m = mask if masked else None
    np.testing.assert_allclose(tnet.output(x, mask=m), np.asarray(jnet.output(x, mask=m)),
                               rtol=0, atol=1e-5)
    exported = export_params(tnet)
    for mine, theirs in zip(exported, params):
        assert set(mine) == set(theirs) == ({"Wx", "Wh", "b", "pI", "pF", "pO"}
                                            if "pI" in theirs else {"W", "b"})
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])


# ---------------------------------------------------------------- checkpoints
def test_lstm_regression_fixture_matches_its_golden():
    path = os.path.join(FIXTURES, "lstm_adam_v1.zip")
    net = ModelSerializer.restore_multi_layer_network(path, load_updater=False, device="cpu")
    g = np.load(os.path.join(FIXTURES, "lstm_adam_v1_golden.npz"))
    assert [type(layer).__name__ for layer in net.layers] == ["LSTM", "RnnOutputLayer"]
    np.testing.assert_allclose(net.output(g["x"]), g["y"], atol=1e-6)


def test_recurrent_zips_both_ways(tmp_path):
    jnet, tnet = _pair(BODIES["graves_x2"])
    x, mask = _seq(seed=12)
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(tnet, path)
    back = JSer.restore_multi_layer_network(path)
    np.testing.assert_allclose(np.asarray(back.output(x, mask=mask)), tnet.output(x, mask=mask),
                               rtol=0, atol=1e-6)
    jpath = str(tmp_path / "jax.zip")
    JSer.write_model(jnet, jpath)
    mine = ModelSerializer.restore_multi_layer_network(jpath, device="cpu")
    np.testing.assert_allclose(mine.output(x, mask=mask), np.asarray(jnet.output(x, mask=mask)),
                               rtol=0, atol=1e-5)


def test_bidirectional_zip_round_trips_in_the_port(tmp_path):
    """Nested ``fwd``/``bwd`` params flatten in sorted order, depth first
    (the reference's flat vector cannot hold nested dicts)."""
    _, tnet = _pair(BODIES["bidir_concat"])
    path = str(tmp_path / "bidir.zip")
    ModelSerializer.write_model(tnet, path)
    back = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    x, mask = _seq(seed=13)
    np.testing.assert_array_equal(back.output(x, mask=mask), tnet.output(x, mask=mask))
    assert back.num_params() == tnet.num_params() == sum(
        a.size for p in export_params(tnet) for d in p.values()
        for a in (d.values() if isinstance(d, dict) else [d]))
    assert json.loads(back.conf.to_json()) == json.loads(tnet.conf.to_json())
