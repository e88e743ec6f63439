"""The layers the rest of the zoo needs, against the JAX package on the CPU.

Each layer of the port and of JAX is built by the same constructor call; the
same seeded inputs (numpy) go through both, in and out of train mode, and
the gradients of ``sum(y * r)`` (``r`` a seeded cotangent) with respect to
the input and the params are compared too. Tolerance: 1e-5 of the largest
magnitude (f32) for outputs and gradients (``TOL``).

- LocalResponseNormalization; SubsamplingLayer max, avg and pnorm in
  truncate (with padding) and same modes, odd sizes and strides (XLA's
  asymmetric "same" pads), and pnorm's gradient at an all-zero window;
  SpaceToDepthLayer (its channel order exactly).
- LossLayer and CnnLossLayer (scores with and without a mask).
- Yolo2OutputLayer: ``apply``, ``compute_score`` with and without a
  per-example mask, ties of the responsible box, decoding
  (``get_predicted_objects``) and ``non_max_suppression``.
- CenterLossOutputLayer: the score with and without centers,
  ``update_centers`` (classes present and absent).
- Each layer's configuration dict equals JAX's (the reference's
  ``@class`` names), and each decodes in the other package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import layers as J
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.layers import objdetect as jod
from deeplearning4j_tpu_torch.nn.conf import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import layers as T
from deeplearning4j_tpu_torch.nn.conf import serde as tserde

TOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1.0))


def _port_params(layer, itype):
    return {k: v for k, v in layer.init_params(torch.Generator().manual_seed(0), itype).items()}


def _compare(jl, tl, x, *, params=None, state=None, train=False, mask=None):
    """Forward and the gradients of sum(y * r) (x and params) of one layer in
    both packages."""
    params = params or {}
    state = state or {}

    def jf(p, a):
        y, _ = jl.apply(p, a, state={k: jnp.asarray(v) for k, v in state.items()},
                        train=train, mask=None if mask is None else jnp.asarray(mask))
        return y

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    r = _rand(jy.shape, 99)
    jgp, jgx = jax.jit(jax.grad(lambda p, a: jnp.sum(jf(p, a) * r), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = tl.apply(tp, tx, state={k: torch.tensor(v) for k, v in state.items()},
                     train=train, mask=None if mask is None else torch.tensor(mask))
    (ty * torch.from_numpy(r)).sum().backward()
    _close(ty.detach().numpy(), jy)
    _close(tx.grad.numpy(), np.asarray(jgx))
    for k in params:
        _close(tp[k].grad.numpy(), np.asarray(jgp[k]))
    return ty.detach().numpy()


def _json_both_ways(jl, tl):
    jd, td = jserde.encode(jl), tserde.encode(tl)
    assert json.loads(json.dumps(td)) == json.loads(json.dumps(jd))
    assert td["@class"] == type(jl).__name__
    assert tserde.decode(jd) == tl
    assert jserde.decode(td) == jl


# ------------------------------------------------------------ spatial layers
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [{}, {"k": 1.0, "n": 3, "alpha": 0.5, "beta": 0.5}],
                         ids=["defaults", "wide"])
def test_lrn(kw, train):
    jl, tl = J.LocalResponseNormalization(**kw), T.LocalResponseNormalization(**kw)
    _compare(jl, tl, _rand((2, 5, 4, 7), 1, scale=3.0), train=train)
    _json_both_ways(jl, tl)


POOLS = {
    "k2s2": dict(kernel_size=2, stride=2),
    "k3s2_truncate_pad1": dict(kernel_size=3, stride=2, padding=1),
    "k3s2_same": dict(kernel_size=3, stride=2, convolution_mode="same"),
    "k3s1_same": dict(kernel_size=3, stride=1, convolution_mode="same"),
    "k2x3s1x2_same": dict(kernel_size=(2, 3), stride=(1, 2), convolution_mode="same"),
    "k3s3_truncate_pad2x1": dict(kernel_size=3, stride=3, padding=(2, 1)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("ptype", ["max", "avg", "pnorm", "pnorm3"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_subsampling(pool, ptype, train):
    kw = dict(POOLS[pool], pooling_type=ptype.rstrip("3"))
    if ptype == "pnorm3":
        kw["pnorm"] = 3
    jl, tl = J.SubsamplingLayer(**kw), T.SubsamplingLayer(**kw)
    x = _rand((2, 7, 9, 3), 2)
    y = _compare(jl, tl, x, train=train)
    jt = jl.get_output_type(JInputType.convolutional(7, 9, 3))
    assert tl.get_output_type(TInputType.convolutional(7, 9, 3)).to_dict() == jt.to_dict()
    assert y.shape[1:3] == (jt.height, jt.width)
    _json_both_ways(jl, tl)


@pytest.mark.parametrize("p", [2, 3])
def test_pnorm_gradient_at_an_all_zero_window_is_jaxs(p):
    """A window of zeros: JAX's gradient there (0 ** (1/p - 1) times 0) is
    what the port's is, NaN where JAX's is NaN."""
    x = _rand((1, 4, 4, 2), 3)
    x[0, :2, :2, 0] = 0.0
    kw = dict(kernel_size=2, stride=2, pooling_type="pnorm", pnorm=p)
    jl, tl = J.SubsamplingLayer(**kw), T.SubsamplingLayer(**kw)
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jl.apply({}, a)[0]))(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    tl.apply({}, tx)[0].sum().backward()
    g = tx.grad.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(jg))
    assert np.isnan(jg[0, :2, :2, 0]).all() or not np.isnan(jg).any()
    ok = ~np.isnan(jg)
    _close(g[ok], jg[ok])


def test_unknown_pooling_type_raises_the_references_error():
    for L, arr in ((J, jnp.zeros((1, 2, 2, 1))), (T, torch.zeros((1, 2, 2, 1)))):
        with pytest.raises(ValueError, match="Unknown pooling type"):
            L.SubsamplingLayer(pooling_type="median").apply({}, arr)


@pytest.mark.parametrize("block", [2, 3])
def test_space_to_depth(block):
    jl, tl = J.SpaceToDepthLayer(block_size=block), T.SpaceToDepthLayer(block_size=block)
    x = _rand((2, 6, 12, 5), 4)
    y = _compare(jl, tl, x)
    # the channel order: (block row, block col, c)
    i, j = 1, block - 1
    assert y[1, 1, 2, (i * block + j) * 5 + 3] == x[1, block + i, 2 * block + j, 3]
    it = (JInputType.convolutional(6, 12, 5), TInputType.convolutional(6, 12, 5))
    assert tl.get_output_type(it[1]).to_dict() == jl.get_output_type(it[0]).to_dict()
    _json_both_ways(jl, tl)


# ---------------------------------------------------------------- loss heads
def _score_grads(jl, tl, x, labels, mask=None, params=None, state=None, jkw=None, tkw=None):
    """compute_score's per-example values and its sum's gradient (x and
    params) in both packages."""
    params = params or {}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = None if mask is None else jnp.asarray(mask)

    def jf(p, a):
        return jl.compute_score(p, a, jnp.asarray(labels), jm, **(jkw or {}))

    js = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    jgp, jgx = jax.jit(jax.grad(lambda p, a: jnp.sum(jf(p, a)), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ts = tl.compute_score(tp, tx, torch.tensor(labels),
                          None if mask is None else torch.tensor(mask), **(tkw or {}))
    ts.sum().backward()
    _close(ts.detach().numpy(), js)
    _close(tx.grad.numpy(), np.asarray(jgx))
    for k in params:
        _close(tp[k].grad.numpy(), np.asarray(jgp[k]))
    return ts.detach().numpy()


def _onehot(b, c, seed):
    return np.eye(c, dtype=np.float32)[np.random.default_rng(seed).integers(0, c, b)]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"), ("mse", "identity"),
                                      ("xent", "sigmoid")])
def test_loss_layer(loss, act, masked):
    jl, tl = J.LossLayer(loss=loss, activation=act), T.LossLayer(loss=loss, activation=act)
    x = _rand((5, 6), 5)
    labels = (_onehot(5, 6, 6) if loss != "mse" else _rand((5, 6), 6))
    mask = (np.random.default_rng(7).random((5, 1)) > 0.4).astype(np.float32) if masked else None
    _score_grads(jl, tl, x, labels, mask)
    for train in (False, True):
        _compare(jl, tl, x, train=train)
    _json_both_ways(jl, tl)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"), ("mse", "identity")])
def test_cnn_loss_layer(loss, act, masked):
    jl, tl = J.CnnLossLayer(loss=loss, activation=act), T.CnnLossLayer(loss=loss, activation=act)
    x = _rand((2, 3, 4, 5), 8)
    labels = (np.eye(5, dtype=np.float32)[np.random.default_rng(9).integers(0, 5, (2, 3, 4))]
              if loss == "mcxent" else _rand((2, 3, 4, 5), 9))
    mask = (np.random.default_rng(10).random((2, 3, 4)) > 0.3).astype(np.float32) \
        if masked else None
    _score_grads(jl, tl, x, labels, mask)
    _compare(jl, tl, x)
    _json_both_ways(jl, tl)


# ---------------------------------------------------------------------- YOLO
PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38]]


def _yolo_case(seed, h=3, w=4, c=2, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, len(PRIORS) * (5 + c))).astype(np.float32)
    labels = np.zeros((b, h, w, 4 + c), np.float32)
    for ex in range(b):
        for _ in range(2):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            x1, y1 = cx + rng.random() * 0.5, cy + rng.random() * 0.5
            labels[ex, cy, cx, :4] = [x1, y1, x1 + 0.3 + 2 * rng.random(),
                                      y1 + 0.3 + 2 * rng.random()]
            labels[ex, cy, cx, 4:] = 0
            labels[ex, cy, cx, 4 + rng.integers(0, c)] = 1
    return x, labels


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("seed", [0, 1])
def test_yolo2_score_and_gradient(seed, masked):
    kw = dict(bounding_box_priors=PRIORS, lambda_coord=4.0, lambda_no_obj=0.25)
    jl, tl = J.Yolo2OutputLayer(**kw), T.Yolo2OutputLayer(**kw)
    x, labels = _yolo_case(seed)
    mask = np.array([1.0, 0.0, 0.5], np.float32) if masked else None
    s = _score_grads(jl, tl, x, labels, mask)
    if masked:
        assert s[1] == 0.0
    _json_both_ways(jl, tl)
    it = (JInputType.convolutional(3, 4, 21), TInputType.convolutional(3, 4, 21))
    assert tl.get_output_type(it[1]).to_dict() == jl.get_output_type(it[0]).to_dict()


def test_yolo2_responsible_box_ties_go_to_the_first():
    """Equal predictions for every box: the IOUs tie and the first box is
    responsible in both packages (the scores and gradients agree)."""
    jl, tl = J.Yolo2OutputLayer(bounding_box_priors=[[1.0, 1.0]] * 3), \
        T.Yolo2OutputLayer(bounding_box_priors=[[1.0, 1.0]] * 3)
    x, labels = _yolo_case(2, b=2)
    x = np.tile(x[..., :7], (1, 1, 1, 3))
    _score_grads(jl, tl, x, labels)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_yolo2_apply_decode_and_nms(train):
    jl, tl = (L.Yolo2OutputLayer(bounding_box_priors=PRIORS) for L in (J, T))
    x, _ = _yolo_case(3, b=2)
    y = _compare(jl, tl, x, train=train)
    jobj = jl.get_predicted_objects(y, threshold=0.4)
    tobj = tl.get_predicted_objects(torch.from_numpy(y), threshold=0.4)
    assert len(tobj) == len(jobj) > 4
    for a, b in zip(tobj, jobj):
        assert (a.example, a.predicted_class) == (b.example, b.predicted_class)
        np.testing.assert_allclose([a.center_x, a.center_y, a.width, a.height, a.confidence],
                                   [b.center_x, b.center_y, b.width, b.height, b.confidence],
                                   rtol=1e-6)
        np.testing.assert_array_equal(a.class_probs, b.class_probs)
        assert T.iou(a, tobj[0]) == jod.iou(b, jobj[0])
    for thr in (0.1, 0.45, 0.9):
        kept_t = T.non_max_suppression(tobj, thr)
        kept_j = jod.non_max_suppression(jobj, thr)
        assert [repr(o) for o in kept_t] == [repr(o) for o in kept_j]
    assert len(T.non_max_suppression(tobj, 0.0)) <= len(T.non_max_suppression(tobj, 1.01))


def test_iou_and_nms_by_hand():
    a = T.DetectedObject(0, 1.0, 1.0, 2.0, 2.0, 3, 0.9)
    b = T.DetectedObject(0, 2.0, 1.0, 2.0, 2.0, 3, 0.8)
    c = T.DetectedObject(0, 2.0, 1.0, 2.0, 2.0, 1, 0.7)
    assert T.iou(a, b) == pytest.approx(2.0 / 6.0)
    assert T.iou(a, T.DetectedObject(0, 9.0, 9.0, 1.0, 1.0, 3, 0.1)) == 0.0
    assert a.top_left() == (0.0, 0.0) and a.bottom_right() == (2.0, 2.0)
    assert T.non_max_suppression([b, a, c], 0.3) == [a, c]
    assert T.non_max_suppression([b, a, c], 0.5) == [a, b, c]


# ------------------------------------------------------------- center loss
def _center_pair(**kw):
    kw = dict(n_in=6, n_out=4, activation="softmax", loss="mcxent", alpha=0.3, lambda_=0.5,
              **kw)
    jl, tl = J.CenterLossOutputLayer(**kw), T.CenterLossOutputLayer(**kw)
    for L in (jl, tl):
        L.weight_init, L.bias_init = "xavier", 0.1
    params = {k: v.numpy() for k, v in _port_params(tl, TInputType.feed_forward(6)).items()}
    return jl, tl, params


@pytest.mark.parametrize("with_centers", [False, True], ids=["plain", "centers"])
def test_center_loss_score_and_gradient(with_centers):
    jl, tl, params = _center_pair()
    x, labels = _rand((5, 6), 11), _onehot(5, 4, 12)
    centers = _rand((4, 6), 13)
    if with_centers:
        _score_grads(jl, tl, x, labels, params=params,
                     jkw={"state": {"centers": jnp.asarray(centers)}},
                     tkw={"state": {"centers": torch.from_numpy(centers)}})
    else:
        _score_grads(jl, tl, x, labels, params=params)
    for train in (False, True):
        _compare(jl, tl, x, params=params, state={"centers": centers}, train=train)
    st = tl.init_layer_state(TInputType.feed_forward(6))
    assert st["centers"].shape == (4, 6) and not st["centers"].any()
    _json_both_ways(jl, tl)


def test_center_loss_update_centers():
    """The EMA toward the batch's class means; a class absent from the
    batch keeps its center; the update is outside autograd."""
    jl, tl, _ = _center_pair()
    x = _rand((6, 6), 14)
    labels = np.eye(4, dtype=np.float32)[[0, 2, 2, 0, 0, 3]]  # class 1 absent
    centers = _rand((4, 6), 15)
    want = np.asarray(jl.update_centers({"centers": jnp.asarray(centers)}, jnp.asarray(x),
                                        jnp.asarray(labels))["centers"])
    tx = torch.tensor(x, requires_grad=True)
    got = tl.update_centers({"centers": torch.from_numpy(centers)}, tx,
                            torch.from_numpy(labels))["centers"]
    assert not got.requires_grad
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1], centers[1])
