"""The port's ``evaluation/`` against the JAX package's, on the CPU.

Each class of both packages is fed the same seeded labels, outputs and
masks (per-example, time series with a (b, T) mask, one and two columns),
in one call and in two calls merged into a third instance, and every
figure both give is compared, ``stats()`` included: counts exactly, floats
exactly or within 1e-12 where a float sum's order could differ (both are
numpy on the host, so none was seen to). The port's ``eval`` also takes
torch tensors (bf16 widened to f32) and gives what the same numpy arrays
give.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import evaluation as jev
from deeplearning4j_tpu_torch import evaluation as tev

FLOAT_TOL = 1e-12
B, T, C = 48, 5, 4


def _probs(rng, shape):
    z = rng.standard_normal(shape) * 2.0
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _one_hot(rng, shape, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, shape)]


def inputs(kind: str, masked: bool, seed: int = 0):
    """(labels, predictions, mask) of one kind of output."""
    rng = np.random.default_rng(seed)
    if kind == "classes":
        y, p, m = _one_hot(rng, B, C), _probs(rng, (B, C)), rng.random(B) < 0.8
    elif kind == "time_series":
        y, p, m = _one_hot(rng, (B, T), C), _probs(rng, (B, T, C)), rng.random((B, T)) < 0.7
    elif kind == "index_labels":
        y, p, m = rng.integers(0, C, (B, 1)).astype(np.float32), _probs(rng, (B, C)), \
            rng.random(B) < 0.8
    elif kind == "sigmoid":
        y = rng.integers(0, 2, (B, 1)).astype(np.float32)
        p, m = rng.random((B, 1)).astype(np.float32), rng.random(B) < 0.8
    elif kind == "two_columns":
        y, p, m = _one_hot(rng, B, 2), _probs(rng, (B, 2)), rng.random(B) < 0.8
    elif kind == "multilabel":
        y = (rng.random((B, C)) < 0.4).astype(np.float32)
        p, m = rng.random((B, C)).astype(np.float32), rng.random(B) < 0.8
    elif kind == "multilabel_series":
        y = (rng.random((B, T, C)) < 0.4).astype(np.float32)
        p, m = rng.random((B, T, C)).astype(np.float32), rng.random((B, T)) < 0.7
    elif kind == "regression":
        y = rng.standard_normal((B, C))
        p, m = (y + 0.3 * rng.standard_normal((B, C))).astype(np.float32), None
        y = y.astype(np.float32)
    elif kind == "regression_series":
        y = rng.standard_normal((B, T, C))
        p = (y + 0.3 * rng.standard_normal((B, T, C))).astype(np.float32)
        y, m = y.astype(np.float32), rng.random((B, T)) < 0.7
    else:
        raise KeyError(kind)
    return y, p, (m.astype(np.float32) if masked and m is not None else None)


def fed(make, kind, masked, merge, convert=lambda a: a):
    """An instance of ``make()`` fed the inputs of ``kind``: in one call,
    or (``merge``) the first and second halves of the rows into two
    instances, the second merged into the first."""
    y, p, m = inputs(kind, masked)
    if not merge:
        ev = make()
        ev.eval(convert(y), convert(p), mask=None if m is None else convert(m))
        return ev
    h = B // 2
    a, b = make(), make()
    a.eval(convert(y[:h]), convert(p[:h]), mask=None if m is None else convert(m[:h]))
    b.eval(convert(y[h:]), convert(p[h:]), mask=None if m is None else convert(m[h:]))
    a.merge(b)
    return a


def assert_same(mine, theirs, what=""):
    """Two figures equal: strings and ints exactly, floats and arrays
    within FLOAT_TOL (NaN where the other is NaN)."""
    if isinstance(theirs, str):
        assert mine == theirs, what
    elif isinstance(theirs, (tuple, list)):
        assert len(mine) == len(theirs), what
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert_same(a, b, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(mine, np.float64), np.asarray(theirs, np.float64),
                                   rtol=0, atol=FLOAT_TOL, err_msg=what)
        assert np.asarray(mine).shape == np.asarray(theirs).shape, what


def _classification_figures(ev, n):
    figs = {"matrix": ev.confusion.matrix, "accuracy": ev.accuracy(),
            "top_n_accuracy": ev.top_n_accuracy(), "tp": ev.true_positives(),
            "fp": ev.false_positives(), "fn": ev.false_negatives(), "stats": ev.stats(),
            "num_classes": ev.num_classes}
    for avg in ("macro", "micro"):
        figs[f"precision/{avg}"] = ev.precision(averaging=avg)
        figs[f"recall/{avg}"] = ev.recall(averaging=avg)
        figs[f"f1/{avg}"] = ev.f1(averaging=avg)
    for c in range(n):
        figs[f"precision/{c}"] = ev.precision(c)
        figs[f"recall/{c}"] = ev.recall(c)
        figs[f"f1/{c}"] = ev.f1(c)
        figs[f"count/{c}"] = ev.confusion.get_count(c, (c + 1) % n)
    return figs


CLASSIFICATION_KINDS = ["classes", "time_series", "index_labels", "sigmoid", "two_columns"]


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("kind", CLASSIFICATION_KINDS)
def test_evaluation_matches_jax(kind, top_n, masked, merge):
    if kind in ("sigmoid", "two_columns") and top_n > 2:
        top_n = 2
    mine = fed(lambda: tev.Evaluation(top_n=top_n), kind, masked, merge)
    theirs = fed(lambda: jev.Evaluation(top_n=top_n), kind, masked, merge)
    n = theirs.confusion.matrix.shape[0]
    fm, ft = _classification_figures(mine, n), _classification_figures(theirs, n)
    assert fm.keys() == ft.keys()
    for k in ft:
        assert_same(fm[k], ft[k], k)
    assert mine.confusion.matrix.dtype == theirs.confusion.matrix.dtype


def test_evaluation_labels_and_recorded_predictions_match_jax():
    """Label names in ``stats()``, per-example metadata and the recorded
    predictions' getters, merged."""
    y, p, _ = inputs("classes", False, seed=3)
    names = ["cat", "dog", "eel", "fox"]
    out = []
    for pkg in (tev, jev):
        a, b = pkg.Evaluation(labels=names), pkg.Evaluation(labels=names)
        a.eval(y[:20], p[:20], record_meta_data=list(range(20)))
        b.eval(y[20:], p[20:], record_meta_data=list(range(20, B)))
        a.merge(b)
        out.append((a.stats(), [repr(q) for q in a.get_prediction_errors()],
                    [repr(q) for q in a.get_predictions_by_actual_class(2)],
                    [repr(q) for q in a.get_predictions_by_predicted_class(1)]))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="record_meta_data"):
        tev.Evaluation().eval(y, p, record_meta_data=[1, 2])


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(5)
    actual, predicted = rng.integers(0, 6, 200), rng.integers(0, 6, 200)
    mats = []
    for pkg in (tev, jev):
        a, b = pkg.ConfusionMatrix(6), pkg.ConfusionMatrix(6)
        a.add(actual[:90], predicted[:90])
        b.add(actual[90:], predicted[90:])
        a.merge(b)
        mats.append((a.matrix, str(a), a.get_count(3, 4)))
    np.testing.assert_array_equal(mats[0][0], mats[1][0])
    assert mats[0][1:] == mats[1][1:]


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", ["multilabel", "multilabel_series"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluation_binary_matches_jax(threshold, kind, masked, merge):
    if kind == "multilabel" and masked:
        masked = False  # the reference masks time series only
    mine = fed(lambda: tev.EvaluationBinary(decision_threshold=threshold), kind, masked, merge)
    theirs = fed(lambda: jev.EvaluationBinary(decision_threshold=threshold), kind, masked,
                 merge)
    for attr in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(mine, attr), getattr(theirs, attr))
    for i in range(C):
        for fig in ("accuracy", "precision", "recall", "f1"):
            assert_same(getattr(mine, fig)(i), getattr(theirs, fig)(i), f"{fig}/{i}")
    assert mine.stats() == theirs.stats()


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("bins", [(10, 50), (7, 13)])
def test_evaluation_calibration_matches_jax(bins, masked, merge):
    mine = fed(lambda: tev.EvaluationCalibration(*bins), "classes", masked, merge)
    theirs = fed(lambda: jev.EvaluationCalibration(*bins), "classes", masked, merge)
    for attr in ("bin_counts", "bin_pos", "bin_prob_sum", "residual_hist", "prob_hist"):
        assert_same(getattr(mine, attr), getattr(theirs, attr), attr)
    for c in range(C):
        assert_same(mine.reliability_curve(c), theirs.reliability_curve(c), f"curve/{c}")
        assert_same(mine.expected_calibration_error(c), theirs.expected_calibration_error(c))


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("kind,masked", [("regression", False),
                                         ("regression_series", False),
                                         ("regression_series", True)])
def test_regression_evaluation_matches_jax(kind, masked, merge):
    mine = fed(tev.RegressionEvaluation, kind, masked, merge)
    theirs = fed(jev.RegressionEvaluation, kind, masked, merge)
    for c in range(C):
        for fig in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                    "r_squared", "pearson_correlation"):
            assert_same(getattr(mine, fig)(c), getattr(theirs, fig)(c), f"{fig}/{c}")
    assert_same(mine.average_mean_squared_error(), theirs.average_mean_squared_error())
    assert_same(mine.average_mean_absolute_error(), theirs.average_mean_absolute_error())
    np.testing.assert_array_equal(mine.count, theirs.count)
    assert mine.stats() == theirs.stats()


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", ["sigmoid", "two_columns"])
@pytest.mark.parametrize("steps", [0, 10])
def test_roc_matches_jax(steps, kind, masked, merge):
    mine = fed(lambda: tev.ROC(steps), kind, masked, merge)
    theirs = fed(lambda: jev.ROC(steps), kind, masked, merge)
    assert_same(mine.calculate_auc(), theirs.calculate_auc(), "auc")
    assert_same(mine.calculate_auprc(), theirs.calculate_auprc(), "auprc")
    if steps == 0:
        assert_same(mine.get_roc_curve(), theirs.get_roc_curve(), "roc curve")
        assert_same(mine.get_precision_recall_curve(), theirs.get_precision_recall_curve())
    else:
        with pytest.raises(ValueError, match="exact mode"):
            mine.get_roc_curve()


@pytest.mark.parametrize("merge", [False, True], ids=["one", "merged"])
@pytest.mark.parametrize("cls", ["ROCMultiClass", "ROCBinary"])
@pytest.mark.parametrize("steps", [0, 10])
def test_roc_multi_class_and_binary_match_jax(steps, cls, merge):
    kind = "classes" if cls == "ROCMultiClass" else "multilabel"
    mine = fed(lambda: getattr(tev, cls)(steps), kind, False, merge)
    theirs = fed(lambda: getattr(jev, cls)(steps), kind, False, merge)
    for c in range(C):
        assert_same(mine.calculate_auc(c), theirs.calculate_auc(c), f"auc/{c}")
    assert_same(mine.calculate_average_auc(), theirs.calculate_average_auc())


def test_roc_refuses_to_merge_other_modes_as_jax():
    with pytest.raises(ValueError, match="threshold modes"):
        tev.ROC(0).merge(tev.ROC(5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_takes_torch_tensors(dtype):
    """Tensors give what the same numpy arrays give (bf16 outputs widened to
    f32 first, as the networks hand them over)."""
    y, p, m = inputs("time_series", True, seed=7)
    pt = torch.from_numpy(p).to(dtype)
    p_np = pt.float().numpy()
    for make in (tev.Evaluation, tev.RegressionEvaluation, tev.EvaluationBinary):
        a, b = make(), make()
        a.eval(torch.from_numpy(y), pt, mask=torch.from_numpy(m))
        b.eval(y, p_np, mask=m)
        assert a.stats() == b.stats()
    a, b = tev.ROC(), tev.ROC()
    a.eval(torch.from_numpy(y[:, 0, :2]), pt[:, 0, :2])
    b.eval(y[:, 0, :2], p_np[:, 0, :2])
    assert a.calculate_auc() == b.calculate_auc()
