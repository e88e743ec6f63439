"""Early stopping of the port against the JAX package's, on the CPU.

JAX's ``EarlyStoppingTrainer`` and the port's run on the same data from the
same weights (carried as arrays) under each termination condition; the
results are held to JAX's: the termination reason and details and
``best_model_epoch`` exactly, the best score and the score of every epoch
within 1e-6 relative. The best model restores (in memory and from its zip)
with the params of the epoch it was saved at. The score calculators match
JAX's on one model; ``EarlyStoppingParallelTrainer`` over a one-rank
``ParallelWrapper`` gives the trainer's result.
"""

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu import updaters as jupd
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.train import earlystopping as jes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import updaters as tupd
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator as TExisting
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh
from deeplearning4j_tpu_torch.train import earlystopping as tes

SCORE_TOL = 1e-6
JAX = (jconf, jlayers, jupd)
PORT = (tconf, tlayers, tupd)


def mlp(pkg, lr=0.05, out="softmax", loss="mcxent", n_out=3):
    conf, layers, upd = pkg
    return (conf.NeuralNetConfiguration.builder().seed(3).updater(upd.Adam(lr)).list()
            .layer(layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_out=n_out, activation=out, loss=loss))
            .set_input_type(conf.InputType.feed_forward(5)).build())


def pair(**kw):
    jnet, tnet = JNet(mlp(JAX, **kw)).init(), TNet(mlp(PORT, **kw)).init(device="cpu")
    interop.load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_),
                            jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def data(n=3, b=8, seed=0, classes=3):
    """Blobs around three centers (learnable, so scores fall then level)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, 5)) * 2
    out = []
    for _ in range(n):
        cls = rng.integers(0, classes, b)
        x = (centers[cls] + rng.standard_normal((b, 5))).astype(np.float32)
        out.append((x, np.eye(classes, dtype=np.float32)[cls]))
    return out


def its(batches):
    return (JExisting([JDataSet(x, y) for x, y in batches]),
            TExisting([TDataSet(x, y) for x, y in batches]))


def run_both(epoch_conds, iter_conds=(), saver=None, train=None, lr=0.05, tmp=None):
    """The same early-stopping run in both packages; returns the results
    and the port's model."""
    jnet, tnet = pair(lr=lr)
    train = train if train is not None else data()
    jtrain, ttrain = its(train)
    jval, tval = its(data(2, seed=7))
    results = []
    for es, net, tr, val, pkg in ((jes, jnet, jtrain, jval, "jax"),
                                  (tes, tnet, ttrain, tval, "port")):
        saver_obj = (es.LocalFileModelSaver(str(tmp / pkg)) if saver == "file"
                     else es.InMemoryModelSaver())
        cfg = (es.EarlyStoppingConfiguration.Builder()
               .score_calculator(es.DataSetLossCalculator(val))
               .epoch_termination_conditions(*epoch_conds(es))
               .iteration_termination_conditions(*iter_conds(es) if iter_conds else ())
               .model_saver(saver_obj).save_last_model(True).build())
        results.append(es.EarlyStoppingTrainer(cfg, net, tr).fit())
    return results[0], results[1], tnet


def assert_result(mine, theirs):
    assert mine.termination_reason == theirs.termination_reason
    assert mine.termination_details == theirs.termination_details
    assert mine.best_model_epoch == theirs.best_model_epoch
    assert mine.total_epochs == theirs.total_epochs
    assert sorted(mine.score_vs_epoch) == sorted(theirs.score_vs_epoch)
    for e in theirs.score_vs_epoch:
        assert mine.score_vs_epoch[e] == pytest.approx(theirs.score_vs_epoch[e], rel=SCORE_TOL)
    if np.isnan(theirs.best_model_score):
        assert np.isnan(mine.best_model_score)
    else:
        assert mine.best_model_score == pytest.approx(theirs.best_model_score, rel=SCORE_TOL)


# ------------------------------------------------------------ conditions
CONDITIONS = {
    "max_epochs": (lambda es: [es.MaxEpochsTerminationCondition(4)], None),
    "score_improvement": (lambda es: [es.MaxEpochsTerminationCondition(40),
                                      es.ScoreImprovementEpochTerminationCondition(2, 1e-3)],
                          None),
    "best_score": (lambda es: [es.MaxEpochsTerminationCondition(30),
                               es.BestScoreEpochTerminationCondition(0.3)], None),
    "max_score_iteration": (lambda es: [es.MaxEpochsTerminationCondition(5)],
                            lambda es: [es.MaxScoreIterationTerminationCondition(0.9)]),
    "max_time": (lambda es: [es.MaxEpochsTerminationCondition(5)],
                 lambda es: [es.MaxTimeIterationTerminationCondition(0.0)]),
    "invalid_score": (lambda es: [es.MaxEpochsTerminationCondition(5)],
                      lambda es: [es.InvalidScoreIterationTerminationCondition()]),
}


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_trainer_matches_jax(name, tmp_path):
    epoch_conds, iter_conds = CONDITIONS[name]
    train = data()
    if name == "invalid_score":
        train[1] = (np.full_like(train[1][0], np.nan), train[1][1])
    theirs, mine, tnet = run_both(epoch_conds, iter_conds, train=train)
    assert_result(mine, theirs)
    expected = {"max_epochs": "EpochTerminationCondition",
                "score_improvement": "EpochTerminationCondition",
                "best_score": "EpochTerminationCondition",
                "max_score_iteration": "IterationTerminationCondition",
                "max_time": "IterationTerminationCondition",
                "invalid_score": "IterationTerminationCondition"}[name]
    assert mine.termination_reason == expected
    assert tnet.listeners == []


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_best_model_restores(saver, tmp_path):
    """The best model (saved at ``best_model_epoch``) scores its recorded
    score again; from a zip it restores on the model's device; the latest
    model is the trained one."""
    theirs, mine, tnet = run_both(CONDITIONS["score_improvement"][0], saver=saver,
                                  tmp=tmp_path)
    assert_result(mine, theirs)
    best = mine.get_best_model()
    assert best is not tnet and best.device == tnet.device
    val = tes.DataSetLossCalculator(TExisting([TDataSet(x, y) for x, y in data(2, seed=7)]))
    assert val.calculate_score(best) == pytest.approx(mine.best_model_score, rel=SCORE_TOL)
    np.testing.assert_allclose(best.params_flat(), theirs.get_best_model().params_flat(),
                               rtol=0, atol=1e-5)
    if saver == "file":
        latest = tes.LocalFileModelSaver(str(tmp_path / "port"))
        latest._device = tnet.device
        np.testing.assert_array_equal(latest.get_latest_model().params_flat(),
                                      tnet.params_flat())


def test_parallel_trainer_equals_the_trainer():
    batches = data()
    results = []
    for parallel in (False, True):
        _, net = pair()
        val = TExisting([TDataSet(x, y) for x, y in data(2, seed=7)])
        cfg = (tes.EarlyStoppingConfiguration.Builder()
               .score_calculator(tes.DataSetLossCalculator(val))
               .epoch_termination_conditions(tes.MaxEpochsTerminationCondition(4),
                                             tes.ScoreImprovementEpochTerminationCondition(2))
               .build())
        train = TExisting([TDataSet(x, y) for x, y in batches])
        trainer = (tes.EarlyStoppingParallelTrainer(
            cfg, net, train, wrapper=ParallelWrapper(net, mesh=TrainingMesh(1, device="cpu")))
            if parallel else tes.EarlyStoppingTrainer(cfg, net, train))
        results.append((trainer.fit(), net))
    (a, na), (b, nb) = results
    assert a.termination_reason == b.termination_reason
    assert a.best_model_epoch == b.best_model_epoch
    assert a.score_vs_epoch == b.score_vs_epoch
    np.testing.assert_array_equal(na.params_flat(), nb.params_flat())


# ----------------------------------------------------------- calculators
def test_score_calculators_match_jax():
    jnet, tnet = pair()
    val = data(2, seed=7)
    for make in (lambda es, it: es.DataSetLossCalculator(it),
                 lambda es, it: es.DataSetLossCalculator(it, average=False),
                 lambda es, it: es.ClassificationScoreCalculator("accuracy", it),
                 lambda es, it: es.ClassificationScoreCalculator("f1", it)):
        jit, tit = its(val)
        theirs, mine = make(jes, jit), make(tes, tit)
        assert mine.minimize_score == theirs.minimize_score
        assert mine.calculate_score(tnet) == pytest.approx(theirs.calculate_score(jnet),
                                                           rel=SCORE_TOL)
        assert mine.calculate_score(tnet) == mine.calculate_score(tnet)
    jr, tr = pair(out="identity", loss="mse")
    jit, tit = its(val)
    for metric in ("mse", "mae"):
        assert tes.RegressionScoreCalculator(metric, tit).calculate_score(tr) == pytest.approx(
            jes.RegressionScoreCalculator(metric, jit).calculate_score(jr), rel=SCORE_TOL)
    with pytest.raises(ValueError, match="Unknown regression metric"):
        tes.RegressionScoreCalculator("r2", tit).calculate_score(tr)
    jb, tb = pair(out="sigmoid", loss="xent", n_out=1)
    rng = np.random.default_rng(2)
    bin_val = [(x, rng.integers(0, 2, (len(x), 1)).astype(np.float32)) for x, _ in val]
    jit, tit = its(bin_val)
    for metric in ("auc", "auprc"):
        assert tes.ROCScoreCalculator(tit, metric).calculate_score(tb) == pytest.approx(
            jes.ROCScoreCalculator(jit, metric).calculate_score(jb), rel=SCORE_TOL)


def _pretrain_pair(pkg_layer):
    def conf(pkg):
        c, layers, upd = pkg
        return (c.NeuralNetConfiguration.builder().seed(2).updater(upd.Adam(0.01)).list()
                .layer(pkg_layer(layers))
                .layer(layers.OutputLayer(n_out=2, activation="softmax"))
                .set_input_type(c.InputType.feed_forward(6)).build())

    jnet, tnet = JNet(conf(JAX)).init(), TNet(conf(PORT)).init(device="cpu")
    interop.load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_),
                            jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def test_pretrain_layer_calculators_match_jax():
    """The AutoEncoder's reconstruction error (mse, mae) and the VAE's
    (the mean of p(x|z) at the mean of q(z|x)) match JAX's; the VAE's
    reconstruction log-probability is finite and maximized."""
    rng = np.random.default_rng(5)
    val = [(rng.uniform(0, 1, (6, 6)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]) for _ in range(2)]
    ja, ta = _pretrain_pair(lambda L: L.AutoEncoder(n_out=4, activation="sigmoid"))
    jv, tv = _pretrain_pair(lambda L: L.VariationalAutoencoder(
        n_out=2, encoder_layer_sizes=(4,), decoder_layer_sizes=(4,), activation="tanh"))
    for metric in ("mse", "mae"):
        for cls, (jnet, tnet) in (("AutoencoderScoreCalculator", (ja, ta)),
                                  ("VAEReconErrorScoreCalculator", (jv, tv))):
            jit, tit = its(val)
            mine = getattr(tes, cls)(metric, tit, 0).calculate_score(tnet)
            theirs = getattr(jes, cls)(metric, jit, 0).calculate_score(jnet)
            assert mine == pytest.approx(theirs, rel=1e-5), (cls, metric)
    calc = tes.VAEReconProbScoreCalculator(its(val)[1], 0, num_samples=2)
    assert not calc.minimize_score and np.isfinite(calc.calculate_score(tv))
