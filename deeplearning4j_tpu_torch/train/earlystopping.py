"""Early stopping: condition-driven training driver.

Counterpart of ``deeplearning4j_tpu/train/earlystopping.py``; the reference: ``deeplearning4j-nn/src/main/java/org/deeplearning4j/earlystopping/``
— ``EarlyStoppingConfiguration.java`` (builder holding saver, score
calculator, epoch/iteration termination conditions),
``trainer/BaseEarlyStoppingTrainer.java`` (the fit loop),
``scorecalc/*`` (DataSetLoss/Classification/Regression/ROC/Autoencoder/VAE
score calculators), ``termination/*`` (MaxEpochs, ScoreImprovement,
BestScore, MaxScoreIteration, MaxTime, InvalidScore), ``saver/*``
(InMemory, LocalFile), ``EarlyStoppingResult.java``.

Works for both MultiLayerNetwork and ComputationGraph (the reference has
separate EarlyStoppingTrainer/EarlyStoppingGraphTrainer; here one trainer
handles both since the model surface is shared). A model written by
``LocalFileModelSaver`` restores on the device the saved model was on.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------------
# Score calculators (reference scorecalc/*; minimizeScore semantics)
# --------------------------------------------------------------------------
class ScoreCalculator:
    """SPI: compute a model-selection score on held-out data
    (reference ``scorecalc/ScoreCalculator.java``)."""

    minimize_score = True

    def calculate_score(self, model) -> float:
        raise NotImplementedError

    @staticmethod
    def _fresh(iterator) -> None:
        """Rewind the evaluation iterator BEFORE consuming it. Every
        calculator must score from the start of its data on every call —
        repeat evaluation of one model has to be deterministic (the
        early-stopping loop and the tuner's rung scoring both call the
        same calculator many times, and a previous pass that died
        mid-iteration, or any outside partial consumption, would
        otherwise leave the next score computed over the tail only)."""
        reset_ok = getattr(iterator, "reset_supported", None)
        if callable(reset_ok) and not reset_ok():
            return
        reset = getattr(iterator, "reset", None)
        if callable(reset):
            reset()


class ScoreCalculatorObjective:
    """Adapter: a ScoreCalculator as a tuner objective (the reference's
    ``tune/runner.py`` rung scoring; ``tune/`` is ROADMAP § A8) — callable
    ``model -> float`` carrying the calculator's minimize/maximize
    direction."""

    def __init__(self, calculator: ScoreCalculator):
        self.calculator = calculator
        self.minimize = bool(calculator.minimize_score)

    def __call__(self, model) -> float:
        return float(self.calculator.calculate_score(model))

    def __repr__(self):
        return (f"ScoreCalculatorObjective({type(self.calculator).__name__},"
                f" minimize={self.minimize})")


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over an iterator (reference
    ``DataSetLossCalculator.java`` — also covers the CG variant)."""

    minimize_score = True

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        self._fresh(self.iterator)
        total, count = 0.0, 0
        for ds in self.iterator:
            n = ds.num_examples()
            total += model.score(ds) * n
            count += n
        self.iterator.reset()
        if count == 0:
            return float("nan")
        return total / count if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Maximize an Evaluation metric (accuracy/f1/...; reference
    ``ClassificationScoreCalculator.java``)."""

    minimize_score = False

    def __init__(self, metric: str, iterator):
        self.metric = metric.lower()
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        self._fresh(self.iterator)
        ev = model.evaluate(self.iterator)
        return float(getattr(ev, self.metric)())


class RegressionScoreCalculator(ScoreCalculator):
    """Minimize a RegressionEvaluation metric (reference
    ``RegressionScoreCalculator.java``)."""

    minimize_score = True

    def __init__(self, metric: str, iterator):
        self.metric = metric.lower()
        self.iterator = iterator

    _METRIC_METHODS = {
        "mse": "average_mean_squared_error",
        "mae": "average_mean_absolute_error",
        "mean_squared_error": "average_mean_squared_error",
        "mean_absolute_error": "average_mean_absolute_error",
    }

    def calculate_score(self, model) -> float:
        self._fresh(self.iterator)
        ev = model.evaluate_regression(self.iterator)
        method = self._METRIC_METHODS.get(self.metric)
        if method is None:
            raise ValueError(
                f"Unknown regression metric '{self.metric}'; "
                f"one of {sorted(self._METRIC_METHODS)}"
            )
        return float(getattr(ev, method)())


class ROCScoreCalculator(ScoreCalculator):
    """Maximize AUROC/AUPRC (reference ``ROCScoreCalculator.java``)."""

    minimize_score = False

    def __init__(self, iterator, metric: str = "auc"):
        self.iterator = iterator
        self.metric = metric.lower()

    def calculate_score(self, model) -> float:
        from deeplearning4j_tpu_torch.evaluation import ROC

        self._fresh(self.iterator)
        roc = ROC()
        for ds in self.iterator:
            out = model.output(ds.features)
            if isinstance(out, list):
                out = out[0]
            roc.eval(ds.labels, out)
        self.iterator.reset()
        return float(
            roc.calculate_auc() if self.metric == "auc" else roc.calculate_auprc()
        )


def _on(params, x: np.ndarray):
    """``x`` as a tensor on the device of the layer's ``params``, in their
    dtype."""
    import torch

    p = next(iter(params.values()))
    return torch.as_tensor(x).to(device=p.device, dtype=p.dtype)


def _host(t) -> np.ndarray:
    """A tensor's values on the host, as numpy."""
    return t.detach().float().cpu().numpy()


def _resolve_pretrain_layer(model, layer_index):
    """(layer, params) for ``layer_index`` on an MLN (int index) or a
    ComputationGraph (layer name str, or int index into layer_names) — the
    reference has MLN- and CG-specific calculators
    (``AutoencoderScoreCalculator.java`` handles both Model types)."""
    if hasattr(model, "layer_names"):  # ComputationGraph
        name = (model.layer_names[layer_index]
                if isinstance(layer_index, int) else layer_index)
        return model._layer(name), model.params_[name]
    return model.layers[layer_index], model.params_[layer_index]


class AutoencoderScoreCalculator(ScoreCalculator):
    """Reconstruction error of a pretrain layer — AutoEncoder or VAE, both
    expose ``reconstruct`` (reference ``AutoencoderScoreCalculator.java``).
    Works on MLN (int layer index) and CG (layer name or index)."""

    minimize_score = True

    def __init__(self, metric: str, iterator, layer_index=0):
        self.metric = metric.lower()
        self.iterator = iterator
        self.layer_index = layer_index

    def calculate_score(self, model) -> float:
        self._fresh(self.iterator)
        total, count = 0.0, 0
        layer, lparams = _resolve_pretrain_layer(model, self.layer_index)
        for ds in self.iterator:
            x = np.asarray(ds.features)
            recon = _host(layer.reconstruct(lparams, _on(lparams, x)))
            if self.metric == "mse":
                err = ((recon - x) ** 2).sum()
            else:  # mae
                err = np.abs(recon - x).sum()
            total += float(err)
            count += x.shape[0]
        self.iterator.reset()
        return total / max(count, 1)


class VAEReconErrorScoreCalculator(AutoencoderScoreCalculator):
    """Alias with reference-parity name (reference
    ``VAEReconErrorScoreCalculator.java``); same reconstruct-and-accumulate
    loop as AutoencoderScoreCalculator."""


class VAEReconProbScoreCalculator(ScoreCalculator):
    """VAE reconstruction log-probability, maximized (reference
    ``VAEReconProbScoreCalculator.java``)."""

    minimize_score = False

    def __init__(self, iterator, layer_index=0, num_samples: int = 1,
                 log_prob: bool = True):
        self.iterator = iterator
        self.layer_index = layer_index
        self.num_samples = num_samples
        self.log_prob = log_prob

    def calculate_score(self, model) -> float:
        self._fresh(self.iterator)
        total, count = 0.0, 0
        layer, lparams = _resolve_pretrain_layer(model, self.layer_index)
        for ds in self.iterator:
            x = np.asarray(ds.features)
            lp = _host(layer.reconstruction_log_probability(
                lparams, _on(lparams, x), self.num_samples))
            total += float(lp.sum())
            count += x.shape[0]
        self.iterator.reset()
        avg = total / max(count, 1)
        return avg if self.log_prob else math.exp(avg)


# --------------------------------------------------------------------------
# Termination conditions (reference termination/*)
# --------------------------------------------------------------------------
class EpochTerminationCondition:
    # score-dependent conditions are only checked on epochs where the score
    # calculator actually ran (reference BaseEarlyStoppingTrainer semantics);
    # pure epoch-count conditions check every epoch
    requires_score = True

    def initialize(self) -> None:
        pass

    def terminate(self, epoch_num: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch_num, score, minimize):
        return epoch_num + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when no improvement for N consecutive epochs (reference
    ``ScoreImprovementEpochTerminationCondition.java``)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.best_score: Optional[float] = None
        self.epochs_without = 0

    def initialize(self):
        self.best_score = None
        self.epochs_without = 0

    def terminate(self, epoch_num, score, minimize):
        if self.best_score is None:
            self.best_score = score
            return False
        improvement = (self.best_score - score) if minimize else (score - self.best_score)
        if improvement > self.min_improvement:
            self.best_score = score
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without >= self.patience

    def __str__(self):
        return (f"ScoreImprovementEpochTerminationCondition(patience={self.patience}, "
                f"minImprovement={self.min_improvement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as score is better than a target (reference
    ``BestScoreEpochTerminationCondition.java``)."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = float(best_expected_score)

    def terminate(self, epoch_num, score, minimize):
        return score < self.best_expected_score if minimize else score > self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop if score exceeds a ceiling — divergence guard (reference
    ``MaxScoreIterationTerminationCondition.java``)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, last_score):
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_time_seconds: float):
        self.max_time_seconds = float(max_time_seconds)
        self._start = None

    def initialize(self):
        # EarlyStoppingTrainer.fit() calls this BEFORE the first epoch, so
        # setup/jit-compile time ahead of iteration 1 counts against the
        # time budget (tests/test_fault_tolerance.py pins this down)
        self._start = time.monotonic()

    def terminate(self, last_score):
        if self._start is None:
            # standalone use without a trainer: fall back to first-call
            # arming (the trainer path never hits this)
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_time_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_time_seconds}s)"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


# --------------------------------------------------------------------------
# Model savers (reference saver/*)
# --------------------------------------------------------------------------
class EarlyStoppingModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, model, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.clone()

    def save_latest_model(self, model, score):
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Saves best/latest model zips in a directory (reference
    ``LocalFileModelSaver.java``; also covers the graph variant)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._model_cls = None
        self._device = None

    def _save(self, model, fname):
        from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

        self._model_cls = type(model)
        self._device = model.device
        ModelSerializer.write_model(model, os.path.join(self.directory, fname))

    def _load(self, fname):
        from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser

        path = os.path.join(self.directory, fname)
        if not os.path.exists(path):
            return None
        return ModelGuesser.load_model_guess(path, device=self._device)

    def save_best_model(self, model, score):
        self._save(model, "bestModel.bin")

    def save_latest_model(self, model, score):
        self._save(model, "latestModel.bin")

    def get_best_model(self):
        return self._load("bestModel.bin")

    def get_latest_model(self):
        return self._load("latestModel.bin")


# --------------------------------------------------------------------------
# Configuration + result (reference EarlyStoppingConfiguration/Result)
# --------------------------------------------------------------------------
class EarlyStoppingConfiguration:
    def __init__(
        self,
        score_calculator: ScoreCalculator,
        epoch_termination_conditions: Optional[List[EpochTerminationCondition]] = None,
        iteration_termination_conditions: Optional[List[IterationTerminationCondition]] = None,
        model_saver: Optional[EarlyStoppingModelSaver] = None,
        save_last_model: bool = False,
        evaluate_every_n_epochs: int = 1,
    ):
        self.score_calculator = score_calculator
        self.epoch_termination_conditions = list(epoch_termination_conditions or [])
        self.iteration_termination_conditions = list(iteration_termination_conditions or [])
        self.model_saver = model_saver if model_saver is not None else InMemoryModelSaver()
        self.save_last_model = save_last_model
        self.evaluate_every_n_epochs = int(evaluate_every_n_epochs)

    class Builder:
        def __init__(self):
            self._kw: Dict[str, Any] = {}

        def score_calculator(self, sc):
            self._kw["score_calculator"] = sc
            return self

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"] = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"] = list(conds)
            return self

        def model_saver(self, saver):
            self._kw["model_saver"] = saver
            return self

        def save_last_model(self, b: bool = True):
            self._kw["save_last_model"] = b
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._kw["evaluate_every_n_epochs"] = n
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return EarlyStoppingConfiguration(**self._kw)


class EarlyStoppingResult:
    """(reference ``EarlyStoppingResult.java``)."""

    def __init__(
        self,
        termination_reason: str,
        termination_details: str,
        score_vs_epoch: Dict[int, float],
        best_model_epoch: int,
        best_model_score: float,
        total_epochs: int,
        best_model,
    ):
        self.termination_reason = termination_reason  # "Error"|"IterationTerminationCondition"|"EpochTerminationCondition"
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model

    def __repr__(self):
        return (
            f"EarlyStoppingResult(reason={self.termination_reason}, "
            f"details={self.termination_details}, bestEpoch={self.best_model_epoch}, "
            f"bestScore={self.best_model_score}, totalEpochs={self.total_epochs})"
        )


# --------------------------------------------------------------------------
# Trainer (reference trainer/BaseEarlyStoppingTrainer.java fit loop)
# --------------------------------------------------------------------------
class _IterationConditionListener:
    """Hooks iteration termination conditions into the fit loop via the
    listener SPI (the reference checks them inside its own loop)."""

    def __init__(self, conditions: List[IterationTerminationCondition]):
        self.conditions = conditions
        self.triggered: Optional[IterationTerminationCondition] = None

    def iteration_done(self, model, iteration, epoch):
        # float(score_) is a host sync per iteration — only pay it when
        # there are conditions to check
        if self.triggered is not None or not self.conditions:
            return
        score = float(model.score_) if model.score_ is not None else float("nan")
        for c in self.conditions:
            if c.terminate(score):
                self.triggered = c
                raise _IterationTerminated(c, score)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


class _IterationTerminated(Exception):
    def __init__(self, condition, score):
        self.condition = condition
        self.score = score


class EarlyStoppingTrainer:
    """Drives training with early stopping (reference
    ``EarlyStoppingTrainer``/``EarlyStoppingGraphTrainer``)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator,
                 listener: Optional[Any] = None):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator
        self.listener = listener  # EarlyStoppingListener: on_start/on_epoch/on_completion

    def _fit_epoch(self) -> None:
        """One training epoch; overridden by the parallel trainer."""
        self.model._fit_one_epoch(self.train_iterator)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        sc = cfg.score_calculator
        minimize = sc.minimize_score
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        if self.listener is not None and hasattr(self.listener, "on_start"):
            self.listener.on_start(cfg, self.model)

        score_vs_epoch: Dict[int, float] = {}
        best_score = math.inf if minimize else -math.inf
        best_epoch = -1
        epoch = 0

        saved_listeners = list(self.model.listeners)
        if cfg.iteration_termination_conditions:
            self.model.add_listeners(
                _IterationConditionListener(cfg.iteration_termination_conditions)
            )
        last_score = float("nan")
        try:
            while True:
                try:
                    self._fit_epoch()
                except _IterationTerminated as t:
                    reason = "IterationTerminationCondition"
                    details = str(t.condition)
                    # mid-epoch abort skips _fit_one_epoch's reset; leave the
                    # iterator clean for reuse
                    self.train_iterator.reset()
                    break
                except Exception as e:  # noqa: BLE001 — reference returns
                    # TerminationReason.Error instead of propagating
                    # (BaseEarlyStoppingTrainer.java catch-all in fit())
                    reason = "Error"
                    details = f"{type(e).__name__}: {e}"
                    try:
                        self.train_iterator.reset()  # clean for retry
                    except Exception:  # noqa: BLE001 — best-effort reset; the original error wins
                        pass
                    break

                terminate = False
                reason = ""
                details = ""
                if epoch % cfg.evaluate_every_n_epochs == 0:
                    score = sc.calculate_score(self.model)
                    last_score = score
                    score_vs_epoch[epoch] = score
                    if math.isnan(score):
                        # a NaN epoch score can never improve on best
                        # (NaN < best is False), so the loop would spin to
                        # MaxEpochs without ever saving a model — surface
                        # it as an error termination instead (reference
                        # EarlyStoppingTrainer invalid-score semantics)
                        reason = "Error"
                        details = (
                            f"Invalid (NaN) epoch score from "
                            f"{type(sc).__name__} at epoch {epoch} — "
                            "empty/exhausted evaluation iterator or "
                            "diverged model"
                        )
                        epoch += 1
                        break
                    improved = score < best_score if minimize else score > best_score
                    if improved:
                        best_score = score
                        best_epoch = epoch
                        cfg.model_saver.save_best_model(self.model, score)
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(self.model, score)
                    if self.listener is not None and hasattr(self.listener, "on_epoch"):
                        self.listener.on_epoch(epoch, score, cfg, self.model)
                evaluated = epoch % cfg.evaluate_every_n_epochs == 0
                # epoch-count conditions run every epoch (MaxEpochs cannot
                # overshoot with sparse evaluation); score-dependent ones only
                # when a fresh score exists — a stale score would count
                # non-evaluation epochs as "no improvement"
                for c in cfg.epoch_termination_conditions:
                    if c.requires_score and not evaluated:
                        continue
                    if c.terminate(epoch, last_score, minimize):
                        terminate = True
                        reason = "EpochTerminationCondition"
                        details = str(c)
                        break
                epoch += 1
                if terminate:
                    break
        finally:
            self.model.set_listeners(*saved_listeners)

        best_model = cfg.model_saver.get_best_model()
        if best_model is None:
            best_model = self.model
        result = EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_epoch >= 0 else float("nan"),
            total_epochs=epoch + (1 if reason == "IterationTerminationCondition" else 0),
            best_model=best_model,
        )
        if self.listener is not None and hasattr(self.listener, "on_completion"):
            self.listener.on_completion(result)
        return result


# Graph alias (reference has a separate class; surface parity)
EarlyStoppingGraphTrainer = EarlyStoppingTrainer


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping driving data-parallel training (reference
    ``EarlyStoppingParallelTrainer.java`` wraps ParallelWrapper): each
    epoch runs through the port's ``ParallelWrapper`` (one process a rank;
    default a one-rank group on the model's device) instead of the model's
    own fit loop."""

    def __init__(self, config, model, train_iterator, wrapper=None,
                 listener=None):
        super().__init__(config, model, train_iterator, listener)
        if wrapper is None:
            from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

            wrapper = ParallelWrapper(model)
        self.wrapper = wrapper

    def _fit_epoch(self) -> None:
        self.wrapper.fit(self.train_iterator, epochs=1)
