"""Training listeners.

Counterpart of ``deeplearning4j_tpu/train/listeners.py`` (reference
``optimize/api/TrainingListener.java:23-71`` and
``optimize/listeners/``): the listener SPI and its dispatch, and the
reference's listeners. Every ``fit`` path of the port calls them: the two
networks' ``fit`` (eager, bundled and tBPTT), ``ParallelWrapper`` and
``SharedTrainingMaster``.

- ``iteration_done(model, iteration, epoch)`` after each step, with
  ``iteration`` the count after it; ``on_epoch_start``/``on_epoch_end``
  around each epoch; ``on_fit_end`` when ``fit`` returns or raises.
- The introspection hooks (``on_forward_pass``, ``on_gradient_calculation``)
  fire only for a listener that overrides them: the network then runs one
  extra forward and gradient pass before the step, with the noise the step
  draws, so the gradients it reports are the step's bits and attaching the
  listener never changes the run. ``on_backward_pass`` follows the step.
- A bundle (``steps_per_call > 1``) calls ``bundle_done(model, it0, epoch,
  BundleScores)`` on a listener that has it, whose host copy of the scores
  is made once a bundle however many listeners read it, and replays
  ``iteration_done`` step by step for the others. A listener that needs a
  host callback between steps (the introspection hooks, or
  ``requires_per_step_state``) makes the fit take single steps
  (``train/pipeline.bundling_blockers``).
- ``telemetry_done(model, it0, epoch, BundleTelemetry)`` hands a listener the
  in-graph telemetry of a step or a bundle (``obs/telemetry.py``), before the
  score hooks.

What the reference records in its flight recorder (``checkpoint_write``)
and writes through its chaos file layer comes with ROADMAP § A9: here
files are written with plain ``open`` and no event is recorded. The
``orbax`` serializer of ``CheckpointListener`` and ``RegistryPublishListener``
(which needs ``serving/registry.py``) are not ported yet (ROADMAP § A8,
A9).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Callable, List, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

#: the refusal of the orbax serializer
ORBAX_NOT_PORTED = ("CheckpointListener(serializer='orbax') is not ported yet "
                    "(ROADMAP § A8: orbax_serializer to torch.distributed.checkpoint)")


class SerializerNotPortedError(NotImplementedError):
    """A checkpoint serializer the port does not have yet."""


class TrainingListener:
    """Base listener: every hook does nothing (the reference's
    ``TrainingListener``). The introspection hooks fire only for a listener
    that overrides them (:func:`_has_hook`)."""

    def iteration_done(self, model, iteration: int, epoch: int) -> None:  # noqa: D401
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        """Each layer's (a list) or vertex's (a dict) activation of this
        iteration's forward pass, as numpy."""

    def on_gradient_calculation(self, model, gradients) -> None:
        """This iteration's gradients in the layout of ``model.params_``, as
        numpy."""

    def on_backward_pass(self, model) -> None:
        pass

    def on_fit_end(self, model) -> None:
        """When ``fit`` returns, also by an exception: where a listener
        releases what it holds open (``ProfilerListener``'s trace)."""

    def needs_introspection(self, next_iteration: int) -> bool:
        """Whether the introspection hooks fire for the coming iteration (a
        sampling listener skips the extra pass between its samples)."""
        return True


def _has_hook(lst, name: str) -> bool:
    """Whether ``lst`` provides ``name`` itself: a class override, or an
    attribute bound on the instance. A duck-typed listener that does not
    define the hook does not provide it."""
    if name in getattr(lst, "__dict__", {}):
        return True
    impl = getattr(type(lst), name, None)
    return impl is not None and impl is not getattr(TrainingListener, name)


def _hook_recipients(listeners, name: str, next_iteration: Optional[int] = None) -> list:
    """The listeners that provide ``name`` and, where ``next_iteration`` is
    given, want introspection for it."""
    def wants(lst):
        gate = getattr(lst, "needs_introspection", None)
        return next_iteration is None or gate is None or gate(next_iteration)

    return [lst for lst in listeners if _has_hook(lst, name) and wants(lst)]


def dispatch_epoch_start(listeners, model) -> None:
    for lst in listeners:
        if hasattr(lst, "on_epoch_start"):
            lst.on_epoch_start(model)


def dispatch_epoch_end(listeners, model) -> None:
    for lst in listeners:
        if hasattr(lst, "on_epoch_end"):
            lst.on_epoch_end(model)


def dispatch_fit_end(listeners, model) -> None:
    """``on_fit_end`` to every listener that has it, each in its own
    ``try``: a failing cleanup neither stops the others' nor hides the fit's
    own exception (it is logged)."""
    for lst in listeners:
        hook = getattr(lst, "on_fit_end", None)
        if hook is not None:
            try:
                hook(model)
            except Exception:  # noqa: BLE001 — logged; fit's own exit wins
                log.exception("on_fit_end failed for %s", type(lst).__name__)


def dispatch_step_done(model, it0: int, telem=None) -> None:
    """The listener calls after one single step (``model.iteration`` already
    advanced): the step's telemetry (a dict of 0-dim tensors) to
    ``telemetry_done``, ``on_backward_pass``, then ``iteration_done``."""
    listeners = model.listeners
    if not listeners:
        return
    if telem is not None:
        from deeplearning4j_tpu_torch.obs import telemetry as _telemetry

        _telemetry.dispatch_telemetry(listeners, model, it0, model.epoch,
                                      _telemetry.BundleTelemetry(telem, 1))
    for lst in _hook_recipients(listeners, "on_backward_pass"):
        lst.on_backward_pass(model)
    for lst in listeners:
        lst.iteration_done(model, model.iteration, model.epoch)


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_iterations`` iterations (the reference's
    ``ScoreIterationListener``); bundle-aware: one host fetch a bundle."""

    def __init__(self, print_iterations: int = 10,
                 printer: Optional[Callable[[str], None]] = None):
        self.print_iterations = max(1, int(print_iterations))
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {model.score():.6f}")

    def bundle_done(self, model, it0, epoch, scores):
        hits = [j for j in range(len(scores)) if (it0 + j + 1) % self.print_iterations == 0]
        if not hits:
            return
        host = scores.host()
        for j in hits:
            self.printer(f"Score at iteration {it0 + j + 1} is {float(host[j]):.6f}")


class CollectScoresIterationListener(TrainingListener):
    """Collects ``(iteration, score)`` pairs every ``frequency`` iterations
    (the reference's ``CollectScoresIterationListener``); bundle-aware."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score()))

    def bundle_done(self, model, it0, epoch, scores):
        hits = [j for j in range(len(scores)) if (it0 + j + 1) % self.frequency == 0]
        if not hits:
            return
        host = scores.host()
        for j in hits:
            self.scores.append((it0 + j + 1, float(host[j])))


class PerformanceListener(TrainingListener):
    """Batches and samples a second over windows of ``frequency`` iterations
    (the reference's ``PerformanceListener``), by the host clock; each call
    adds its own batch's size (``model.last_batch_size``); where the
    prefetch queue's wait counter moves (``obs/metrics.py``), the share of
    the window spent waiting on it."""

    def __init__(self, frequency: int = 10, report_score: bool = False,
                 printer: Optional[Callable[[str], None]] = None):
        self.frequency = max(1, int(frequency))
        self.report_score = report_score
        self.printer = printer or (lambda s: log.info(s))
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._samples = 0
        self._wait0: Optional[float] = None
        self.last_samples_per_sec: Optional[float] = None
        self.last_batches_per_sec: Optional[float] = None
        self.last_input_bound_share: Optional[float] = None

    @staticmethod
    def _consumer_wait_s() -> float:
        from deeplearning4j_tpu_torch.obs.metrics import thread_consumer_wait_seconds

        return thread_consumer_wait_seconds()

    def _window(self, it: int, samples: int, score_fn) -> None:
        self._samples += samples
        if self._last_time is None:
            # the baseline: this call's samples belong to no window
            self._last_time = time.perf_counter()
            self._last_iter = it
            self._samples = 0
            self._wait0 = self._consumer_wait_s()
            return
        if (it - self._last_iter) < self.frequency:
            return
        now = time.perf_counter()
        dt = now - self._last_time
        self.last_batches_per_sec = (it - self._last_iter) / dt
        msg = f"iteration {it}: {self.last_batches_per_sec:.2f} batches/sec"
        if self._samples:
            self.last_samples_per_sec = self._samples / dt
            msg += f", {self.last_samples_per_sec:.1f} samples/sec"
        wait1 = self._consumer_wait_s()
        if self._wait0 is not None and dt > 0:
            share = min(max(wait1 - self._wait0, 0.0) / dt, 1.0)
            self.last_input_bound_share = share
            if wait1 > self._wait0:
                msg += (f", queue-wait {share:.0%} "
                        f"({'input' if share >= 0.5 else 'compute'}-bound)")
        if self.report_score:
            msg += f", score {score_fn():.6f}"
        self.printer(msg)
        self._last_time = now
        self._last_iter = it
        self._samples = 0
        self._wait0 = wait1

    def iteration_done(self, model, iteration, epoch):
        bs = int(getattr(model, "last_batch_size", None) or 0)
        self._window(iteration, bs, lambda: model.score())

    def bundle_done(self, model, it0, epoch, scores):
        """A bundle is timed whole: its K batches share a size."""
        k = len(scores)
        bs = int(getattr(model, "last_batch_size", None) or 0)
        self._window(it0 + k, bs * k, lambda: float(scores.host()[-1]))


class TimeIterationListener(TrainingListener):
    """Logs an estimate of the time left (the reference's
    ``TimeIterationListener``)."""

    def __init__(self, iteration_count: int, frequency: int = 100,
                 printer: Optional[Callable[[str], None]] = None):
        self.iteration_count = iteration_count
        self.frequency = max(1, int(frequency))
        self.printer = printer or (lambda s: log.info(s))
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self.start
            remaining = (self.iteration_count - iteration) * elapsed / iteration
            self.printer(f"Remaining time estimate: {remaining:.1f}s "
                         f"({iteration}/{self.iteration_count})")


class SleepyTrainingListener(TrainingListener):
    """Sleeps after each iteration and epoch (the reference's
    ``SleepyTrainingListener``, for tests of timing)."""

    def __init__(self, timer_iteration_ms: float = 0.0, timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration, epoch):
        if self.timer_iteration_ms > 0:
            time.sleep(self.timer_iteration_ms / 1000.0)

    def on_epoch_end(self, model):
        if self.timer_epoch_ms > 0:
            time.sleep(self.timer_epoch_ms / 1000.0)


class EvaluativeListener(TrainingListener):
    """Evaluates the model on ``iterator`` every ``frequency`` epochs or
    iterations (the reference's ``EvaluativeListener``);
    ``callback(listener, model, count, evaluation)`` after each evaluation
    (its ``EvaluationCallback``; :func:`model_saving_callback`)."""

    def __init__(self, iterator, frequency: int = 1, invocation: str = "epoch_end",
                 printer: Optional[Callable[[str], None]] = None,
                 callback: Optional[Callable] = None):
        self.iterator = iterator
        self.frequency = max(1, int(frequency))
        self.invocation = invocation
        # an evaluation at an iteration reads the model at that iteration,
        # which a bundle's replay of iteration_done cannot give
        self.requires_per_step_state = invocation == "iteration_end"
        self.printer = printer or (lambda s: log.info(s))
        self.callback = callback
        self.evaluations: List[object] = []

    def _evaluate(self, model):
        ev = model.evaluate(self.iterator)
        self.evaluations.append(ev)
        self.printer(f"Evaluation: accuracy={ev.accuracy():.4f} f1={ev.f1():.4f}")
        if self.callback is not None:
            self.callback(self, model, len(self.evaluations), ev)

    def iteration_done(self, model, iteration, epoch):
        if self.invocation == "iteration_end" and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model):
        if self.invocation == "epoch_end" and model.epoch % self.frequency == 0:
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    """Checkpoint zips every N epochs, iterations or minutes, with the
    reference's retention: ``keep_mode`` "all", "last" (the newest
    ``keep_last``) or "last_and_every" (also every ``keep_every``-th
    checkpoint by number). Numbering continues after the checkpoints the
    directory holds; stale staging files are swept when it is opened."""

    def __init__(self, directory: str, save_every_n_epochs: Optional[int] = None,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_minutes: Optional[float] = None, keep_mode: str = "all",
                 keep_last: int = 1, keep_every: int = 0, serializer: str = "zip"):
        if serializer not in ("zip", "orbax"):
            raise ValueError(f"serializer must be 'zip' or 'orbax', got {serializer!r}")
        if serializer == "orbax":
            raise SerializerNotPortedError(ORBAX_NOT_PORTED)
        from deeplearning4j_tpu_torch.train.faults import sweep_stale_tmp

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        sweep_stale_tmp(directory, surface="checkpoint")
        self.save_every_n_epochs = save_every_n_epochs
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_minutes = save_every_minutes
        self.keep_mode = keep_mode
        # iteration and clock triggers read the model at an iteration,
        # which a bundle's replay cannot give: they force single steps
        self.requires_per_step_state = bool(save_every_n_iterations or save_every_minutes)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.serializer = serializer
        self._last_save_time = time.perf_counter()
        self.checkpoints: List[str] = []
        self._ids: List[int] = []
        existing = [int(m.group(1)) for f in os.listdir(directory)
                    for m in [re.match(r"checkpoint_(\d+)_", f)] if m]
        self._counter = max(existing, default=0)

    def _save(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

        self._counter += 1
        stem = f"checkpoint_{self._counter}_iter_{iteration}_epoch_{epoch}"
        path = os.path.join(self.directory, stem + ".zip")
        ModelSerializer.write_model(model, path, save_updater=True)
        # the reference records a checkpoint_write flight event here (A9)
        self.checkpoints.append(path)
        self._ids.append(self._counter)
        self._apply_retention()

    def _apply_retention(self):
        if self.keep_mode == "all":
            return
        keep = set(self.checkpoints[-self.keep_last:])
        if self.keep_mode == "last_and_every" and self.keep_every > 0:
            # by checkpoint number, which removals do not shift
            for cid, p in zip(self._ids, self.checkpoints):
                if cid % self.keep_every == 0:
                    keep.add(p)
        for p in list(self.checkpoints):
            if p in keep:
                continue
            if os.path.exists(p):
                if os.path.isdir(p):
                    shutil.rmtree(p)
                else:
                    os.remove(p)
            i = self.checkpoints.index(p)
            del self.checkpoints[i]
            del self._ids[i]

    def iteration_done(self, model, iteration, epoch):
        if self.save_every_n_iterations and iteration % self.save_every_n_iterations == 0:
            self._save(model, iteration, epoch)
        elif self.save_every_minutes:
            if (time.perf_counter() - self._last_save_time) >= self.save_every_minutes * 60:
                self._save(model, iteration, epoch)
                self._last_save_time = time.perf_counter()

    def on_epoch_end(self, model):
        if self.save_every_n_epochs and model.epoch % self.save_every_n_epochs == 0:
            self._save(model, model.iteration, model.epoch)


class ProfilerListener(TrainingListener):
    """A ``torch.profiler`` trace of a window of iterations: it opens at
    ``start_iteration``, closes ``num_iterations`` later, at the end of an
    epoch inside the window or at the end of the fit, and writes a Chrome
    trace (``trace_<pid>_<n>.json``) into ``log_dir`` (the reference traces
    with ``jax.profiler``). The card's kernels are in it where CUDA is
    available."""

    # the window brackets the device work of given iterations
    requires_per_step_state = True

    def __init__(self, log_dir: str, start_iteration: int = 5, num_iterations: int = 3):
        self.log_dir = log_dir
        self.start_iteration = int(start_iteration)
        self.stop_iteration = int(start_iteration) + int(num_iterations)
        self._active = False
        self._prof = None
        self.completed = False
        #: the trace file written when the window closed
        self.trace_path: Optional[str] = None

    def _open(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._active = True

    def _close(self, model) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        self._active = False
        self.completed = True
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        n = len([f for f in os.listdir(self.log_dir) if f.startswith("trace_")])
        self.trace_path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(self.trace_path)

    def iteration_done(self, model, iteration, epoch):
        if self.completed:
            return
        if not self._active and iteration >= self.start_iteration:
            self._open()
        elif self._active and iteration >= self.stop_iteration:
            self._close(model)

    def on_epoch_end(self, model):
        if self._active:
            self._close(model)

    def on_fit_end(self, model):
        """A window open when ``fit`` returns or raises is closed here."""
        if self._active:
            self._close(model)


class ComposableIterationListener(TrainingListener):
    """Several listeners handed around as one (the reference's
    ``ComposableIterationListener``): every hook goes to each of them, a
    bundle and telemetry with the one shared host fetch."""

    def __init__(self, *listeners):
        self.listeners = (list(listeners[0]) if len(listeners) == 1
                          and isinstance(listeners[0], (list, tuple)) else list(listeners))

    def iteration_done(self, model, iteration, epoch):
        for lst in self.listeners:
            lst.iteration_done(model, iteration, epoch)

    def on_epoch_start(self, model):
        dispatch_epoch_start(self.listeners, model)

    def on_epoch_end(self, model):
        dispatch_epoch_end(self.listeners, model)

    def on_fit_end(self, model):
        dispatch_fit_end(self.listeners, model)

    def telemetry_done(self, model, it0, epoch, telem):
        from deeplearning4j_tpu_torch.obs.telemetry import dispatch_telemetry

        dispatch_telemetry(self.listeners, model, it0, epoch, telem)

    def needs_introspection(self, next_iteration: int) -> bool:
        return any(_has_hook(lst, "on_forward_pass") or _has_hook(lst, "on_gradient_calculation")
                   for lst in self.listeners
                   if getattr(lst, "needs_introspection", lambda _: True)(next_iteration))

    def bundling_blockers(self):
        """The composed listeners' needs (this class's own delegating hooks
        would read as always blocking)."""
        from deeplearning4j_tpu_torch.train import pipeline

        return pipeline.bundling_blockers(self.listeners)

    def bundle_done(self, model, it0, epoch, scores):
        from deeplearning4j_tpu_torch.train import pipeline

        pipeline.dispatch_bundle_to(self.listeners, model, it0, epoch, scores)

    def on_forward_pass(self, model, activations):
        for lst in _hook_recipients(self.listeners, "on_forward_pass"):
            lst.on_forward_pass(model, activations)

    def on_gradient_calculation(self, model, gradients):
        for lst in _hook_recipients(self.listeners, "on_gradient_calculation"):
            lst.on_gradient_calculation(model, gradients)

    def on_backward_pass(self, model):
        for lst in _hook_recipients(self.listeners, "on_backward_pass"):
            lst.on_backward_pass(model)


def _named_leaves(tree, prefix=()):
    """``(path, array)`` of every tensor or array of a params tree: list
    entries by index, dict keys sorted, the path joined by "/" (the
    reference's ``jax.tree_util`` paths), f32 numpy on the host."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _named_leaves(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _named_leaves(v, prefix + (str(i),))
        return out
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        arr = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).cpu().numpy()
    else:
        arr = np.asarray(tree)
    return [("/".join(prefix), arr)]


class ParamAndGradientIterationListener(TrainingListener):
    """Per-parameter statistics of the params and gradients every
    ``iterations`` iterations, delimited lines to stdout and/or a file (the
    reference's ``ParamAndGradientIterationListener``). ``gradients``:
    "per_param" (the introspection hook's per-step gradients; forces single
    steps), "telemetry" (the global norms of the in-graph telemetry, which
    bundles keep) or "none" (params only)."""

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs_value: bool = True, output_to_console: bool = True,
                 file: Optional[str] = None, delimiter: str = "\t",
                 gradients: str = "per_param"):
        if gradients not in ("per_param", "telemetry", "none"):
            raise ValueError(f"gradients must be 'per_param', 'telemetry' or 'none', "
                             f"got {gradients!r}")
        self.iterations = max(int(iterations), 1)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs_value = print_mean_abs_value
        self.output_to_console = output_to_console
        self.file = file
        self.delimiter = delimiter
        self.gradients = gradients
        if gradients == "per_param":
            # bound on the instance in this mode only, so that the bundling
            # check sees the per-step hook exactly when it is needed
            self.on_gradient_calculation = self._on_gradient_calculation
        self._grads = None
        self._telem = None
        self._header_written = False
        if file:
            # truncated once a listener; plain open (the reference's chaos
            # file layer is ROADMAP § A9)
            open(file, "w").close()

    def needs_introspection(self, next_iteration: int) -> bool:
        return next_iteration % self.iterations == 0

    def _on_gradient_calculation(self, model, gradients):
        self._grads = gradients

    def telemetry_done(self, model, it0, epoch, telem):
        if self.gradients == "telemetry":
            self._telem = (it0, telem)

    def _stats(self, arr):
        cols = []
        if self.print_mean:
            cols.append(float(np.mean(arr)))
        if self.print_min_max:
            cols.extend([float(np.min(arr)), float(np.max(arr))])
        if self.print_mean_abs_value:
            cols.append(float(np.mean(np.abs(arr))))
        return cols

    def _stat_names(self):
        names = []
        if self.print_mean:
            names.append("mean")
        if self.print_min_max:
            names.extend(["min", "max"])
        if self.print_mean_abs_value:
            names.append("meanAbs")
        return names

    def _emit(self, line: str):
        if self.output_to_console:
            print(line)
        if self.file:
            # plain open (the reference's chaos file layer is ROADMAP § A9)
            with open(self.file, "a") as f:
                f.write(line + "\n")

    def _telem_rows(self, it0: int, k: int) -> None:
        telem = None
        if self._telem is not None and self._telem[0] == it0:
            telem = self._telem[1]
        self._telem = None
        if telem is None:
            return
        host = telem.host()
        keys = sorted(host)
        if self.print_header and not self._header_written:
            self._emit(self.delimiter.join(["iteration"] + keys))
            self._header_written = True
        for j in range(k):
            it = it0 + j + 1
            if it % self.iterations:
                continue
            self._emit(self.delimiter.join(
                [str(it)] + [f"{float(host[key][j]):.6g}" for key in keys]))

    def bundle_done(self, model, it0, epoch, scores):
        if self.gradients == "telemetry":
            self._telem_rows(it0, len(scores))
        elif any((it0 + j + 1) % self.iterations == 0 for j in range(len(scores))):
            self._param_row(model, it0 + len(scores))

    def iteration_done(self, model, iteration, epoch):
        if self.gradients == "telemetry":
            self._telem_rows(iteration - 1, 1)
            return
        if iteration % self.iterations:
            return
        self._param_row(model, iteration)

    def _param_row(self, model, iteration):
        params = _named_leaves(model.params_)
        grads = _named_leaves(self._grads) if self._grads is not None else []
        if self.print_header and not self._header_written:
            cols = ["iteration"]
            for name, _ in params:
                cols += [f"p_{name}_{s}" for s in self._stat_names()]
            for name, _ in grads:
                cols += [f"g_{name}_{s}" for s in self._stat_names()]
            self._emit(self.delimiter.join(cols))
            self._header_written = True
        vals = [str(iteration)]
        for _, a in params:
            vals += [f"{x:.6g}" for x in self._stats(a)]
        for _, a in grads:
            vals += [f"{x:.6g}" for x in self._stats(a)]
        self._emit(self.delimiter.join(vals))
        self._grads = None


def model_saving_callback(root_folder: str, filename_template: str):
    """An ``EvaluativeListener`` callback that writes the model after each
    evaluation (the reference's ``ModelSavingCallback``): ``%d`` in the
    template is the evaluation's count."""
    if not os.path.isdir(root_folder):
        raise ValueError(f"root_folder must be an existing directory: {root_folder!r}")
    if not filename_template:
        raise ValueError("filename_template can't be empty")

    def call(listener, model, count, evaluation):
        from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

        name = filename_template.replace("%d", str(count))
        ModelSerializer.write_model(model, os.path.join(root_folder, name))

    return call
