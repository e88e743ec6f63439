"""Model engine: bucket padding around the model's eval forward, int8
heads, checkpoints and atomic hot reload.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` (``:68-665``). The
engine holds one immutable snapshot of the model: its params (int8-
quantized heads when ``int8_serving``), cast for the compute dtype and
placed, with the state, on the engine's device. A request is padded up to
its batch bucket (a rank-3 sequence also to its sequence bucket, under a
feature mask), run through the model's forward, and sliced back.

- Models: a ``MultiLayerNetwork``, or a single-output ``ComputationGraph``
  (served through its single-output forward, the route the reference
  engine's generic branch intends).
- ``int8_serving=True`` builds every snapshot (init and reloads) with the
  dense/output heads, ``RnnOutputLayer`` included, quantized
  (``nn/ops/int8_matmul.py``): the snapshot on the device holds
  ``W_q8``/``W_scale`` and not the f32 ``W`` of those layers; the model's
  own params stay f32. A ``ComputationGraph`` is
  refused with ``TypeError``, as the reference does.
- ``from_checkpoint`` and ``reload`` resolve a zip or a directory through
  :func:`resolve_checkpoint_source` (an invalid zip falls back to its
  newest valid sibling, a directory gives its newest valid zip). A reload
  whose checkpoint fingerprint is unchanged does nothing; the same
  architecture swaps params and state only; a new one builds and warms a
  new snapshot before the swap. Serving threads read the snapshot
  reference once per request, so a request is computed under one version.

PyTorch runs eagerly, so there is no compiled-program counter: ``warmup()``
runs every bucket shape once. The mesh, the cost sheet, the flight/chaos
hooks, bucket retuning and per-bucket CUDA graphs come with later slices
(ROADMAP § A).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, map_tensors
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy, slice_result
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics


class _Snapshot:
    """One immutable serving model version."""

    __slots__ = ("model", "params", "state", "conf_json", "version", "source",
                 "loaded_at")

    def __init__(self, model, params, state, conf_json, version, source):
        self.model = model
        self.params = params
        self.state = state
        self.conf_json = conf_json
        self.version = int(version)
        self.source = source
        self.loaded_at = time.time()


def conf_input_type(conf):
    """The single input type a configuration declares (None when it
    declares none, or a graph has several inputs)."""
    itype = getattr(conf, "input_type", None)
    if itype is None:
        types = getattr(conf, "input_types", None)
        if not types or len(types) != 1:
            return None
        itype = types[0]
    return itype


def conf_example_shape(conf) -> Optional[Tuple[int, ...]]:
    """Per-example input shape declared by a configuration (a recurrent
    input declares one step when it names no length); None when it declares
    none."""
    itype = conf_input_type(conf)
    return None if itype is None else tuple(itype.shape(1)[1:])


def resolve_checkpoint_source(source: str) -> str:
    """A checkpoint zip from a path or a directory (its newest valid zip).
    An explicit zip that fails validation falls back to the newest valid
    sibling in its directory, with a warning."""
    from deeplearning4j_tpu_torch.train.faults import (
        latest_valid_checkpoint,
        validate_checkpoint,
    )

    if os.path.isdir(source):
        return latest_valid_checkpoint(source)
    if not os.path.exists(source):
        raise FileNotFoundError(f"checkpoint {source!r} does not exist")
    ok, reason = validate_checkpoint(source)
    if ok:
        return source
    parent = os.path.dirname(os.path.abspath(source))
    fallback = latest_valid_checkpoint(parent, missing_ok=True)
    if fallback is None:
        raise ValueError(f"checkpoint {source!r} is invalid ({reason}) and no "
                         f"valid sibling checkpoint exists in {parent!r}")
    warnings.warn(f"checkpoint {source!r} is invalid ({reason}); serving the "
                  f"newest valid sibling {fallback!r} instead", stacklevel=3)
    return fallback


def _place(tree, device: torch.device):
    """A list or dict of param dicts with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: map_tensors(lambda t: t.to(device), d) for k, d in tree.items()}
    return [map_tensors(lambda t: t.to(device), d) for d in tree]


def _path_fingerprint(path: str) -> Optional[Tuple[int, int]]:
    from deeplearning4j_tpu_torch.train.faults import checkpoint_fingerprint

    try:
        return checkpoint_fingerprint(path)
    except OSError:
        return None


class InferenceEngine:
    """Serving engine over one model and a bucket policy.

    ``buckets``: a :class:`BucketPolicy`, or a list of batch sizes.
    ``device``: where the snapshot lives and requests run (default the CUDA
    card; :class:`~deeplearning4j_tpu_torch.DeviceUnavailableError` without
    one). ``checkpoint_dir``: the default ``reload`` source. ``metrics``: a
    :class:`ServingMetrics` (default a private one)."""

    def __init__(self, model, buckets=None, device=None,
                 checkpoint_dir: Optional[str] = None,
                 metrics: Optional[ServingMetrics] = None,
                 int8_serving: bool = False):
        self.device = resolve_device(device)
        if buckets is None:
            buckets = BucketPolicy()
        elif not isinstance(buckets, BucketPolicy):
            buckets = BucketPolicy(batch_buckets=buckets)
        # own copy: oversize growth never mutates a policy shared elsewhere
        self.buckets = buckets.copy()
        self.checkpoint_dir = checkpoint_dir
        self.metrics = metrics if metrics is not None else ServingMetrics()
        #: every snapshot of this engine (init and reloads) serves int8
        #: heads; the model's own params stay f32
        self.int8_serving = bool(int8_serving)
        self.int8_report: Optional[dict] = None
        self._reload_lock = threading.Lock()
        self._fingerprint: Optional[Tuple[int, int]] = None
        self.warm = False
        self._snap = self._build_snapshot(model, version=0, source="init")

    # -- construction -------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, source: str, **kwargs) -> "InferenceEngine":
        """Engine from a checkpoint zip or directory (its newest valid zip;
        an explicit invalid zip falls back to its newest valid sibling). A
        directory is also the default ``reload`` source. The model is
        restored on the engine's ``device`` (default the CUDA card)."""
        from deeplearning4j_tpu_torch.train.model_serializer import ModelGuesser

        path = resolve_checkpoint_source(source)
        model = ModelGuesser.load_model_guess(path, device=kwargs.get("device"))
        if os.path.isdir(source):
            kwargs.setdefault("checkpoint_dir", source)
        eng = cls(model, **kwargs)
        eng._snap.source = path
        eng._fingerprint = _path_fingerprint(path)
        return eng

    def _check_servable(self, model) -> None:
        if self.int8_serving and not isinstance(model, MultiLayerNetwork):
            raise TypeError(
                f"int8_serving needs a MultiLayerNetwork (its dense/output "
                f"heads are quantized layer by layer); {type(model).__name__} "
                "cannot serve int8 heads")
        single_graph = (isinstance(model, ComputationGraph)
                        and len(model.conf.network_outputs) == 1)
        if not (isinstance(model, MultiLayerNetwork) or single_graph):
            raise TypeError(
                f"{type(model).__name__} cannot be served: the engine needs a "
                "MultiLayerNetwork or a single-output ComputationGraph")
        if model.params_ is None:
            raise ValueError("init() the model (or load params) before serving")

    def _snapshot_params(self, model):
        """The model's params as this engine serves them: heads quantized
        (int8 engines), cast for the compute dtype, on the device."""
        self._check_servable(model)
        params = model.params_
        if self.int8_serving:
            from deeplearning4j_tpu_torch.nn.ops.int8_matmul import quantize_model_params

            params, self.int8_report = quantize_model_params(model)
        return _place(model.compute_params(params), self.device)

    def _build_snapshot(self, model, version: int, source) -> _Snapshot:
        params = self._snapshot_params(model)
        return _Snapshot(model, params, _place(model.state_, self.device),
                         model.conf.to_json(), version, source)

    # -- properties ---------------------------------------------------------
    @property
    def model_version(self) -> int:
        return self._snap.version

    @property
    def model(self):
        """The live snapshot's layer graph (after a same-architecture reload
        still the original model object: read results through ``infer``)."""
        return self._snap.model

    def describe(self) -> dict:
        snap = self._snap
        return {
            "model_type": type(snap.model).__name__,
            "version": snap.version,
            "source": str(snap.source),
            "loaded_at": snap.loaded_at,
            "num_params": int(snap.model.num_params()),
            "warm": self.warm,
            "buckets": repr(self.buckets),
            "device": str(self.device),
            "int8_serving": self.int8_serving,
            "int8_report": self.int8_report,
            "checkpoint_fingerprint": (None if self._fingerprint is None
                                       else list(self._fingerprint)),
        }

    # -- inference ----------------------------------------------------------
    def example_shape(self) -> Optional[Tuple[int, ...]]:
        """Per-example input shape from the model conf's input type."""
        return conf_example_shape(self._snap.model.conf)

    def infer(self, x, mask=None) -> np.ndarray:
        """One bucketed forward: pad up to the bucket, run, slice back.
        ``mask``: the (b, T) feature mask of rank-3 input (made for rank-3
        input when the policy has sequence buckets and none is given)."""
        return self.infer_versioned(x, mask)[0]

    def infer_versioned(self, x, mask=None) -> Tuple[np.ndarray, int]:
        """:meth:`infer` plus the version of the snapshot that computed it
        (the snapshot reference is read once)."""
        snap = self._snap
        return self._infer_on(snap, x, mask), snap.version

    def _infer_on(self, snap: _Snapshot, x, mask=None) -> np.ndarray:
        x = np.asarray(x)
        itype = conf_input_type(snap.model.conf)
        shape = None if itype is None else tuple(itype.shape(1)[1:])
        if itype is not None and itype.kind == "recurrent" and itype.timesteps is None:
            # sequences of any length, each step of the model's size
            if x.ndim != 3 or x.shape[2] != itype.size:
                raise ValueError(f"input of shape {tuple(x.shape)}; the model takes "
                                 f"(batch, time, {itype.size}) sequences")
        elif shape is not None and tuple(x.shape[1:]) != shape:
            raise ValueError(f"input rows of shape {tuple(x.shape[1:])}; the model "
                             f"takes rows of shape {shape}")
        if mask is not None:
            mask = np.asarray(mask, np.float32)
            if x.ndim < 3 or mask.shape != x.shape[:2]:
                raise ValueError(f"mask of shape {mask.shape} does not match input "
                                 f"rows and steps {x.shape[:2]}")
        t_orig = x.shape[1] if x.ndim >= 3 else None
        xp, mp, n = self.buckets.pad_batch(x, mask)
        t_padded = xp.shape[1] if t_orig is not None else None
        self.metrics.record_dispatch(xp.shape[0], real_rows=n)
        return slice_result(self._forward_raw(snap, xp, mp), n, t_orig, t_padded)

    def _forward_raw(self, snap: _Snapshot, xp: np.ndarray,
                     mp: Optional[np.ndarray] = None) -> np.ndarray:
        """The exact-shape forward under ``snap``, no padding."""
        model = snap.model
        xt = torch.from_numpy(np.ascontiguousarray(xp)).to(self.device)
        with torch.inference_mode():
            if isinstance(model, MultiLayerNetwork):
                mt = None if mp is None else torch.from_numpy(
                    np.ascontiguousarray(mp, np.float32)).to(self.device)
                y, _, _ = model._forward(snap.params, snap.state, xt, cast_params=False,
                                         fmask=mt)
            else:
                if mp is not None:
                    raise NotImplementedError(
                        "feature masks into a ComputationGraph are not ported yet "
                        "(ROADMAP § A)")
                acts, _, _ = model._forward(snap.params, snap.state, [xt],
                                            cast_params=False)
                y = acts[model.conf.network_outputs[0]]
            if y.dtype in (torch.bfloat16, torch.float16):
                y = y.float()
            return y.cpu().numpy()

    # -- warmup -------------------------------------------------------------
    def _warm_snapshot(self, snap: _Snapshot, example_shape) -> int:
        shapes = self.buckets.warmup_shapes(tuple(example_shape))
        for full_shape, with_mask in shapes:
            mask = np.ones(full_shape[:2], np.float32) if with_mask else None
            self._infer_on(snap, np.zeros(full_shape, np.float32), mask)
        return len(shapes)

    def warmup(self) -> dict:
        """Run every bucket shape once (allocator, library handles and kernel
        build are then warm). Returns {shapes, seconds}."""
        shape = self.example_shape()
        if shape is None:
            raise ValueError("the model conf declares no single input type "
                             "to warm up with")
        t0 = time.perf_counter()
        n_shapes = self._warm_snapshot(self._snap, shape)
        self.warm = True
        return {"shapes": n_shapes, "seconds": round(time.perf_counter() - t0, 3)}

    # -- hot reload ---------------------------------------------------------
    def reload(self, source: Optional[str] = None, force: bool = False) -> dict:
        """Atomically swap in a new model version from ``source`` (a zip, a
        directory, or None for ``checkpoint_dir``). An unchanged checkpoint
        is a no-op unless ``force``; the same architecture swaps params and
        state only (int8 engines quantize them again); a different one
        builds (and, if the engine was warmed, warms) a new snapshot first.
        A failure leaves the serving snapshot as it was."""
        from deeplearning4j_tpu_torch.train.model_serializer import (
            ModelGuesser,
            ModelSerializer,
        )

        src = source or self.checkpoint_dir
        if src is None:
            raise ValueError("no reload source: pass a checkpoint path or "
                             "configure checkpoint_dir")
        with self._reload_lock:
            path = resolve_checkpoint_source(src)
            fp = _path_fingerprint(path)
            if (not force and fp is not None and fp == self._fingerprint
                    and str(path) == str(self._snap.source)):
                return {"reloaded": False, "version": self._snap.version,
                        "path": path, "reason": "unchanged"}
            meta = ModelSerializer.checkpoint_meta(path)
            new_model = ModelGuesser.load_model_guess(path, device=self.device)
            old = self._snap
            conf_json = new_model.conf.to_json()
            same_arch = conf_json == old.conf_json
            if same_arch:
                # params and state only: the old layer graph stays
                snap = _Snapshot(old.model, self._snapshot_params(new_model),
                                 _place(new_model.state_, self.device),
                                 old.conf_json, old.version + 1, path)
            else:
                snap = self._build_snapshot(new_model, version=old.version + 1,
                                            source=path)
                shape = conf_example_shape(new_model.conf)
                if self.warm and shape is not None:
                    self._warm_snapshot(snap, shape)
            self._snap = snap  # the atomic publish
            self._fingerprint = fp
            self.metrics.record_reload()
            return {"reloaded": True, "version": snap.version, "path": path,
                    "same_arch": bool(same_arch),
                    "checkpoint_iteration": meta.get("iteration"),
                    "checkpoint_epoch": meta.get("epoch")}
