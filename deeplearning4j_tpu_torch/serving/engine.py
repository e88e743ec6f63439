"""Model engine: bucket padding around the model's eval forward, int8
heads, checkpoints and atomic hot reload.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` (``:68-665``). The
engine holds one immutable snapshot of the model: its params (int8-
quantized heads when ``int8_serving``), cast for the compute dtype and
placed, with the state, on the engine's device. A request is padded up to
its batch bucket (a rank-3 sequence also to its sequence bucket, under a
feature mask), run through the model's forward, and sliced back.

- Models: a ``MultiLayerNetwork``, a single-output ``ComputationGraph``
  (served through its single-output forward, the route the reference
  engine's generic branch intends), or a model without the layer-graph
  ``_forward`` that offers ``compute_params``, ``conf_json``,
  ``serving_rows`` (checks a request, returns its rows) and
  ``serving_forward(params, x)`` on the snapshot's params, such as a
  ``TransformerLM`` (token ids ``(b, T)`` -> f32 logits ``(b, T, V)``; the
  reference's ``output`` branch, ``engine.py:409-420``). Such a model's
  requests are padded in batch only, and ``warmup`` needs an
  ``example_shape`` such as ``(T,)``.
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

- ``devices=[d0, ..., dN-1]`` shares each dispatch over N devices, the
  role ``mesh=TrainingMesh(data=N)`` plays in the reference (``engine.py:
  119-175, 233-240, 269-270, 423-426, 493-500``): buckets that N does not
  divide are dropped with the reference's warning (its ``ValueError`` when
  none is left), every device holds a replica of the snapshot (one per
  distinct device), and each padded bucket is cut into N equal row blocks,
  block i run on device i (all launched before any is read back), the
  results joined on the host in order. ``warmup``, ``reload`` and the int8
  snapshot act on every replica. A list may name one device twice, which
  drives the split on one CPU or one card.

PyTorch runs eagerly, so there is no compiled-program counter: ``warmup()``
runs every bucket shape once. The tensor-parallel serving mesh, the cost
sheet, the flight/chaos hooks, bucket retuning and per-bucket CUDA graphs
come with later slices (ROADMAP § A).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy, slice_result
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics


class _Snapshot:
    """One immutable serving model version: ``replicas`` holds (params,
    state) on each of the engine's devices, in the engine's device order;
    ``params`` and ``state`` are the first device's."""

    __slots__ = ("model", "replicas", "conf_json", "version", "source", "loaded_at")

    def __init__(self, model, replicas, conf_json, version, source):
        self.model = model
        self.replicas = replicas
        self.conf_json = conf_json
        self.version = int(version)
        self.source = source
        self.loaded_at = time.time()

    @property
    def params(self):
        return self.replicas[0][0]

    @property
    def state(self):
        return self.replicas[0][1]


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
    """Lists and dicts of tensors, nested, with every tensor on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, device) for v in tree]
    return tree.to(device)


def _serves_itself(model) -> bool:
    """A model without the layer-graph ``_forward``: it serves through its
    own ``serving_rows``/``serving_forward``."""
    return not hasattr(model, "_forward")


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
    one). ``devices``: several devices (in place of ``device``) over which
    each dispatch is shared, row block by row block. ``checkpoint_dir``:
    the default ``reload`` source. ``metrics``: a :class:`ServingMetrics`
    (default a private one)."""

    def __init__(self, model, buckets=None, device=None,
                 checkpoint_dir: Optional[str] = None,
                 metrics: Optional[ServingMetrics] = None,
                 int8_serving: bool = False, devices: Optional[Sequence] = None):
        if devices is not None and device is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices: List[torch.device] = [
            resolve_device(d) for d in (devices if devices is not None else [device])]
        if not self.devices:
            raise ValueError("devices= names no device")
        self.device = self.devices[0]
        if buckets is None:
            buckets = BucketPolicy()
        elif not isinstance(buckets, BucketPolicy):
            buckets = BucketPolicy(batch_buckets=buckets)
        # own copy: oversize growth never mutates a policy shared elsewhere
        self.buckets = buckets.copy()
        n = len(self.devices)
        if n > 1:
            # the row blocks must be even: keep only buckets N divides
            keep = [b for b in self.buckets.batch_buckets if b % n == 0]
            dropped = [b for b in self.buckets.batch_buckets if b % n]
            if not keep:
                raise ValueError(
                    f"no batch bucket in {self.buckets.batch_buckets} is divisible by "
                    f"the {n} devices; raise batch_limit or pass batch_buckets that are "
                    "multiples of it")
            if dropped:
                warnings.warn(
                    f"dropping batch buckets {dropped}: not divisible by the {n} "
                    f"devices; serving with {keep}", stacklevel=2)
                self.buckets.batch_buckets = keep
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
        devices = kwargs.get("devices")
        model = ModelGuesser.load_model_guess(
            path, device=devices[0] if devices else kwargs.get("device"))
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
        own = _serves_itself(model) and hasattr(model, "serving_forward")
        if not (isinstance(model, MultiLayerNetwork) or single_graph or own):
            raise TypeError(
                f"{type(model).__name__} cannot be served: the engine needs a "
                "MultiLayerNetwork, a single-output ComputationGraph or a model with "
                "serving_forward (a TransformerLM)")
        if model.params_ is None:
            raise ValueError("init() the model (or load params) before serving")

    def _replicas(self, model) -> list:
        """(params, state) of ``model`` as this engine serves them, on each
        of its devices: heads quantized (int8 engines), cast for the compute
        dtype; one copy a distinct device."""
        self._check_servable(model)
        params = model.params_
        if self.int8_serving:
            from deeplearning4j_tpu_torch.nn.ops.int8_matmul import quantize_model_params

            params, self.int8_report = quantize_model_params(model)
        params = model.compute_params(params)
        placed = {}
        for d in self.devices:
            if str(d) not in placed:
                placed[str(d)] = (_place(params, d), _place(model.state_, d))
        return [placed[str(d)] for d in self.devices]

    @staticmethod
    def _conf_json(model) -> str:
        return model.conf_json() if _serves_itself(model) else model.conf.to_json()

    @staticmethod
    def _example_shape(model) -> Optional[Tuple[int, ...]]:
        return None if _serves_itself(model) else conf_example_shape(model.conf)

    def _build_snapshot(self, model, version: int, source) -> _Snapshot:
        return _Snapshot(model, self._replicas(model), self._conf_json(model), version,
                         source)

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
            "devices": [str(d) for d in self.devices],
            "int8_serving": self.int8_serving,
            "int8_report": self.int8_report,
            "checkpoint_fingerprint": (None if self._fingerprint is None
                                       else list(self._fingerprint)),
        }

    # -- inference ----------------------------------------------------------
    def example_shape(self) -> Optional[Tuple[int, ...]]:
        """Per-example input shape from the model conf's input type (None
        for a model that serves itself, such as a TransformerLM, whose rows
        may have any length)."""
        return self._example_shape(self._snap.model)

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
        if _serves_itself(snap.model):
            if mask is not None:
                raise ValueError(f"{type(snap.model).__name__} takes no feature mask")
            xp, _, n = self.buckets.pad_batch(snap.model.serving_rows(x))
            self.metrics.record_dispatch(xp.shape[0], real_rows=n)
            return slice_result(self._forward_raw(snap, xp), n, None, None)
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
        """The exact-shape forward under ``snap``, no padding: with N
        devices, row block i on device i, every block launched before any
        is read back, joined in order."""
        n = len(self.devices)
        xs = np.split(xp, n) if n > 1 else [xp]
        ms = np.split(mp, n) if n > 1 and mp is not None else [mp] * n
        with torch.inference_mode():
            ys = [self._forward_block(snap.model, rep, d, x, m)
                  for rep, d, x, m in zip(snap.replicas, self.devices, xs, ms)]
            out = [(y.float() if y.dtype in (torch.bfloat16, torch.float16) else y)
                   .cpu().numpy() for y in ys]
        return out[0] if n == 1 else np.concatenate(out, axis=0)

    @staticmethod
    def _forward_block(model, replica, device, xb: np.ndarray,
                       mb: Optional[np.ndarray]) -> torch.Tensor:
        """One block's forward on ``device`` with its ``replica`` (params,
        state); the result stays on the device."""
        params, state = replica
        xt = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
        if _serves_itself(model):
            return model.serving_forward(params, xt)
        mt = None if mb is None else torch.from_numpy(
            np.ascontiguousarray(mb, np.float32)).to(device)
        if isinstance(model, MultiLayerNetwork):
            y, _, _ = model._forward(params, state, xt, cast_params=False, fmask=mt)
            return y
        acts, _, _ = model._forward(params, state, [xt], cast_params=False, fmasks=[mt])
        return acts[model.conf.network_outputs[0]]

    # -- warmup -------------------------------------------------------------
    def _warm_snapshot(self, snap: _Snapshot, example_shape) -> int:
        shapes = self.buckets.warmup_shapes(tuple(example_shape))
        for full_shape, with_mask in shapes:
            mask = np.ones(full_shape[:2], np.float32) if with_mask else None
            self._infer_on(snap, np.zeros(full_shape, np.float32), mask)
        return len(shapes)

    def warmup(self, example_shape: Optional[Tuple[int, ...]] = None) -> dict:
        """Run every bucket shape once (allocator, library handles and kernel
        build are then warm). ``example_shape``: one row's shape, default the
        conf's. Returns {shapes, seconds}."""
        shape = tuple(example_shape) if example_shape is not None else self.example_shape()
        if shape is None:
            raise ValueError("the model conf declares no single input type "
                             "to warm up with; pass warmup(example_shape=...)")
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
            conf_json = self._conf_json(new_model)
            same_arch = conf_json == old.conf_json
            if same_arch:
                # params and state only: the old layer graph stays
                snap = _Snapshot(old.model, self._replicas(new_model), old.conf_json,
                                 old.version + 1, path)
            else:
                snap = self._build_snapshot(new_model, version=old.version + 1,
                                            source=path)
                shape = self._example_shape(new_model)
                if self.warm and shape is not None:
                    self._warm_snapshot(snap, shape)
            self._snap = snap  # the atomic publish
            self._fingerprint = fp
            self.metrics.record_reload()
            return {"reloaded": True, "version": snap.version, "path": path,
                    "same_arch": bool(same_arch),
                    "checkpoint_iteration": meta.get("iteration"),
                    "checkpoint_epoch": meta.get("epoch")}
