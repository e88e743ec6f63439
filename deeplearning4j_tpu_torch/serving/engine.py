"""Model engine: bucket padding around the model's eval forward.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` (slice 1:
``infer``, ``infer_versioned``, ``warmup``, ``describe``,
``example_shape``). The engine holds one immutable snapshot of the model:
its params cast for the compute dtype and placed, with the state, on the
engine's device. A request is padded up to its batch bucket, run through the
model's single-output forward, and sliced back.

A ComputationGraph is served through its single-output forward (the route
the reference engine's generic branch intends). PyTorch runs eagerly, so
there is no compiled-program counter: ``warmup()`` runs every bucket shape
once and reports shapes and seconds. Hot reload, checkpoints, the mesh,
int8 heads, the cost sheet, the flight/obs/chaos hooks and per-bucket CUDA
graphs come with later slices (ROADMAP § A).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.serving.buckets import BucketPolicy


class _Snapshot:
    """One immutable serving model version."""

    __slots__ = ("model", "params", "state", "version", "source", "loaded_at")

    def __init__(self, model, params, state, version, source):
        self.model = model
        self.params = params
        self.state = state
        self.version = int(version)
        self.source = source
        self.loaded_at = time.time()


class InferenceEngine:
    """Serving engine over one model and a bucket policy.

    ``buckets``: a :class:`BucketPolicy`, or a list of batch sizes.
    ``device``: where the snapshot lives and requests run (default the CUDA
    card; :class:`~deeplearning4j_tpu_torch.DeviceUnavailableError` without
    one)."""

    def __init__(self, model, buckets=None, device=None):
        self.device = resolve_device(device)
        if buckets is None:
            buckets = BucketPolicy()
        elif not isinstance(buckets, BucketPolicy):
            buckets = BucketPolicy(batch_buckets=buckets)
        # own copy: oversize growth never mutates a policy shared elsewhere
        self.buckets = buckets.copy()
        if not hasattr(model, "compute_params") or len(
                getattr(model.conf, "network_outputs", ())) != 1:
            raise TypeError(
                f"{type(model).__name__} cannot be served: the engine needs a "
                "single-output ComputationGraph")
        self.warm = False
        self._snap = self._build_snapshot(model, version=0, source="init")

    def _build_snapshot(self, model, version: int, source) -> _Snapshot:
        if model.params_ is None:
            raise ValueError("init() the model (or load params) before serving")
        params = {n: {k: v.to(self.device) for k, v in p.items()}
                  for n, p in model.compute_params().items()}
        state = {n: {k: v.to(self.device) for k, v in s.items()}
                 for n, s in model.state_.items()}
        return _Snapshot(model, params, state, version, source)

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
        }

    # -- inference ----------------------------------------------------------
    def example_shape(self) -> Optional[Tuple[int, ...]]:
        """Per-example input shape from the graph's input type (None for a
        graph with several inputs)."""
        types = self._snap.model.conf.input_types
        if not types or len(types) != 1:
            return None
        return tuple(types[0].shape(1)[1:])

    def infer(self, x) -> np.ndarray:
        """One bucketed forward: pad up to the bucket, run, slice back."""
        return self.infer_versioned(x)[0]

    def infer_versioned(self, x) -> Tuple[np.ndarray, int]:
        """:meth:`infer` plus the version of the snapshot that computed it
        (the snapshot reference is read once)."""
        snap = self._snap
        return self._infer_on(snap, x), snap.version

    def _infer_on(self, snap: _Snapshot, x) -> np.ndarray:
        xp, n = self.buckets.pad_batch(x)
        return self._forward_raw(snap, xp)[:n]

    def _forward_raw(self, snap: _Snapshot, xp: np.ndarray) -> np.ndarray:
        """The exact-shape forward under ``snap``, no padding."""
        model = snap.model
        xt = torch.from_numpy(np.ascontiguousarray(xp)).to(self.device)
        with torch.inference_mode():
            acts = model._forward(snap.params, snap.state, [xt],
                                  cast_params=False)
            y = acts[model.conf.network_outputs[0]]
            if y.dtype in (torch.bfloat16, torch.float16):
                y = y.float()
            return y.cpu().numpy()

    # -- warmup -------------------------------------------------------------
    def warmup(self) -> dict:
        """Run every bucket shape once (allocator, library handles and kernel
        build are then warm). Returns {shapes, seconds}."""
        shape = self.example_shape()
        if shape is None:
            raise ValueError("the model conf declares no single input type "
                             "to warm up with")
        t0 = time.perf_counter()
        shapes = self.buckets.warmup_shapes(shape)
        for full_shape in shapes:
            self._infer_on(self._snap, np.zeros(full_shape, np.float32))
        self.warm = True
        return {"shapes": len(shapes),
                "seconds": round(time.perf_counter() - t0, 3)}
