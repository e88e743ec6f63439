"""Zip-format model checkpoints, the reference's format.

Counterpart of ``deeplearning4j_tpu/train/model_serializer.py``. Entries:
``configuration.json`` (the configuration dict), ``coefficients.bin`` (the
params as one little-endian f32 vector: layers in order, param names
sorted), ``state.bin`` (layer state, e.g. BN running statistics, the same
way; a graph's vertices sorted by name) and ``meta.json`` (iteration,
epoch, model type). A zip written by either package restores in the
other.

``meta.json`` also carries the fault guard's state (``fault_state``: the
counters and the loss scale, as the reference writes them), which restore
reads back, so a guarded run resumes with its skip count, its updater clock
and its loss scale, and the dropout RNG's position under a key of the
port's own, ``dropout_noise`` (``{"seed", "position"}``: the model's
``noise_seed`` and the draw position of its next step, its iteration), so a
run restored mid-fit draws the masks the uninterrupted run would have. The
reference writes its RNG chain as ``rng`` (a uint32 key of its own PRNG):
the port never writes that key and ignores it on restore, and the
reference ignores ``dropout_noise``.

``updaterState.bin`` holds the updater slots as one f32 vector (layers in
order, param names, then slot names sorted: ``opt_state_flat``), written
when the model has updater state and ``save_updater`` (the default) is
set, and read back by default, so a restored model resumes training where
it stopped. During a ZeRO-1 sharded fit the live updater state is sharded
and ``model.opt_state_`` is stale: the wrapper installs
``model._opt_state_sync``, which :meth:`ModelSerializer.write_model` calls
first to gather it (a collective: every rank writes, or at least calls it).
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.faults import atomic_tmp_path

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.bin"
UPDATER_ENTRY = "updaterState.bin"
STATE_ENTRY = "state.bin"
META_ENTRY = "meta.json"

def _state_groups(state):
    """The layer-state dicts in checkpoint order: a MultiLayerNetwork's in
    layer order, a ComputationGraph's by vertex name."""
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return list(state or [])


class ModelSerializer:
    @staticmethod
    def write_model(model, path: str, save_updater: bool = True) -> None:
        """Write ``model`` to the zip ``path``, staged in a same-directory
        temp file and published with ``os.replace``: a crash mid-write
        leaves the previous file at ``path`` as it was. The updater state
        goes in when ``save_updater`` and the model has any."""
        from deeplearning4j_tpu_torch.nn.multilayer import flatten_tensors

        sync = getattr(model, "_opt_state_sync", None)
        if sync is not None:
            sync()
        tmp = atomic_tmp_path(path)
        try:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr(CONFIG_ENTRY, model.conf.to_json())
                z.writestr(COEFFICIENTS_ENTRY,
                           model.params_flat().astype("<f4").tobytes())
                if save_updater and getattr(model, "opt_state_", None) is not None:
                    z.writestr(UPDATER_ENTRY,
                               model.opt_state_flat().astype("<f4").tobytes())
                z.writestr(STATE_ENTRY, flatten_tensors(
                    _state_groups(model.state_)).astype("<f4").tobytes())
                z.writestr(META_ENTRY, json.dumps(_build_meta(model)))
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @staticmethod
    def _restore(path: str, conf_cls, net_cls, load_updater: bool, device):
        from deeplearning4j_tpu_torch.nn.multilayer import unflatten_tensors

        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            missing = {CONFIG_ENTRY, COEFFICIENTS_ENTRY} - names
            if missing:
                raise ValueError(
                    f"{path!r} is not a model checkpoint: required entries "
                    f"{sorted(missing)} are missing (zip contains {sorted(names)})")
            net = net_cls(conf_cls.from_json(z.read(CONFIG_ENTRY).decode()))
            net.init(device=device)
            net.set_params_flat(np.frombuffer(z.read(COEFFICIENTS_ENTRY), dtype="<f4"))
            if load_updater and UPDATER_ENTRY in names:
                net.set_opt_state_flat(np.frombuffer(z.read(UPDATER_ENTRY), dtype="<f4"))
            if STATE_ENTRY in names:
                vec = np.frombuffer(z.read(STATE_ENTRY), dtype="<f4")
                groups = _state_groups(net.state_)
                expected = sum(t.numel() for g in groups for t in g.values())
                if vec.size == expected:
                    new = unflatten_tensors(groups, vec)
                    if isinstance(net.state_, dict):
                        net.state_ = dict(zip(sorted(net.state_), new))
                    else:
                        net.state_ = new
                else:
                    # the layer-state layout changed since the zip was
                    # written: keep the fresh state, as the reference does
                    warnings.warn(
                        f"checkpoint layer-state size {vec.size} != current "
                        f"layout {expected}; keeping freshly initialized layer "
                        "state", stacklevel=3)
            if META_ENTRY in names:
                meta = json.loads(z.read(META_ENTRY).decode())
                net.iteration = int(meta.get("iteration", 0))
                net.epoch = int(meta.get("epoch", 0))
                _restore_fault_state(net, meta)
        return net

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True,
                                    device=None):
        """The MultiLayerNetwork in ``path``, on ``device`` (default the
        CUDA card)."""
        from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return ModelSerializer._restore(path, MultiLayerConfiguration,
                                        MultiLayerNetwork, load_updater, device)

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True,
                                  device=None):
        """The ComputationGraph in ``path``, on ``device`` (default the CUDA
        card)."""
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ModelSerializer._restore(path, ComputationGraphConfiguration,
                                        ComputationGraph, load_updater, device)

    @staticmethod
    def checkpoint_meta(path: str) -> dict:
        """A peek at a checkpoint without restoring it: ``meta.json`` plus
        ``conf_json`` (the configuration entry) and ``entries``."""
        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            missing = {CONFIG_ENTRY, COEFFICIENTS_ENTRY} - names
            if missing:
                raise ValueError(
                    f"{path!r} is not a model checkpoint: required entries "
                    f"{sorted(missing)} are missing")
            meta = json.loads(z.read(META_ENTRY).decode()) if META_ENTRY in names else {}
            meta["conf_json"] = z.read(CONFIG_ENTRY).decode()
            meta["entries"] = sorted(names)
        return meta


def _build_meta(model) -> dict:
    """``meta.json``: the counters, the model type, where it was written,
    the fault guard's state and the dropout RNG's position."""
    device = getattr(model, "device", None)
    meta = {
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
        "model_type": type(model).__name__,
        "framework": "deeplearning4j_tpu_torch",
        "topology": {"n_devices": 1,
                     "backend": "cpu" if device is None else torch.device(device).type},
    }
    if getattr(model, "noise_seed", None) is not None:
        meta["dropout_noise"] = {"seed": int(model.noise_seed),
                                 "position": int(model.iteration)}
    fstate = getattr(model, "fault_state_", None)
    if fstate is not None:
        meta["fault_state"] = {k: (float(v) if v.is_floating_point() else int(v))
                               for k, v in fstate.items()}
    return meta


def _restore_fault_state(net, meta: dict) -> None:
    """The inverse of :func:`_build_meta`'s ``fault_state`` and
    ``dropout_noise`` (a zip without them leaves the fresh model's; the
    position is the restored iteration)."""
    noise = meta.get("dropout_noise")
    if noise:
        net.noise_seed = int(noise["seed"])
    fs = meta.get("fault_state")
    if not fs:
        return

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=net.device)

    st = {"bad_count": i32(fs.get("bad_count", 0)), "consec": i32(fs.get("consec", 0)),
          "good_count": i32(fs.get("good_count", net.iteration))}
    if "loss_scale" in fs:
        st["loss_scale"] = torch.tensor(float(fs["loss_scale"]), dtype=torch.float32,
                                        device=net.device)
        st["scale_good"] = i32(fs.get("scale_good", 0))
    net.fault_state_ = st


class ModelGuesser:
    """Sniff a saved file and restore it as the model type it holds."""

    @staticmethod
    def load_model_guess(path: str, device=None):
        try:
            with zipfile.ZipFile(path, "r") as z:
                names = z.namelist()
                meta = json.loads(z.read(META_ENTRY).decode()) if META_ENTRY in names else {}
        except zipfile.BadZipFile as e:
            raise ValueError(f"Cannot identify model format for {path!r}: not a "
                             f"readable zip ({e})") from e
        if CONFIG_ENTRY in names and COEFFICIENTS_ENTRY in names:
            if meta.get("model_type", "MultiLayerNetwork") == "ComputationGraph":
                return ModelSerializer.restore_computation_graph(path, device=device)
            return ModelSerializer.restore_multi_layer_network(path, device=device)
        raise ValueError(
            f"Cannot identify model format for {path!r}: expected checkpoint "
            f"entries [{CONFIG_ENTRY!r}, {COEFFICIENTS_ENTRY!r}] but the zip "
            f"contains {sorted(names)}")
