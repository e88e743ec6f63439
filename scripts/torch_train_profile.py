#!/usr/bin/env python3
"""Where the training time goes: profile the PyTorch port's ResNet-50 train step.

Run from the repository root on a CUDA card::

    python3 scripts/torch_train_profile.py

Builds the model of ``chip_smoke.py``'s train phase (full-width bf16
ResNet-50, 1000 classes, 224x224, fused bottlenecks, seeded random weights
with randomized BN, ``Nesterovs(chip_smoke.TRAIN_LR, 0.9)``), takes two
warm-up ``fit`` steps on one seeded batch of 32, then profiles five more
with ``torch.profiler`` (CPU + CUDA activities). It prints host milliseconds
per step, device busy milliseconds, the device's idle share, device ops per
step and the top device-time entries by name; the full table goes to
``chiprun_out/train_profile.json``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import chip_smoke  # noqa: E402  (the train phase's model, SEED, smi_line)
from torch_serve_profile import profile_calls  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.updaters import Nesterovs

    card = chip_smoke.smi_line()
    model, _ = chip_smoke.resnet50(updater=Nesterovs(chip_smoke.TRAIN_LR, 0.9))
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    x = rng.standard_normal((chip_smoke.BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, chip_smoke.BATCH)]
    ds = DataSet(x, y)
    model.fit(ds)
    r = profile_calls(lambda: model.fit(ds), 5)
    print(f"train step, batch {chip_smoke.BATCH}: host {r['host_ms']:.3f} ms/step, "
          f"device busy {r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
          f"{r['device_ops']:.0f} device ops/step, on {card}", flush=True)
    for row in r["top"][:25]:
        print(f"  {row['device_us']:10.1f} us  x{row['count']:6.1f}  "
              f"{row['name'][:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "train_profile.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "train": r}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
