#!/usr/bin/env python3
"""Where the serving time goes: profile the PyTorch port's ResNet-50 engine.

Run from the repository root on a CUDA card::

    python3 scripts/torch_serve_profile.py

Builds the same model as ``chip_smoke.py``'s serve phase (full-width bf16
ResNet-50, 1000 classes, 224x224, fused bottlenecks, seeded random weights
with randomized BN), warms the engine up, then profiles requests of 32 rows
and of 1 row with ``torch.profiler`` (CPU + CUDA activities). It prints, per
request size: host milliseconds per request, device busy milliseconds (the
sum of device kernel and copy time), the device's idle share, kernel
launches per request and the top device-time entries by name. The full
tables go to ``chiprun_out/serve_profile.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (randomize_bn, SEED, smi_line)


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_requests(engine, x, reps: int):
    engine.infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer(x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for evt in prof.key_averages():
        dev = _device_time_us(evt)
        if dev > 0 and evt.device_type.name in ("CUDA", "PrivateUse1"):
            rows.append({"name": evt.key, "device_us_per_request": dev / reps,
                         "count_per_request": evt.count / reps})
    rows.sort(key=lambda r: -r["device_us_per_request"])
    busy_ms = sum(r["device_us_per_request"] for r in rows) / 1e3
    launches = sum(r["count_per_request"] for r in rows)
    return {"host_ms_per_request": host_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / host_ms),
            "device_ops_per_request": launches, "top": rows[:40]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    card = chip_smoke.smi_line()
    model = ResNet50(num_classes=1000, height=224, width=224, fused_pallas=True,
                     compute_dtype="bfloat16", seed=chip_smoke.SEED).init()
    chip_smoke.randomize_bn(model, chip_smoke.SEED)
    engine = InferenceEngine(model, buckets=[1, 8, 32])
    engine.warmup()
    x = np.random.default_rng(chip_smoke.SEED).standard_normal(
        (32, 224, 224, 3)).astype(np.float32)
    out = {"card": card, "torch": torch.__version__}
    for n, reps in ((32, 10), (1, 20)):
        r = profile_requests(engine, x[:n], reps)
        out[f"rows_{n}"] = r
        print(f"rows {n}: host {r['host_ms_per_request']:.3f} ms/request, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops_per_request']:.0f} device ops/request, on {card}",
              flush=True)
        for row in r["top"][:12]:
            print(f"  {row['device_us_per_request']:10.1f} us  x{row['count_per_request']:6.1f}  "
                  f"{row['name'][:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "serve_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
