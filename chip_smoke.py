#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/nn/ops/
csrc``, holds each kernel against its plain PyTorch version at every
ResNet-50 shape it runs, then serves a full-width bf16 ResNet-50 (random
weights from a seed) through ``InferenceEngine`` and checks the answers.
Each phase prints one or more lines; any failure raises, and the script
exits nonzero. The last three lines are the kernels' JSON summary, the
card's name and power limit (as ``nvidia-smi`` prints them), and
``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.

Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 20261016
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
F32_EPS = 2.0 ** -24
BF16_STEP = 2.0 ** -7         # one bf16 rounding step, relative
STATS_SUM_TOL = 1e-5          # f32 summation-order allowance, x sum of |terms|
SERVE_PROB_TOL = 0.03         # max |p_kernel - p_plain| of the served softmax
REPLACES = {
    "pw_conv": "deeplearning4j_tpu/nn/ops/fused_conv.py:87",
    "conv3x3": "deeplearning4j_tpu/nn/ops/fused_conv.py:307",
}
SOURCE = "deeplearning4j_tpu_torch/nn/ops/csrc/fused_conv.cu"

# (Cin, Cout, H=W, launches in one ResNet-50 forward)
PW_CASES = [
    (64, 64, 56, 1), (64, 256, 56, 4), (256, 64, 56, 2),
    (256, 128, 28, 1), (128, 512, 28, 4), (256, 512, 28, 1), (512, 128, 28, 3),
    (512, 256, 14, 1), (256, 1024, 14, 6), (512, 1024, 14, 1), (1024, 256, 14, 5),
    (1024, 512, 7, 1), (512, 2048, 7, 3), (1024, 2048, 7, 1), (2048, 512, 7, 2),
]
# (C, H=W, launches in one forward); the 3x3 conv keeps the channel count
C3_CASES = [(64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3)]
BATCH = 32


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean device time of one call, by CUDA events over a timed loop."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(5, 20.0 / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_case(fc, op, x, s, t, w, relu_in):
    """Kernel vs plain version on the same inputs. y: one bf16 rounding step
    plus the worst-case f32 summation-order difference over depth K; stats:
    1e-3 + 1e-4|p| + STATS_SUM_TOL * sum of |terms|."""
    kern = fc.pw_conv if op == "pw_conv" else fc.conv3x3
    plain = fc.pw_conv_plain if op == "pw_conv" else fc.conv3x3_plain
    yk, sk = kern(x, s, t, w, relu_in)
    yp, sp = plain(x, s, t, w, relu_in)
    torch.cuda.synchronize()
    u = fc._fold(x, s, t, relu_in).to(torch.bfloat16).float().abs()
    if op == "pw_conv":
        k = x.shape[1]
        mag = u @ w.float().abs()
    else:
        k = 9 * x.shape[3]
        mag = F.conv2d(u.permute(0, 3, 1, 2), w.float().abs().permute(3, 2, 0, 1),
                       padding=1).permute(0, 2, 3, 1)
    ykf, ypf = yk.float(), yp.float()
    err = (ykf - ypf).abs()
    tol = BF16_STEP * ypf.abs() + 2 * k * F32_EPS * mag
    y_ok = bool((err <= tol).all())
    yp2 = ypf.reshape(-1, ypf.shape[-1])
    terms = torch.stack([yp2.abs().sum(0), (yp2 * yp2).sum(0)])
    s_err = (sk - sp).abs()
    s_tol = 1e-3 + 1e-4 * sp.abs() + STATS_SUM_TOL * terms
    s_ok = bool((s_err <= s_tol).all())
    return {
        "y_max_abs_err": float(err.max()),
        "y_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "y_over_one_bf16_step": int((err > BF16_STEP * ypf.abs()).sum()),
        "stats_max_abs_err": float(s_err.max()),
        "stats_err_over_tol": float((s_err / s_tol).max()),
        "ok": y_ok and s_ok and bool(torch.isfinite(yk.float()).all()),
    }


def make_inputs(gen, x_shape, w_shape, fan_in):
    dev = "cuda"
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    cin = x_shape[-1]
    s = (torch.randn(cin, generator=gen, device=dev) * 0.2 + 1.0).float()
    t = (torch.randn(cin, generator=gen, device=dev) * 0.1).float()
    w = (torch.randn(w_shape, generator=gen, device=dev)
         * math.sqrt(2.0 / fan_in)).to(torch.bfloat16)
    return x, s, t, w


def kernels_phase(fc):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, summary = [], {}
    cases = [("pw_conv", ci, co, hw, n, BATCH) for ci, co, hw, n in PW_CASES]
    cases += [("conv3x3", c, c, hw, n, BATCH) for c, hw, n in C3_CASES]
    # ragged: batch 1 at 7x7 (M = 49) and channel counts off the tile
    ragged = [("pw_conv", 1024, 512, 7, 0, 1), ("pw_conv", 2048, 512, 7, 0, 1),
              ("pw_conv", 512, 2048, 7, 0, 1), ("conv3x3", 512, 512, 7, 0, 1),
              ("pw_conv", 36, 70, 13, 0, 3), ("conv3x3", 36, 70, 9, 0, 2)]
    for op, cin, cout, hw, count, batch in cases + ragged:
        if op == "pw_conv":
            m = batch * hw * hw
            x, s, t, w = make_inputs(gen, (m, cin), (cin, cout), cin)
            flops = 2.0 * m * cin * cout
            wbytes = cin * cout * 2
        else:
            m = batch * hw * hw
            x, s, t, w = make_inputs(gen, (batch, hw, hw, cin), (3, 3, cin, cout),
                                     9 * cin)
            flops = 2.0 * m * 9 * cin * cout
            wbytes = 9 * cin * cout * 2
        nbytes = m * cin * 2 + 2 * cin * 4 + wbytes + m * cout * 2 + 2 * cout * 4
        checks = [check_case(fc, op, x, s, t, w, r) for r in (False, True)]
        row = {"op": op, "cin": cin, "cout": cout, "hw": hw, "batch": batch,
               "launches_per_forward": count,
               "y_max_abs_err": max(c["y_max_abs_err"] for c in checks),
               "y_err_over_tol": max(c["y_err_over_tol"] for c in checks),
               "y_over_one_bf16_step": sum(c["y_over_one_bf16_step"] for c in checks),
               "stats_max_abs_err": max(c["stats_max_abs_err"] for c in checks),
               "stats_err_over_tol": max(c["stats_err_over_tol"] for c in checks),
               "ok": all(c["ok"] for c in checks)}
        if count:
            kern = fc.pw_conv if op == "pw_conv" else fc.conv3x3
            plain = fc.pw_conv_plain if op == "pw_conv" else fc.conv3x3_plain
            row["kernel_ms"] = time_ms(lambda: kern(x, s, t, w, True))
            row["plain_ms"] = time_ms(lambda: plain(x, s, t, w, True))
            if op == "pw_conv":
                row["library_ms"] = time_ms(lambda: torch.matmul(x, w))
            else:
                xc = x.permute(0, 3, 1, 2)
                wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                row["library_ms"] = time_ms(lambda: F.conv2d(xc, wc, padding=1))
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        rows.append(row)
        timing = (f" kernel_ms {row['kernel_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                  f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) "
                  f"library_ms {row['library_ms']:.4f}") if count else ""
        print(f"phase 2 kernel {op} {cin}->{cout} @{hw}x{hw} batch {batch}: "
              f"y max_abs_err {row['y_max_abs_err']:.3g} "
              f"(err/tol {row['y_err_over_tol']:.3g}; tol = 2^-7|p| + 2K*2^-24*sum|u*w|) "
              f"stats max_abs_err {row['stats_max_abs_err']:.3g} "
              f"(err/tol {row['stats_err_over_tol']:.3g}){timing} "
              f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            raise AssertionError(f"{op} disagrees with its plain version: {row}")
    for op in ("pw_conv", "conv3x3"):
        mine = [r for r in rows if r["op"] == op and r["launches_per_forward"]]
        weight = {b: sum(r["launches_per_forward"] * r["bound_ms"] for r in mine
                         if r["bound_by"] == b) for b in ("bytes", "operations")}
        summary[op] = {
            key: sum(r["launches_per_forward"] * r[key] for r in mine)
            for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
        summary[op]["bound_by"] = max(weight, key=weight.get)
        summary[op]["max_abs_err"] = max(r["y_max_abs_err"] for r in rows
                                         if r["op"] == op)
    return rows, summary


def randomize_bn(model, seed: int) -> None:
    """BN running stats and affine params from the seed, so BN is not the
    identity; the last BN of each residual branch gets a small gamma, which
    keeps the residual stream's scale (and the softmax) unsaturated."""
    g = torch.Generator().manual_seed(seed)

    def uni(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)

    def nrm(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for v in model.layer_names:
        for k in sorted(model.params_[v]):
            t = model.params_[v][k]
            if k.startswith("gamma"):
                small = k == "gamma_c" or v.endswith("_c_bn")
                uni(t, *((0.1, 0.3) if small else (0.5, 1.5)))
            elif k.startswith("beta"):
                nrm(t, 0.1)
        for k in sorted(model.state_[v]):
            t = model.state_[v][k]
            if k.startswith("mean"):
                nrm(t, 0.1)
            elif k.startswith("var"):
                uni(t, 0.5, 1.5)


def serve_phase(fc, card: str):
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    t0 = time.perf_counter()
    model = ResNet50(num_classes=1000, height=224, width=224, fused_pallas=True,
                     compute_dtype="bfloat16", seed=SEED).init()
    randomize_bn(model, SEED)
    init_s = time.perf_counter() - t0
    plain_conf = copy.deepcopy(model.conf)
    n_blocks = 0
    for v in plain_conf.vertices.values():
        layer = getattr(v, "layer", None)
        if type(layer).__name__ == "FusedResNetBottleneck":
            layer.use_pallas = False
            n_blocks += 1
    if n_blocks != 16:
        raise AssertionError(f"expected 16 fused bottlenecks, found {n_blocks}")
    plain = ComputationGraph(plain_conf)
    plain.params_, plain.state_, plain.device = model.params_, model.state_, model.device

    engine = InferenceEngine(model, buckets=[1, 8, 32])
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32)

    # the main path: counts from 0 just before, read just after
    fc.reset_launch_counts()
    warm = engine.warmup()
    r1 = engine.infer(x[:1])
    r7 = engine.infer(x[:7])
    before = dict(fc.launch_counts)
    r32 = engine.infer(x)
    after = dict(fc.launch_counts)
    main_launches = dict(fc.launch_counts)
    per_forward = {k: after.get(k, 0) - before.get(k, 0) for k in ("pw_conv", "conv3x3")}
    print(f"phase 3 serve: ResNet-50 1000 classes 224x224 bf16 fused, init {init_s:.1f}s, "
          f"warmup {warm}, launches in one forward {per_forward}, "
          f"main-path launches {main_launches}", flush=True)
    if per_forward != {"pw_conv": 36, "conv3x3": 16}:
        raise AssertionError(f"one forward launched {per_forward}, expected 36/16")

    for n, r in ((1, r1), (7, r7), (BATCH, r32)):
        if r.shape != (n, 1000) or not np.isfinite(r).all():
            raise AssertionError(f"bad output for {n} rows: {r.shape}")
        dev = float(np.abs(r.sum(1) - 1.0).max())
        if dev > 1e-3:
            raise AssertionError(f"softmax rows do not sum to 1 (max dev {dev})")
    pad_diff = float(max(np.abs(r1 - r32[:1]).max(), np.abs(r7 - r32[:7]).max()))

    ref = plain.output_single(x)
    dp = float(np.abs(r32 - ref).max())
    top2 = np.sort(ref, 1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * dp
    agree = r32.argmax(1) == ref.argmax(1)
    print(f"phase 3 check: rows sum to 1, finite; vs plain path on the card max|dp| "
          f"{dp:.3g} (tol {SERVE_PROB_TOL}), top-1 agreement {int(agree.sum())}/{BATCH} "
          f"({int(decided.sum())} rows with top-2 gap > 2 max|dp|, all of which must agree); "
          f"bucket padding 1/7 vs 32 rows max|dp| {pad_diff:.3g}; "
          f"max prob {float(r32.max(1).mean()):.3f} mean", flush=True)
    if dp > SERVE_PROB_TOL or pad_diff > SERVE_PROB_TOL or not agree[decided].all():
        raise AssertionError("served answers disagree with the plain path")

    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.infer(x)
    t32 = (time.perf_counter() - t0) / iters
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.infer(x[:1])
        lat.append(time.perf_counter() - t0)
    lat_ms = float(np.median(lat) * 1e3)
    print(f"phase 3 speed: {BATCH / t32:.1f} images/s at bucket 32 "
          f"({t32 * 1e3:.2f} ms per request, host clock incl. copies), "
          f"{lat_ms:.2f} ms median latency at bucket 1, on {card}", flush=True)
    return {"main_launches": main_launches, "per_forward": per_forward,
            "images_per_s_b32": BATCH / t32, "ms_per_request_b32": t32 * 1e3,
            "latency_ms_b1": lat_ms, "max_abs_dp_vs_plain": dp,
            "top1_agree": int(agree.sum()), "rows_decided": int(decided.sum()),
            "pad_diff": pad_diff, "warmup": warm}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.ops import build
    from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

    card = smi_line()
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel build {build_s:.1f}s", flush=True)
    for line in build.build_log("fused_conv").splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 1 ptxas: {line.strip()}", flush=True)

    rows, summary = kernels_phase(fc)
    serve = serve_phase(fc, card)

    kernels = []
    for op in ("pw_conv", "conv3x3"):
        s = summary[op]
        kernels.append({
            "name": op, "route": "cuda", "source": SOURCE, "replaces": REPLACES[op],
            "launches": serve["main_launches"].get(op, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build_s": build_s,
                   "cases": rows, "summary": summary, "serve": serve,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
