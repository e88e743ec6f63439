#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/nn/ops/
csrc`` (phase 1), holds each forward kernel (phase 2) and each backward
kernel (phase 2b) against its plain PyTorch version at every ResNet-50 shape
it runs, serves a full-width bf16 ResNet-50 (random weights from a seed)
through ``InferenceEngine`` (phase 3), and trains it with
``ComputationGraph.fit`` (phase 4): gradients against the plain path on the
card, the kernel launches of each train step, five steps whose score falls,
and the train speed. Each phase prints one or more lines; any failure
raises, and the script exits nonzero. The last three lines are the
kernels' JSON summary, the card's name and power limit (as ``nvidia-smi``
prints them), and
``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.

Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import functools
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
TRAIN_LR = 1e-3               # Nesterovs(TRAIN_LR, 0.9); the zoo's 0.1 diverges
TRAIN_STEPS = 5               # the train phase's main path: fit steps on one batch
TIMED_STEPS = 10              # train steps timed after the main path
# phase 4 gradients, per tensor: ||g_k - g_p|| <= max(GRAD_REL_TOL ||g_p||,
# GRAD_NOISE_FACTOR ||g_p - g_f32||), and over the tensors the median of
# ||g_k - g_f32|| / ||g_p - g_f32|| <= GRAD_F32_MEDIAN (k: kernel path, p: plain
# path, both bf16; f32: the plain path in f32). bf16 rounding alone moves the
# gradients of this network by ~40% (median over tensors), so the kernel path
# is held to be no further from f32 than the plain path is (PERF.md).
GRAD_REL_TOL = 5e-2
GRAD_NOISE_FACTOR = 3.0
GRAD_F32_MEDIAN = 1.25
REF = "deeplearning4j_tpu/nn/ops/fused_conv.py"
CSRC = "deeplearning4j_tpu_torch/nn/ops/csrc"
# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "pw_conv": (f"{CSRC}/fused_conv.cu", f"{REF}:87"),
    "conv3x3": (f"{CSRC}/fused_conv.cu", f"{REF}:307"),
    "pw_conv_dx": (f"{CSRC}/fused_conv_bwd.cu", f"{REF}:107"),
    "pw_conv_dw": (f"{CSRC}/fused_conv_bwd.cu", f"{REF}:138"),
    "conv3x3_dx": (f"{CSRC}/fused_conv_bwd.cu", f"{REF}:330"),
    "conv3x3_dw": (f"{CSRC}/fused_conv_bwd.cu", f"{REF}:363"),
}

# (Cin, Cout, H=W, launches in one ResNet-50 forward; a train step's backward
# launches each backward kernel as often)
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


def shape_cases():
    """(op, Cin, Cout, H=W, launches per forward, batch): the 19 ResNet-50
    shapes at batch 32, then ragged cases: batch 1 at 7x7 (M = 49) and
    channel counts off the tile."""
    cases = [("pw_conv", ci, co, hw, n, BATCH) for ci, co, hw, n in PW_CASES]
    cases += [("conv3x3", c, c, hw, n, BATCH) for c, hw, n in C3_CASES]
    return cases + [
        ("pw_conv", 1024, 512, 7, 0, 1), ("pw_conv", 2048, 512, 7, 0, 1),
        ("pw_conv", 512, 2048, 7, 0, 1), ("conv3x3", 512, 512, 7, 0, 1),
        ("pw_conv", 36, 70, 13, 0, 3), ("conv3x3", 36, 70, 9, 0, 2)]


def case_inputs(gen, op, cin, cout, hw, batch):
    """Seeded (x, scale, shift, w) of one case, and its geometry: pixel
    count m and taps (1 or 9)."""
    m = batch * hw * hw
    if op == "pw_conv":
        return make_inputs(gen, (m, cin), (cin, cout), cin), m, 1
    return (make_inputs(gen, (batch, hw, hw, cin), (3, 3, cin, cout), 9 * cin),
            m, 9)


def kernels_phase(fc):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, summary = [], {}
    for op, cin, cout, hw, count, batch in shape_cases():
        (x, s, t, w), m, taps = case_inputs(gen, op, cin, cout, hw, batch)
        flops = 2.0 * m * taps * cin * cout
        wbytes = taps * cin * cout * 2
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
        summary[op] = summarize([{**r, "max_abs_err": r["y_max_abs_err"]}
                                 for r in rows if r["op"] == op])
    return rows, summary


def summarize(rows):
    """One kernel's rows -> its times summed over the launches of one
    forward (or backward) at the 19 shapes, and its worst error."""
    mine = [r for r in rows if r["launches_per_forward"]]
    weight = {b: sum(r["launches_per_forward"] * r["bound_ms"] for r in mine
                     if r["bound_by"] == b) for b in ("bytes", "operations")}
    out = {key: sum(r["launches_per_forward"] * r[key] for r in mine)
           for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    out["bound_by"] = max(weight, key=weight.get)
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def bwd_case(fc, gen, op, x, s, t, w):
    """The forward's bf16 y as z, and seeded cotangents: dz, and a nonzero
    dstats (the downstream BN's gradient through the statistics)."""
    fwd = fc.pw_conv_plain if op == "pw_conv" else fc.conv3x3_plain
    z, _ = fwd(x, s, t, w, True)
    cout = w.shape[-1]
    dz = (torch.randn(tuple(z.shape), generator=gen, device="cuda") * 0.1
          ).to(torch.bfloat16)
    dst = torch.stack([torch.randn(cout, generator=gen, device="cuda") * 0.01,
                       torch.randn(cout, generator=gen, device="cuda") * 0.002])
    return x, s, t, w, z, dz, dst


def _transposed_conv(g, w):
    """sum over taps and Cout of g (N, H, W, Cout) with the flipped taps of
    w (3, 3, Cin, Cout): the 3x3 SAME conv's input gradient, f32."""
    return F.conv2d(g.permute(0, 3, 1, 2), w.flip(0, 1).permute(2, 3, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def check_bwd_case(fc, op, args, relu_in):
    """Backward kernels vs their plain versions on the same inputs.

    dx and dW: one bf16 rounding step plus the worst-case f32
    summation-order difference over the product's depth K (Cout or 9*Cout
    for dx, scaled by |scale|; the pixel count for dW):
    |k - p| <= 2^-7|p| + 2K*2^-24*sum|terms|.
    dscale, dshift: the statistics tolerance of phase 2 over their terms
    (du*x, du), 1e-3 + 1e-4|p| + STATS_SUM_TOL*sum|terms|, plus the dx
    bound's f32 difference of du carried through the sums."""
    x, s, t, w, z, dz, dst = args
    pw = op == "pw_conv"
    kdx, kdw = ((fc.pw_conv_bwd_dx, fc.pw_conv_bwd_dw) if pw
                else (fc.conv3x3_bwd_dx, fc.conv3x3_bwd_dw))
    pdx, pdw = ((fc.pw_conv_bwd_dx_plain, fc.pw_conv_bwd_dw_plain) if pw
                else (fc.conv3x3_bwd_dx_plain, fc.conv3x3_bwd_dw_plain))
    dx, ds, dt = kdx(*args, relu_in)
    dw = kdw(*args, relu_in)
    dx_p, ds_p, dt_p = pdx(*args, relu_in)
    dw_p = pdw(*args, relu_in)
    torch.cuda.synchronize()

    wf = w.float()
    g = fc._dz_eff(x, z, dz, dst)                       # bf16-exact, f32
    xn = fc._fold(x, s, t, relu_in).to(torch.bfloat16).float()
    if pw:
        k_dx, dxn, mag_dxn = w.shape[1], g @ wf.T, g.abs() @ wf.abs().T
        k_dw, mag_dw = x.shape[0], xn.abs().T @ g.abs()
    else:
        k_dx = 9 * w.shape[3]
        dxn, mag_dxn = _transposed_conv(g, wf), _transposed_conv(g.abs(), wf.abs())
        k_dw = x.shape[0] * x.shape[1] * x.shape[2]
        one, zero = torch.ones_like(s), torch.zeros_like(t)
        mag_dw = fc.conv3x3_bwd_dw_plain(xn.abs().to(torch.bfloat16), one, zero, wf,
                                         torch.zeros_like(z), g.abs().to(torch.bfloat16),
                                         torch.zeros_like(dst), False)
    d_du = 2 * k_dx * F32_EPS * mag_dxn                 # f32 order, per du
    tol_dx = BF16_STEP * dx_p.float().abs() + d_du * s.abs()
    tol_dw = BF16_STEP * dw_p.float().abs() + 2 * k_dw * F32_EPS * mag_dw
    xf = x.float()
    u = xf * s + t
    du = torch.where(u > 0, dxn, torch.zeros_like(dxn)) if relu_in else dxn
    dims = tuple(range(x.dim() - 1))
    tol_ds = (1e-3 + 1e-4 * ds_p.abs() + STATS_SUM_TOL * (du * xf).abs().sum(dims)
              + (d_du * xf.abs()).sum(dims))
    tol_dt = 1e-3 + 1e-4 * dt_p.abs() + STATS_SUM_TOL * du.abs().sum(dims) + d_du.sum(dims)
    out, ok = {}, True
    for name, got, want, tol in (("dx", dx, dx_p, tol_dx), ("dw", dw, dw_p, tol_dw),
                                 ("dscale", ds, ds_p, tol_ds),
                                 ("dshift", dt, dt_p, tol_dt)):
        err = (got.float() - want.float()).abs()
        out[f"{name}_max_abs_err"] = float(err.max())
        out[f"{name}_err_over_tol"] = float((err / tol).max())
        ok = ok and bool((err <= tol).all()) and bool(torch.isfinite(got.float()).all())
    out["ok"] = ok
    return out


def backward_phase(fc):
    """Phase 2b: the four backward kernels against their plain versions at
    the shapes of phase 2, both relu_in, a nonzero dstats; times of each
    kernel, its plain version and the library call at the 19 shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for op, cin, cout, hw, count, batch in shape_cases():
        (x, s, t, w), m, taps = case_inputs(gen, op, cin, cout, hw, batch)
        args = bwd_case(fc, gen, op, x, s, t, w)
        checks = [check_bwd_case(fc, op, args, r) for r in (False, True)]
        row = {"op": op, "cin": cin, "cout": cout, "hw": hw, "batch": batch,
               "launches_per_forward": count,
               **{k: max(c[k] for c in checks) for k in checks[0] if k != "ok"},
               "ok": all(c["ok"] for c in checks)}
        line = (f"phase 2b backward {op} {cin}->{cout} @{hw}x{hw} batch {batch}: "
                + " ".join(f"{n} max_abs_err {row[f'{n}_max_abs_err']:.3g} "
                           f"(err/tol {row[f'{n}_err_over_tol']:.3g})"
                           for n in ("dx", "dw", "dscale", "dshift")))
        if count:
            flops = 2.0 * m * taps * cin * cout
            x_b, io_b = m * cin * 2 + 2 * cin * 4, 2 * m * cout * 2 + 2 * cout * 4
            w_b = taps * cin * cout * 2
            pw = op == "pw_conv"
            dz = args[5]
            if pw:
                lib_dx = functools.partial(torch.matmul, dz, w.t())
                lib_dw = functools.partial(torch.matmul, x.t(), dz)
            else:
                xc, dzc = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
                wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib_dx = functools.partial(torch.nn.grad.conv2d_input, xc.shape, wc, dzc,
                                           padding=1)
                lib_dw = functools.partial(torch.nn.grad.conv2d_weight, xc, wc.shape, dzc,
                                           padding=1)
            for kind, kern, plain, lib, nbytes in (
                    ("dx", fc.pw_conv_bwd_dx if pw else fc.conv3x3_bwd_dx,
                     fc.pw_conv_bwd_dx_plain if pw else fc.conv3x3_bwd_dx_plain,
                     lib_dx, x_b + w_b + io_b + x_b),
                    ("dw", fc.pw_conv_bwd_dw if pw else fc.conv3x3_bwd_dw,
                     fc.pw_conv_bwd_dw_plain if pw else fc.conv3x3_bwd_dw_plain,
                     lib_dw, x_b + io_b + w_b)):
                row[f"{kind}_kernel_ms"] = time_ms(lambda: kern(*args, True))
                row[f"{kind}_plain_ms"] = time_ms(lambda: plain(*args, True))
                row[f"{kind}_library_ms"] = time_ms(lib)
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(flops, nbytes)
                line += (f"; {kind} kernel_ms {row[f'{kind}_kernel_ms']:.4f} "
                         f"plain_ms {row[f'{kind}_plain_ms']:.4f} "
                         f"bound_ms {row[f'{kind}_bound_ms']:.4f} "
                         f"({row[f'{kind}_bound_by']}) "
                         f"library_ms {row[f'{kind}_library_ms']:.4f}")
        rows.append(row)
        print(f"{line} {'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            raise AssertionError(f"{op} backward disagrees with its plain version: {row}")
    summary = {}
    for op in ("pw_conv", "conv3x3"):
        for kind in ("dx", "dw"):
            summary[f"{op}_{kind}"] = summarize([
                {"launches_per_forward": r["launches_per_forward"],
                 "max_abs_err": r[f"{kind}_max_abs_err"],
                 **{key: r.get(f"{kind}_{key}") for key in
                    ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                for r in rows if r["op"] == op])
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


def resnet50(**kwargs):
    """The full-width bf16 fused ResNet-50 on the card, seeded, randomized
    BN; and its twin on the plain path (``use_pallas=False``) holding the
    same tensors. Neither path changes a tensor in place."""
    from deeplearning4j_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, height=224, width=224, fused_pallas=True,
                     compute_dtype="bfloat16", seed=SEED, **kwargs).init()
    randomize_bn(model, SEED)
    plain_conf = copy.deepcopy(model.conf)
    n_blocks = 0
    for v in plain_conf.vertices.values():
        layer = getattr(v, "layer", None)
        if type(layer).__name__ == "FusedResNetBottleneck":
            layer.use_pallas = False
            n_blocks += 1
    if n_blocks != 16:
        raise AssertionError(f"expected 16 fused bottlenecks, found {n_blocks}")
    return model, twin(model, plain_conf)


def twin(model, conf):
    """A graph of ``conf`` holding ``model``'s tensors."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    other = ComputationGraph(conf)
    other.params_, other.state_, other.device = model.params_, model.state_, model.device
    return other


def serve_phase(fc, card: str):
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    t0 = time.perf_counter()
    model, plain = resnet50()
    init_s = time.perf_counter() - t0

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


# kernel launches of one ResNet-50 train step: each fused conv's forward,
# and its dx and dW kernels in the backward
STEP_LAUNCHES = {"pw_conv": 36, "conv3x3": 16, "pw_conv_dx": 36, "pw_conv_dw": 36,
                 "conv3x3_dx": 16, "conv3x3_dw": 16}


def _finite(model) -> bool:
    return all(bool(torch.isfinite(p).all())
               for d in model.params_.values() for p in d.values())


def _timed_steps(model, ds) -> float:
    """Host seconds per fit step over TIMED_STEPS steps, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        model.fit(ds)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TIMED_STEPS


def train_phase(fc, card: str):
    """Phase 4: ComputationGraph.fit on the full-width bf16 ResNet-50 with
    Nesterovs(TRAIN_LR, 0.9), one seeded batch of 32."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.updaters import Nesterovs

    t0 = time.perf_counter()
    model, plain = resnet50(updater=Nesterovs(TRAIN_LR, 0.9))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 3)
    x = rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)]
    ds = DataSet(x, y)

    # (a) gradients: the kernel path against the plain path, same weights;
    # the plain path in f32 measures how far bf16 rounding alone moves them
    grads, score = model.compute_gradient_and_score(ds)
    ref, ref_score = plain.compute_gradient_and_score(ds)
    f32_conf = copy.deepcopy(plain.conf)
    f32_conf.global_conf.compute_dtype = None
    g32, score32 = twin(model, f32_conf).compute_gradient_and_score(ds)
    rels, ratios, to_f32, grads_finite = {}, {}, {}, True
    for v in ref:
        for k in ref[v]:
            a, b, c = grads[v][k].float(), ref[v][k].float(), g32[v][k]
            grads_finite = grads_finite and bool(torch.isfinite(a).all())
            name = f"{v}/{k}"
            rels[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            ratios[name] = float((a - b).norm() / (b - c).norm().clamp_min(1e-30))
            to_f32[name] = float((a - c).norm() / (b - c).norm().clamp_min(1e-30))
    del grads, ref, g32
    score_rel = abs(score - ref_score) / abs(ref_score)
    grads_ok = grads_finite and score_rel <= 1e-3 and all(
        rels[n] <= GRAD_REL_TOL or ratios[n] <= GRAD_NOISE_FACTOR for n in rels)
    grads_ok = grads_ok and float(np.median(list(to_f32.values()))) <= GRAD_F32_MEDIAN

    def q(d):
        """median, p90, max, and the three largest"""
        top = sorted(d.items(), key=lambda kv: -kv[1])[:3]
        return ([round(float(v), 4) for v in np.quantile(list(d.values()), [0.5, 0.9, 1.0])]
                + [(n, round(v, 4)) for n, v in top])

    print(f"phase 4 gradients: ResNet-50 1000 classes 224x224 bf16 fused, batch {BATCH}, "
          f"init {init_s:.1f}s; over {len(rels)} tensors (k kernel path, p plain path, "
          f"f32 plain path in f32): ||g_k - g_p|| / ||g_p|| {q(rels)}; "
          f"||g_k - g_p|| / ||g_p - g_f32|| {q(ratios)} (each <= {GRAD_NOISE_FACTOR} "
          f"where the first > {GRAD_REL_TOL}); ||g_k - g_f32|| / ||g_p - g_f32|| "
          f"{q(to_f32)} (median <= {GRAD_F32_MEDIAN}); ||g_p - g_f32|| / ||g_p|| "
          f"median {float(np.median([rels[n] / max(ratios[n], 1e-30) for n in rels])):.4g}; "
          f"score {score:.6g} vs plain {ref_score:.6g} (rel {score_rel:.3g}, tol 1e-3), "
          f"f32 {score32:.6g} {'ok' if grads_ok else 'FAIL'}", flush=True)

    # (b, c) the main path: counts from 0 just before, read just after
    fc.reset_launch_counts()
    scores, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = dict(fc.launch_counts)
        model.fit(ds)
        per_step.append({k: fc.launch_counts[k] - before.get(k, 0)
                         for k in fc.launch_counts})
        scores.append(model.score())
    main_launches = dict(fc.launch_counts)
    print(f"phase 4 steps: {TRAIN_STEPS} fit steps, Nesterovs({TRAIN_LR}, 0.9), l2 1e-4; "
          f"scores {[round(s, 5) for s in scores]}; launches per step {per_step[0]}; "
          f"main-path launches {main_launches}", flush=True)

    fc.reset_launch_counts()
    plain_scores = []
    for _ in range(TRAIN_STEPS):
        plain.fit(ds)
        plain_scores.append(plain.score())
    plain_launches = sum(fc.launch_counts.values())
    print(f"phase 4 plain path: scores {[round(s, 5) for s in plain_scores]}, "
          f"kernel launches {plain_launches}", flush=True)

    # (d) speed, after the warm-up of the steps above
    torch.cuda.reset_peak_memory_stats()
    step_s = _timed_steps(model, ds)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    plain_step_s = _timed_steps(plain, ds)
    print(f"phase 4 speed: {BATCH / step_s:.1f} train images/s at batch {BATCH} "
          f"({step_s * 1e3:.2f} ms per step, host clock, synchronized, {TIMED_STEPS} "
          f"steps); plain path {BATCH / plain_step_s:.1f} images/s "
          f"({plain_step_s * 1e3:.2f} ms); peak memory {peak_gib:.2f} GiB; on {card}",
          flush=True)

    failed = []
    if not grads_ok:
        failed.append("gradients or score disagree with the plain path")
    if any(s != STEP_LAUNCHES for s in per_step):
        failed.append(f"a train step launched {per_step}, expected {STEP_LAUNCHES}")
    if plain_launches:
        failed.append("the plain path launched kernels")
    for name, m, sc in (("kernel", model, scores), ("plain", plain, plain_scores)):
        if not _finite(m) or not all(math.isfinite(s) for s in sc) or not sc[-1] < sc[0]:
            failed.append(f"{name} path: not finite, or score {sc[-1]} not below {sc[0]}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"main_launches": main_launches, "launches_per_step": per_step[0],
            "grad_rel_err": rels, "grad_err_over_bf16_noise": ratios,
            "grad_f32_distance_ratio": to_f32, "score": score, "plain_score": ref_score,
            "f32_score": score32,
            "scores": scores, "plain_scores": plain_scores,
            "images_per_s": BATCH / step_s, "ms_per_step": step_s * 1e3,
            "plain_images_per_s": BATCH / plain_step_s,
            "plain_ms_per_step": plain_step_s * 1e3, "peak_mem_gib": peak_gib,
            "lr": TRAIN_LR}


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
    for lib in ("fused_conv", "fused_conv_bwd"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1 ptxas {lib}: {line.strip()}", flush=True)

    rows, summary = kernels_phase(fc)
    bwd_rows, bwd_summary = backward_phase(fc)
    summary.update(bwd_summary)
    serve = serve_phase(fc, card)
    train = train_phase(fc, card)

    # launches: the train phase's main path (TRAIN_STEPS fit steps); times:
    # summed over one batch-32 forward (or backward) at the 19 shapes
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train["main_launches"].get(name, 0),
            "launches_per_train_step": train["launches_per_step"].get(name, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build_s": build_s,
                   "cases": rows, "backward_cases": bwd_rows, "summary": summary,
                   "serve": serve, "train": train, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
