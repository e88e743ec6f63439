#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/nn/ops/
csrc`` (phase 1), holds each forward kernel (phase 2) and each backward
kernel (phase 2b) against its plain PyTorch version at every ResNet-50 shape
it runs (phase 2 also at the forward's trap cases: the 3x3 halo, images
sharing a block, rows past M, a box past Cin, a misaligned x, reruns bit
for bit; phase 2b both dW kernels' reruns bit for bit; both by device
time beside CUDA events), and the int8 matmul
(phase 2c) at VGG16's and LeNet's head shapes and ragged ones, also against
the f64 product (f32 stays f32), reruns and buckets bit for bit, by device
time beside CUDA events;
serves a full-width bf16 ResNet-50 (random weights from a seed) through
``InferenceEngine`` (phase 3), and trains it with ``ComputationGraph.fit``
(phase 4): gradients against the plain path on the card, the kernel
launches of each train step, five steps whose score falls, and the train
speed; phase 4b trains it again through ``ComputationGraph.fit`` at
``steps_per_call=4`` (deterministic cuDNN): two bundles, each one replay of
a captured CUDA graph, against eight eager steps bit for bit (params,
momentum, BN state, scores), the launches the capture records (four
steps' worth), the kernels by name and count in a profiler trace of one
replay, and train images/s and peak memory, bundled and eager, in turns.
Phase 5 serves a full-width f32 VGG16 (seeded) in an int8-head
engine and an f32 engine; phase 6 drives the entry points: the HTTP server
over the int8 VGG16 engine, ``cli serve --smoke`` on a LeNet checkpoint
written by the port, and ``/reload``. Phase 2d holds the fused LSTM cell
against its plain version at TextGenerationLSTM's shapes (f32, bf16 and the
mixed compute-dtype flow, with and without peepholes), times it by device
time beside CUDA events and ``torch.lstm_cell``, and checks that a row's
bits do not depend on its batch (across the kernel's row tiles) and that
reruns give the same bits. Phase 7 serves a full-width
TextGenerationLSTM (77 characters, two GravesLSTM(256); seeded) through a
32-slot ``GenerationEngine`` (64 requests, half greedy, half sampled):
exact launch counts, a teacher-forced comparison with the plain path on the
card, engine == solo, tokens/s; then a seq-bucketed and an int8-head
``InferenceEngine``; phase 6 adds ``POST /generate`` and ``cli serve
--gen-slots --smoke``. Phase 2e holds the flash-attention forward against its
plain version (the prefill and /predict shapes of the TransformerLM below,
non-causal, segment ids, head dims 32/40/128, f32). Phase 8 serves a
full-width TransformerLM (GPT-2 small's shape, 32,000 tokens, bf16; seeded)
through a 32-slot ``GenerationEngine`` (64 requests, prompts of 20-900
tokens): the flash launches read around every prefill and decode step, a
teacher-forced comparison with plain attention on the card, prefill and
decode against the forward, ``generate_cached`` and a solo engine against
the storm, tokens/s; then ``/predict`` through an ``InferenceEngine``;
phase 6 adds ``POST /generate`` and ``/predict`` to it. Phase 2f holds the
flash-attention backward kernels (dq, dkv) against their plain version at the
train shapes (b 16 x T 512, b 4 x T 2048) and beside them, with two runs
bit-identical. Phase 9 trains a full-width TransformerLM (bench.py's train
config: GPT-2 small's shape, 32,000 tokens, bf16, Adam(3e-4), 16 x 512;
seeded) through ``fit_batch``: one step's gradients against the plain path
on the card, dense and packed (two documents per row), exactly 12 forward,
12 dq and 12 dkv launches per step, ten steps whose loss falls, train
tokens/s at 16 x 512 and 4 x 2048, and logits after training against the
uncached forward. Phase 2g holds the fused Adam of the ZeRO-1 sharded
update against its plain version (the eager ``Adam.apply``), torch.equal on
p, m and v at ResNet-50's and VGG16's flat group sizes and ragged ones, and
times it. Phase 10 trains the full-width ResNet-50 with Adam through
``ParallelWrapper(workers=1, sharded_update=True)`` on a one-rank NCCL group:
one sharded update against the per-layer eager update, bit for bit; five fit
steps with exact launch counts (the fused convs' and one fused Adam per f32
Adam group) and a falling score; a checkpoint written mid-fit restored with
its updater state, whose next step equals the uninterrupted run's; train
images/s; and LeNet through ``MultiLayerNetwork.fit`` and the wrapper,
replicated and sharded, bit for bit. Phase 10b runs phase 10's wrapper at
``steps_per_call=2`` (one captured graph a bundle, the NCCL collectives and
one fused Adam a step inside it, Adam's ``alpha`` from the bundle's device
buffer) against the same wrapper at 1, bit for bit, with its launches, a
profiler trace of one replay and images/s in turns, and LeNet's
``MultiLayerNetwork.fit`` at 4 against 1. On one rank the batch statistics
need no collective, and phases 10 and 10b run none; phase 10b holds a small
BN network whose statistics go through the one-rank NCCL sum anyway, at 2
against 1 with the sums counted eager and captured. Phase 2h holds the shared-training
encoder against a plain version (another selection) at ResNet-50's and
VGG16's flat gradient sizes, with device times beside ``torch.topk``. Phase
10c trains phase 10's model on two spawned ranks sharing the card (gloo on
CUDA tensors, replicated) against this process's one rank: one step's mean
gradient under phase 4's rule, the BN running statistics, the score, and the
same ranks with per-rank statistics farther from it. Phase 11 trains the
zoo's LeNet through ``SharedTrainingMaster``: one step against the step
written out plainly, replicated against sharded (one fused Adam a step),
bundled against single steps, bit for bit, and ms a step. Phase 12 guards
phase 10's ResNet-50 with a fault policy: (a) the guarded step's gradients
(loss scaled by 2^15, unscaled) against the unguarded step's by phase 4's
rule, the device time of the verdict, the unscale and the selects, and
five guarded fit steps with phase 4's launches; (b) the skip guard alone
with NaN injected at step 2 of 5, ``torch.equal`` to a guarded run on the
other four batches, and the guard without faults against an unguarded run;
(b') the same with loss scaling, the scale halved after the poisoned step,
phase 4's rule on the params' displacement against the run without it;
(c) both at ``steps_per_call=5`` with the poison inside the one bundle,
bit-equal to their eager runs with the same fault state; (d) each fused
conv kernel on operands whose sums overflow (non-finite exactly where its
plain version is), and a fit from a loss scale whose step overflows: the
skipped steps keep the params and halve the scale until a step is finite;
(e) the guarded ZeRO-1 wrapper: the poisoned step keeps p, m and v, one
``fused_adam`` a group, k 2 == k 1; (f) the guarded master on LeNet keeps
params and residual; (g) images/s guarded against unguarded, eager and
bundled, in turns. Phase 13 serves phase 3's ResNet-50 through
``ParallelInference`` (``sequential`` and ``inplace`` with 3 replicas
``np.array_equal`` to ``model.output`` under 8 concurrent callers,
``batched`` by phase 3's rule with its dispatches counted), through an
``InferenceEngine`` over ``["cuda:0", "cuda:0"]`` (twice phase 3's conv
launches a bucket-32 dispatch, phase 3's rule against one device), runs
``cli serve --workers 1 --smoke`` and ``--workers`` one more than the cards
(the typed refusal), and times requests/s batched against sequential.
Each phase prints one or more lines;
any failure raises, and the script exits nonzero. The last three lines are the
kernels' JSON summary, the card's name and power limit (as ``nvidia-smi``
prints them), and
``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.

Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 20261016
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 rate of the CUDA cores (no tensor cores)
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
    "int8_matmul": (f"{CSRC}/int8_matmul.cu", "deeplearning4j_tpu/nn/ops/int8_matmul.py:80"),
    "fused_lstm_cell": (f"{CSRC}/fused_lstm.cu", "deeplearning4j_tpu/nn/ops/fused_lstm.py:93"),
    "flash_attention_fwd": (f"{CSRC}/flash_attention.cu",
                            "deeplearning4j_tpu/nn/ops/flash_attention.py:79"),
    "flash_attention_dq": (f"{CSRC}/flash_attention_bwd.cu",
                           "deeplearning4j_tpu/nn/ops/flash_attention.py:125"),
    "flash_attention_dkv": (f"{CSRC}/flash_attention_bwd.cu",
                            "deeplearning4j_tpu/nn/ops/flash_attention.py:166"),
    "fused_adam": (f"{CSRC}/fused_update.cu", "deeplearning4j_tpu/nn/ops/fused_update.py:59"),
}
# VGG16 (1000 classes, 224x224x3): the three dense heads (K, N), the layer
# index of the first one, and the int8 report the engine must give
VGG_HEADS = [(25088, 4096), (4096, 4096), (4096, 1000)]
VGG_FIRST_HEAD = 18
VGG_BYTES_F32 = 4 * sum(k * n for k, n in VGG_HEADS)                    # 494,534,656
VGG_BYTES_INT8 = sum(k * n + 4 * n for k, n in VGG_HEADS)               # 123,670,432
LENET_HEADS = [(2450, 500), (500, 10)]
PAD_TOL = 1e-6                # padding: 7 rows padded to bucket 8 vs the same rows of 8
# across buckets (1 and 7 rows against 32): cuDNN picks its algorithm by the
# batch size (an FFT at 32, implicit GEMMs at 1 and 8), so the f32 summation
# order differs; the f32 bound the CPU tests use on probabilities
BUCKET_TOL = 1e-5
INT8_PLAIN_TOL = 1e-4         # served int8 probabilities vs the plain int8 heads

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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call without the host's launch cost: ``calls``
    calls captured in one CUDA graph, timed by CUDA events over ``replays``
    replays (beside :func:`time_ms`, which a host slower than the kernel
    bounds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()  # an older graph collected inside the capture would end it
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
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
    shapes at batch 32, then ragged cases: batch 1 at 7x7 (M = 49), channel
    counts off the tile, and a 3x3 below one 128-row tile (M = 75)."""
    cases = [("pw_conv", ci, co, hw, n, BATCH) for ci, co, hw, n in PW_CASES]
    cases += [("conv3x3", c, c, hw, n, BATCH) for c, hw, n in C3_CASES]
    return cases + [
        ("pw_conv", 1024, 512, 7, 0, 1), ("pw_conv", 2048, 512, 7, 0, 1),
        ("pw_conv", 512, 2048, 7, 0, 1), ("conv3x3", 512, 512, 7, 0, 1),
        ("pw_conv", 36, 70, 13, 0, 3), ("conv3x3", 36, 70, 9, 0, 2),
        ("conv3x3", 200, 136, 5, 0, 3)]


def case_inputs(gen, op, cin, cout, hw, batch):
    """Seeded (x, scale, shift, w) of one case, and its geometry: pixel
    count m and taps (1 or 9)."""
    m = batch * hw * hw
    if op == "pw_conv":
        return make_inputs(gen, (m, cin), (cin, cout), cin), m, 1
    return (make_inputs(gen, (batch, hw, hw, cin), (3, 3, cin, cout), 9 * cin),
            m, 9)


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds a call spends enqueuing ``fn`` (the wrapper's
    Python, its C launcher and the launches), at a shape whose kernels end
    sooner than their enqueue: the clock stops before the device is waited
    for."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def trap_inputs(gen, op, x_shape, cout, zero_x):
    """Seeded inputs of a trap case; with ``zero_x`` x is 0 and the shift
    positive, so every in-image tap and every valid row folds to
    relu(shift) > 0 while the SAME halo and the rows past M must give 0."""
    cin = x_shape[-1]
    w_shape = (cin, cout) if op == "pw_conv" else (3, 3, cin, cout)
    x, s, t, w = make_inputs(gen, x_shape, w_shape, math.prod(w_shape[:-1]))
    if zero_x:
        x, t = torch.zeros_like(x), t.abs() + 0.1
    return x, s, t, w


# (what it shows, op, x shape, Cout, x = 0 with relu(shift) > 0): the places
# where a forward conv kernel goes wrong without failing a shape case
TRAP_CASES = [
    ("halo at 56x56", "conv3x3", (2, 56, 56, 64), 64, True),
    ("halo, images sharing a block at 7x7", "conv3x3", (3, 7, 7, 512), 512, True),
    ("rows past M = 49", "pw_conv", (49, 1024), 512, True),
    ("rows past M = 49, 3x3", "conv3x3", (1, 7, 7, 512), 512, True),
    ("a box past Cin", "conv3x3", (2, 9, 5, 36), 70, False),
    ("a box past Cin, pointwise", "pw_conv", (90, 36), 70, False),
]


def traps_phase(fc, gen):
    """Phase 2's trap cases against the plain version (check_case's
    tolerance), a misaligned x against an aligned copy and reruns, bit for
    bit."""
    out = []
    for what, op, x_shape, cout, zero_x in TRAP_CASES:
        x, s, t, w = trap_inputs(gen, op, x_shape, cout, zero_x)
        c = [check_case(fc, op, x, s, t, w, r) for r in (False, True)]
        ok = all(r["ok"] for r in c)
        out.append({"trap": what, "op": op, "x": list(x_shape), "cout": cout,
                    "y_err_over_tol": max(r["y_err_over_tol"] for r in c),
                    "stats_err_over_tol": max(r["stats_err_over_tol"] for r in c), "ok": ok})
        print(f"phase 2 trap {what}: {op} x {tuple(x_shape)} -> {cout}: y err/tol "
              f"{out[-1]['y_err_over_tol']:.3g} stats err/tol "
              f"{out[-1]['stats_err_over_tol']:.3g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"trap case {what} disagrees with the plain version: {out[-1]}")
    for op, x_shape, cout in (("pw_conv", (6272, 256), 1024),
                              ("conv3x3", (2, 14, 14, 256), 256)):
        x, s, t, w = trap_inputs(gen, op, x_shape, cout, False)
        kern = fc.pw_conv if op == "pw_conv" else fc.conv3x3
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        x_off = buf[1:].view(x.shape)          # contiguous, base 2 bytes off 16
        x_off.copy_(x)
        first = kern(x, s, t, w, True)
        again = kern(x, s, t, w, True)
        off = kern(x_off, s, t, w, True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        aligned = all(torch.equal(a, b) for a, b in zip(first, off))
        ok = same and aligned and x_off.data_ptr() % 16 != 0
        out.append({"trap": "rerun and misaligned view", "op": op, "x": list(x_shape),
                    "cout": cout, "rerun_bit_identical": same,
                    "misaligned_bit_identical": aligned, "ok": ok})
        print(f"phase 2 trap rerun and misaligned view: {op} x {tuple(x_shape)} -> {cout}: "
              f"rerun bit-identical {same}, misaligned x bit-identical {aligned} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{op}: a rerun or a misaligned x changed the bits: {out[-1]}")
    return out


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
            if op == "pw_conv":
                lib = functools.partial(torch.matmul, x, w)
            else:
                xc = x.permute(0, 3, 1, 2)
                wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib = functools.partial(F.conv2d, xc, wc, padding=1)
            row["kernel_ms"] = time_ms(lambda: kern(x, s, t, w, True))
            row["kernel_device_ms"] = graph_ms(lambda: kern(x, s, t, w, True))
            row["plain_ms"] = time_ms(lambda: plain(x, s, t, w, True))
            row["library_ms"] = time_ms(lib)
            row["library_device_ms"] = graph_ms(lib)
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        rows.append(row)
        timing = (f" kernel_ms {row['kernel_ms']:.4f} (device only, CUDA graph: "
                  f"{row['kernel_device_ms']:.4f}) plain_ms {row['plain_ms']:.4f} "
                  f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) "
                  f"library_ms {row['library_ms']:.4f} (device only: "
                  f"{row['library_device_ms']:.4f})") if count else ""
        print(f"phase 2 kernel {op} {cin}->{cout} @{hw}x{hw} batch {batch}: "
              f"y max_abs_err {row['y_max_abs_err']:.3g} "
              f"(err/tol {row['y_err_over_tol']:.3g}; tol = 2^-7|p| + 2K*2^-24*sum|u*w|) "
              f"stats max_abs_err {row['stats_max_abs_err']:.3g} "
              f"(err/tol {row['stats_err_over_tol']:.3g}){timing} "
              f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            raise AssertionError(f"{op} disagrees with its plain version: {row}")
    for op, launches, lib in (("pw_conv", 36, "torch.matmul"), ("conv3x3", 16, "F.conv2d")):
        mine = [r for r in rows if r["op"] == op]
        s = summary[op] = summarize([{**r, "max_abs_err": r["y_max_abs_err"]} for r in mine])
        for key in ("kernel_device_ms", "library_device_ms"):
            s[key] = sum(r["launches_per_forward"] * r[key] for r in mine
                         if r["launches_per_forward"])
        # the wrapper's host cost at the batch-1 7x7 shape (M = 49)
        (x, sc, sh, w), _, _ = case_inputs(gen, op, 512, 512, 7, 1)
        kern = fc.pw_conv if op == "pw_conv" else fc.conv3x3
        s["host_us_per_call"] = host_us(lambda: kern(x, sc, sh, w, True))
        print(f"phase 2 {op} over a forward's {launches} launches: kernel_ms "
              f"{s['kernel_ms']:.4f} (device only, CUDA graph: {s['kernel_device_ms']:.4f}) "
              f"plain_ms {s['plain_ms']:.4f} bound_ms {s['bound_ms']:.4f} ({s['bound_by']}) "
              f"library_ms {s['library_ms']:.4f} (device only: {s['library_device_ms']:.4f}; "
              f"{lib}); host {s['host_us_per_call']:.1f} us a call at 512->512 @7x7 batch 1",
              flush=True)
    rows += traps_phase(fc, gen)
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
    the shapes of phase 2, both relu_in, a nonzero dstats, and every kernel
    rerun bit for bit (dx with dscale and dshift); times of each kernel
    (CUDA events and device only), its plain version and the library call
    (both ways) at the 19 shapes, and each kernel's total over a train
    step's launches."""
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
        kdx = fc.pw_conv_bwd_dx if op == "pw_conv" else fc.conv3x3_bwd_dx
        kdw = fc.pw_conv_bwd_dw if op == "pw_conv" else fc.conv3x3_bwd_dw
        row["dx_rerun_bit_identical"] = all(
            all(bool(torch.equal(a, b)) for a, b in zip(*(kdx(*args, r) for _ in range(2))))
            for r in (False, True))
        row["dw_rerun_bit_identical"] = all(
            bool(torch.equal(*(kdw(*args, r) for _ in range(2)))) for r in (False, True))
        row["ok"] = row["ok"] and row["dx_rerun_bit_identical"] and row["dw_rerun_bit_identical"]
        line += (f"; dx rerun bit-identical {row['dx_rerun_bit_identical']}"
                 f", dw rerun bit-identical {row['dw_rerun_bit_identical']}")
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
                # device only: the host's wrapper not in it
                row[f"{kind}_kernel_device_ms"] = graph_ms(lambda: kern(*args, True))
                row[f"{kind}_plain_ms"] = time_ms(lambda: plain(*args, True))
                row[f"{kind}_library_ms"] = time_ms(lib)
                row[f"{kind}_library_device_ms"] = graph_ms(lib)
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(flops, nbytes)
                line += (f"; {kind} kernel_ms {row[f'{kind}_kernel_ms']:.4f} "
                         f"(device only, CUDA graph: {row[f'{kind}_kernel_device_ms']:.4f}) "
                         f"plain_ms {row[f'{kind}_plain_ms']:.4f} "
                         f"bound_ms {row[f'{kind}_bound_ms']:.4f} "
                         f"({row[f'{kind}_bound_by']}) "
                         f"library_ms {row[f'{kind}_library_ms']:.4f} (device only: "
                         f"{row[f'{kind}_library_device_ms']:.4f})")
        rows.append(row)
        print(f"{line} {'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            raise AssertionError(f"{op} backward disagrees with its plain version: {row}")
    summary = {}
    libs = {"pw_conv_dx": "torch.matmul dz W^T", "pw_conv_dw": "torch.matmul x^T dz",
            "conv3x3_dx": "conv2d_input", "conv3x3_dw": "conv2d_weight"}
    for op, launches in (("pw_conv", 36), ("conv3x3", 16)):
        mine = [r for r in rows if r["op"] == op]
        for kind in ("dx", "dw"):
            k = summary[f"{op}_{kind}"] = summarize([
                {"launches_per_forward": r["launches_per_forward"],
                 "max_abs_err": r[f"{kind}_max_abs_err"],
                 **{key: r.get(f"{kind}_{key}") for key in
                    ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                for r in mine])
            for key in ("kernel_device_ms", "library_device_ms"):
                k[key] = sum(r["launches_per_forward"] * r[f"{kind}_{key}"] for r in mine
                             if r["launches_per_forward"])
            print(f"phase 2b {op}_{kind} over a train step's {launches} launches: kernel_ms "
                  f"{k['kernel_ms']:.4f} (device only, CUDA graph: {k['kernel_device_ms']:.4f}) "
                  f"plain_ms {k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} "
                  f"({k['bound_by']}) library_ms {k['library_ms']:.4f} (device only: "
                  f"{k['library_device_ms']:.4f}; {libs[f'{op}_{kind}']})", flush=True)
    return rows, summary


def int8_cases():
    """(B, K, N, dtype, launches per VGG16 forward at this B): VGG16's three
    heads at buckets 1, 8 and 32 in f32 (the VGG16 path) and bf16, the first
    head at B 33 (a second row block), LeNet's two heads, and ragged cases
    (N % 16 != 0 with N % 4 == 0 and K off the 64-deep stage; N odd to 4)."""
    cases = [(b, k, n, dt, 1 if dt == torch.float32 else 0)
             for b in (1, 8, 32) for k, n in VGG_HEADS
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(33, *VGG_HEADS[0], dt, 0) for dt in (torch.float32, torch.bfloat16)]
    cases += [(b, k, n, torch.float32, 0) for b in (1, 8) for k, n in LENET_HEADS]
    return cases + [(b, k, n, dt, 0) for b, k, n in ((5, 1000, 1000), (3, 777, 130))
                    for dt in (torch.float32, torch.bfloat16)]


def check_int8(im, x, q, s):
    """Kernel vs plain version: |k - p| <= 2K*2^-24*(|x|.|q|)*s, the f32
    summation-order difference; for bf16 x plus one bf16 step of |p| for the
    output and one for the scale. For f32 x also the f64 gate: max |k - y64|
    <= 4 max |p - y64| + 2^-24 max |y64| (f32 stays f32). Returns
    (max_abs_err, err/tol, the gate's (kernel err, plain err, limit) or
    None)."""
    yk = im.int8_matmul(x, q, s)
    yp = im.int8_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    tol = 2 * x.shape[1] * F32_EPS * (x.float().abs() @ q.float().abs()) * s
    if x.dtype == torch.bfloat16:
        tol = tol + 2 * BF16_STEP * yp.float().abs()
    err = (yk.float() - yp.float()).abs()
    if not bool(torch.isfinite(yk.float()).all()):
        raise AssertionError("int8_matmul returned non-finite values")
    gate = None
    if x.dtype == torch.float32:
        y64 = (x.double() @ q.double()) * s.double()
        gate = (float((yk.double() - y64).abs().max()), float((yp.double() - y64).abs().max()))
        gate += (4 * gate[1] + F32_EPS * float(y64.abs().max()),)
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), gate


def int8_bound(b, k, n, dtype):
    """(bound_ms, bound_by, bytes ms, operations ms): x, q, scale read and y
    written once at 3.35 TB/s; the kernel's bf16 passes over q (three planes
    of an f32 x, one of a bf16 x), P * 2BKN, at 989 TFLOP/s."""
    flops = (3 if dtype == torch.float32 else 1) * 2.0 * b * k * n
    nbytes = b * k * 4 + k * n + n * 4 + b * n * 4
    return (*bound(flops, nbytes), nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3)


def int8_phase(im):
    """Phase 2c: the int8 kernel against its plain version and the f64
    product on the card; times summed over the three head launches of one
    VGG16 forward at B = 1 and 32 (f32 x), by CUDA events and device only
    (CUDA graph): the kernel, the plain version, and the library's f32
    matmul on the dequantized weight."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    timed = ("kernel_ms", "plain_ms", "library_ms", "kernel_device_ms", "plain_device_ms",
             "library_device_ms")
    rows, sums = [], {}
    for b, k, n, dt, count in int8_cases():
        x = torch.randn(b, k, generator=gen, device="cuda").to(dt)
        w = torch.randn(k, n, generator=gen, device="cuda") * math.sqrt(2.0 / k)
        q, s = im.quantize_int8(w)
        q, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
        err, ratio, gate = check_int8(im, x, q, s)
        row = {"b": b, "k": k, "n": n, "dtype": str(dt).split(".")[-1],
               "launches_per_forward": count, "max_abs_err": err, "err_over_tol": ratio}
        gate_txt = ""
        if gate is not None:
            row.update(f64_err_kernel=gate[0], f64_err_plain=gate[1], f64_limit=gate[2])
            gate_txt = (f" f64 gate max|k-y64| {gate[0]:.3g} <= 4 max|p-y64| + 2^-24 max|y64| "
                        f"= {gate[2]:.3g} (plain {gate[1]:.3g})")
        timing = ""
        if count and b in (1, 32):
            wf = q.float() * s
            fns = {"kernel": lambda: im.int8_matmul(x, q, s),
                   "plain": lambda: im.int8_matmul_plain(x, q, s),
                   "library": lambda: torch.matmul(x, wf)}
            for name, fn in fns.items():
                row[f"{name}_ms"] = time_ms(fn)
                row[f"{name}_device_ms"] = graph_ms(fn)
            row["bound_ms"], row["bound_by"], bytes_ms, ops_ms = int8_bound(b, k, n, dt)
            acc = sums.setdefault(b, dict.fromkeys(timed + ("bound_ms", "bound_bytes_ms",
                                                            "bound_ops_ms"), 0.0))
            for key in timed + ("bound_ms",):
                acc[key] += row[key]
            acc["bound_bytes_ms"] += bytes_ms
            acc["bound_ops_ms"] += ops_ms
            timing = (f" kernel_ms {row['kernel_ms']:.4f} (device only, CUDA graph: "
                      f"{row['kernel_device_ms']:.4f}) plain_ms {row['plain_ms']:.4f} (device "
                      f"{row['plain_device_ms']:.4f}) library_ms {row['library_ms']:.4f} (device "
                      f"{row['library_device_ms']:.4f}) bound_ms {row['bound_ms']:.4f} "
                      f"({row['bound_by']})")
        rows.append(row)
        ok = ratio <= 1 and (gate is None or gate[0] <= gate[2])
        print(f"phase 2c kernel int8_matmul B {b} K {k} N {n} {row['dtype']}: max_abs_err "
              f"{err:.3g} err/tol {ratio:.3g} (tol = 2K*2^-24*(|x|.|q|)*s"
              f"{' + 2*2^-7|p|' if dt == torch.bfloat16 else ''});{gate_txt}{timing} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"int8_matmul disagrees with its plain version or the f64 "
                                 f"product: {row}")
        if b == 32 and k == VGG_HEADS[0][0] and n == VGG_HEADS[0][1]:
            same = (torch.equal(im.int8_matmul(x, q, s), im.int8_matmul(x, q, s))
                    and torch.equal(im.int8_matmul(x[:1].contiguous(), q, s),
                                    im.int8_matmul(x, q, s)[:1]))
            print(f"phase 2c rerun and bucket bits (B 32 {row['dtype']}, the first head): "
                  f"reruns and row 0 at B 1 == B 32 bit for bit {same}", flush=True)
            if not same:
                raise AssertionError(f"int8_matmul reruns or buckets differ: {row}")
    for b, acc in sums.items():
        acc["bound_by"] = "operations" if acc["bound_ops_ms"] >= acc["bound_bytes_ms"] else "bytes"
        print(f"phase 2c VGG16 heads B {b}: kernel_ms {acc['kernel_ms']:.4f} (device only, "
              f"CUDA graph: {acc['kernel_device_ms']:.4f}) plain_ms {acc['plain_ms']:.4f} "
              f"(device {acc['plain_device_ms']:.4f}) library_ms {acc['library_ms']:.4f} "
              f"(device {acc['library_device_ms']:.4f}; torch.matmul on the dequantized f32 "
              f"weight) bound_ms {acc['bound_ms']:.4f} ({acc['bound_by']}: bytes "
              f"{acc['bound_bytes_ms']:.4f} at 3.35 TB/s, operations {acc['bound_ops_ms']:.4f}: "
              f"three bf16 passes at 989 TFLOP/s)", flush=True)
    summary = {**sums[32], "max_abs_err": max(r["max_abs_err"] for r in rows),
               "b1": sums[1]}
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


def _flat(tree, prefix=""):
    """(``a/b/c`` name, leaf) for every leaf of a nested dict."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _quantiles(d):
    """median, p90, max, and the three largest"""
    top = sorted(d.items(), key=lambda kv: -kv[1])[:3]
    return ([round(float(v), 4) for v in np.quantile(list(d.values()), [0.5, 0.9, 1.0])]
            + [(n, round(v, 4)) for n, v in top])


def grad_agreement(gk, gp, g32):
    """The gradient rule of phases 4 and 9 over flat {name: gradient} dicts
    (k kernel path, p plain path, f32 the plain path in f32) -> (ok, the
    three ratios by name): every gradient of the kernel path finite; per
    tensor ||g_k - g_p|| <= max(GRAD_REL_TOL ||g_p||, GRAD_NOISE_FACTOR
    ||g_p - g_f32||); over the tensors the median of ||g_k - g_f32|| /
    ||g_p - g_f32|| <= GRAD_F32_MEDIAN."""
    rels, ratios, to_f32, finite = {}, {}, {}, True
    for name in gp:
        a, b, c = gk[name].float(), gp[name].float(), g32[name].float()
        finite = finite and bool(torch.isfinite(a).all())
        rels[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        ratios[name] = float((a - b).norm() / (b - c).norm().clamp_min(1e-30))
        to_f32[name] = float((a - c).norm() / (b - c).norm().clamp_min(1e-30))
    ok = finite and all(rels[n] <= GRAD_REL_TOL or ratios[n] <= GRAD_NOISE_FACTOR for n in rels)
    ok = ok and float(np.median(list(to_f32.values()))) <= GRAD_F32_MEDIAN
    return ok, rels, ratios, to_f32


def stats_launches(model, steps: int) -> dict:
    """The batch-statistics collectives that ``steps`` train steps of
    ``model`` make on a mesh, by their ``launch_counts`` names: each site one
    forward and one backward a step; a site is a bf16/f16
    BatchNormalization (``(Σx, Σx²)``), each of an f32 one's two passes, and
    each conv of a fused bottleneck (three, four with the projection)."""
    from deeplearning4j_tpu_torch.parallel import mesh

    graph = hasattr(model.conf, "network_inputs")
    layers = [model._layer(n) for n in model.layer_names] if graph else model.layers
    low = model._compute_dtype in (torch.bfloat16, torch.float16)
    sites = 0
    for layer in layers:
        kind = type(layer).__name__
        if kind == "BatchNormalization":
            sites += 1 if low else 2
        elif kind == "FusedResNetBottleneck":
            sites += 4 if layer.project else 3
    return {mesh.STATS_FORWARD: steps * sites, mesh.STATS_BACKWARD: steps * sites}


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
    grads_ok, rels, ratios, to_f32 = grad_agreement(*(dict(_flat(g)) for g in (grads, ref, g32)))
    del grads, ref, g32
    score_rel = abs(score - ref_score) / abs(ref_score)
    grads_ok = grads_ok and score_rel <= 1e-3
    q = _quantiles
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


# phase 4b: phase 4's model through ComputationGraph.fit at steps_per_call=4:
# two bundles (two replays of one captured CUDA graph) against eight eager steps
BUNDLE_K = 4
BUNDLE_BATCHES = 8
# the kernel names a profiler trace shows, and the launch counters each one
# answers to (one forward kernel serves the pointwise conv and the 3x3)
TRACE_NAMES = {"fused_conv_fwd_kernel_sm90": ("pw_conv", "conv3x3"),
               "pw_bwd_dx_kernel_sm90": ("pw_conv_dx",),
               "pw_bwd_dw_kernel_sm90": ("pw_conv_dw",),
               "conv3x3_bwd_dx_kernel_sm90": ("conv3x3_dx",),
               "conv3x3_bwd_dw_kernel_sm90": ("conv3x3_dw",),
               "fused_adam_kernel": ("fused_adam",)}


def trace_kernels(fn):
    """``fn()`` under ``torch.profiler`` -> (launches in the trace by
    TRACE_NAMES name, device busy ms of the trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts, busy_us = dict.fromkeys(TRACE_NAMES, 0), 0.0
    for evt in prof.key_averages():
        if evt.device_type.name not in ("CUDA", "PrivateUse1"):
            continue
        busy_us += next((float(getattr(evt, a)) for a in ("self_device_time_total",
                                                          "self_cuda_time_total")
                         if getattr(evt, a, None) is not None), 0.0)
        for name in TRACE_NAMES:
            if name in evt.key:
                counts[name] += int(evt.count)
    return counts, busy_us / 1e3


def trace_want(launches):
    """The trace counts by TRACE_NAMES name that wrapper launch counts give."""
    return {name: sum(launches.get(k, 0) for k in keys) for name, keys in TRACE_NAMES.items()}


def _tensors_equal(a, b) -> bool:
    """Every leaf of two state trees (a graph's dicts or a list network's
    lists of dicts of tensors) torch.equal."""
    def as_dict(t):
        return dict(enumerate(t)) if isinstance(t, list) else t

    la, lb = dict(_flat(as_dict(a))), dict(_flat(as_dict(b)))
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def _states_equal(a, b) -> dict:
    return {"params": _tensors_equal(a.params_, b.params_),
            "updater": _tensors_equal(a.opt_state_, b.opt_state_),
            "layer_state": _tensors_equal(a.state_, b.state_)}


def _bundle_scores(model, seen):
    """The per-step scores of a bundled fit: ``seen`` holds
    ``model.bundle_scores_`` as each batch was handed out; the last bundle's
    is on the model."""
    bundles = []
    for s in seen + [model.bundle_scores_]:
        if s is not None and all(s is not b for b in bundles):
            bundles.append(s)
    return [float(v) for b in bundles for v in b.host()]


def _in_turns(runs, rounds=2):
    """Each ``(label, fn)`` of ``runs`` timed in turns (a b b a ...): host
    seconds per call (synchronized) and the peak allocated and reserved GiB,
    by label."""
    order = [r for i in range(rounds) for r in (runs if i % 2 == 0 else runs[::-1])]
    out = {label: {"s": [], "peak_gib": [], "peak_reserved_gib": []} for label, _ in runs}
    for label, fn in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[label]["s"].append(time.perf_counter() - t0)
        out[label]["peak_gib"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        out[label]["peak_reserved_gib"].append(torch.cuda.max_memory_reserved() / 2 ** 30)
    return out


def _deterministic_cudnn(fn):
    """``fn()`` with cuDNN deterministic and not benchmarking (eager steps
    and replays then pick the same convolution algorithms)."""
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det


def bundled_train_phase(fc, card: str, train: dict):
    """Phase 4b: phase 4's full-width bf16 ResNet-50 (Nesterovs(TRAIN_LR,
    0.9)) through ``ComputationGraph.fit`` at ``steps_per_call`` BUNDLE_K,
    against the same model's eager steps, under deterministic cuDNN."""
    return _deterministic_cudnn(lambda: _bundled_train(fc, card, train))


def _bundled_train(fc, card, train):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.train import pipeline
    from deeplearning4j_tpu_torch.updaters import Nesterovs

    eager, _ = resnet50(updater=Nesterovs(TRAIN_LR, 0.9))
    bundled, _ = resnet50(updater=Nesterovs(TRAIN_LR, 0.9))
    bundled.conf.global_conf.steps_per_call = BUNDLE_K
    rng = np.random.default_rng(SEED + 4)
    batches = [DataSet(rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32),
                       np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)])
               for _ in range(BUNDLE_BATCHES)]
    eager_scores = []
    for ds in batches:
        eager.fit(ExistingDataSetIterator([ds]))
        eager_scores.append(eager.score_)
    eager_scores = [float(v) for v in eager_scores]

    # the main path: counts from 0 just before, read just after (the warm-up
    # steps before the capture launch eagerly, the capture records each
    # launch once, the replays count none)
    seen = []
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    bundled.fit(RecordingIterator(batches, lambda i: seen.append(bundled.bundle_scores_)))
    torch.cuda.synchronize()
    first_fit_s = time.perf_counter() - t0
    main_launches = dict(fc.launch_counts)
    captured = dict(bundled._bundled.captured_launches)
    scores = _bundle_scores(bundled, seen)
    equal = _states_equal(eager, bundled)
    want_capture = {k: BUNDLE_K * v for k, v in STEP_LAUNCHES.items()}
    want_main = {k: (BUNDLE_K + pipeline.WARMUP_STEPS) * v for k, v in STEP_LAUNCHES.items()}
    print(f"phase 4b bundled fit: ResNet-50 (phase 4's model), ComputationGraph.fit at "
          f"steps_per_call={BUNDLE_K}, {BUNDLE_BATCHES} batches of {BATCH} (2 bundles, "
          f"deterministic cuDNN): vs {BUNDLE_BATCHES} eager steps torch.equal "
          f"{equal}; scores equal {scores == eager_scores} ({[round(v, 5) for v in scores]}); "
          f"launches captured in the graph {captured} ({BUNDLE_K} x phase 4's per step: "
          f"{captured == want_capture}); main-path launches {main_launches} (the "
          f"{pipeline.WARMUP_STEPS} warm-up steps' and the capture's); first fit incl. "
          f"warm-up and capture {first_fit_s:.2f}s", flush=True)

    # one replay under the profiler: a fit of BUNDLE_K batches is one bundle
    fc.reset_launch_counts()
    trace, busy_ms = trace_kernels(
        lambda: bundled.fit(ExistingDataSetIterator(batches[:BUNDLE_K])))
    replay_launches = sum(fc.launch_counts.values())
    print(f"phase 4b trace of one replay: kernels by name {trace} (want "
          f"{trace_want(captured)}), device busy {busy_ms:.3f} ms for {BUNDLE_K} steps; "
          f"wrapper launches during the replay {replay_launches} (0: no eager step)",
          flush=True)

    timed = _in_turns([
        ("eager", lambda: eager.fit(ExistingDataSetIterator(batches))),
        ("bundled", lambda: bundled.fit(ExistingDataSetIterator(batches)))])
    speed = {label: {"images_per_s": [BATCH * BUNDLE_BATCHES / t for t in r["s"]],
                     "ms_per_step": [t * 1e3 / BUNDLE_BATCHES for t in r["s"]],
                     "peak_gib": r["peak_gib"], "peak_reserved_gib": r["peak_reserved_gib"]}
             for label, r in timed.items()}
    fmt = lambda v: [round(x, 2) for x in v]  # noqa: E731
    print(f"phase 4b speed (in turns: eager, bundled, bundled, eager; {BUNDLE_BATCHES} batches "
          f"a fit, host clock, synchronized): eager {fmt(speed['eager']['images_per_s'])} "
          f"images/s ({fmt(speed['eager']['ms_per_step'])} ms a step), bundled "
          f"{fmt(speed['bundled']['images_per_s'])} images/s "
          f"({fmt(speed['bundled']['ms_per_step'])} ms a step); peak allocated GiB eager "
          f"{fmt(speed['eager']['peak_gib'])} bundled {fmt(speed['bundled']['peak_gib'])}, "
          f"reserved eager {fmt(speed['eager']['peak_reserved_gib'])} bundled "
          f"{fmt(speed['bundled']['peak_reserved_gib'])} (both models held); phase 4 "
          f"{train['images_per_s']:.1f} images/s; on {card}", flush=True)

    failed = []
    if not all(equal.values()) or scores != eager_scores:
        failed.append(f"bundles differ from eager steps: {equal}, scores {scores} vs "
                      f"{eager_scores}")
    if captured != want_capture or main_launches != want_main:
        failed.append(f"captured {captured} (want {want_capture}), main path "
                      f"{main_launches} (want {want_main})")
    if trace != trace_want(captured) or replay_launches:
        failed.append(f"the replay's trace {trace} != {trace_want(captured)} or it "
                      f"launched {replay_launches} eagerly")
    if not _finite(bundled) or not all(math.isfinite(v) for v in scores):
        failed.append("bundled fit not finite")
    del eager, bundled
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"k": BUNDLE_K, "equal": equal, "scores": scores, "eager_scores": eager_scores,
            "main_launches": main_launches, "captured_launches": captured,
            "trace_one_replay": trace, "trace_busy_ms": busy_ms,
            "first_fit_s": first_fit_s, "speed": speed}


def spread_softmax(model, x: np.ndarray, target: float = 0.3) -> float:
    """Scale the output layer's seeded W (in place) so that the mean max
    probability on ``x`` is about ``target``: a random VGG16's (or
    TextGenerationLSTM's) softmax is otherwise saturated or flat, and every
    comparison of probabilities would be vacuous. Returns the scale."""
    n = len(model.layers)
    with torch.inference_mode():
        h, _, _ = model._forward(model.params_, model.state_,
                                 torch.from_numpy(x).cuda(), stop_before=n - 1)
        p = model.params_[n - 1]
        z0 = h @ p["W"]
        lo, hi = 1e-4, 1e4
        for _ in range(60):
            mid = math.sqrt(lo * hi)
            m = float(torch.softmax(mid * z0 + p["b"], -1).amax(-1).mean())
            lo, hi = (lo, mid) if m > target else (mid, hi)
    scale = math.sqrt(lo * hi)
    model.params_[n - 1]["W"] = p["W"] * scale
    return scale


def _speed(engine, x):
    """(images/s at bucket 32, median ms at bucket 1, peak GiB): host clock,
    copies included, after the warm-up of the main path."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.infer(x)
    t32 = (time.perf_counter() - t0) / iters
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.infer(x[:1])
        lat.append(time.perf_counter() - t0)
    return BATCH / t32, float(np.median(lat) * 1e3), torch.cuda.max_memory_allocated() / 2 ** 30


def _row_sum_dev(r) -> float:
    return float(np.abs(r.sum(1) - 1.0).max())


def vgg_phase(fc, im, card: str):
    """Phase 5: full-width f32 VGG16 (1000 classes, 224x224x3, seeded) in an
    int8-head engine and an f32 engine, buckets [1, 8, 32]."""
    from deeplearning4j_tpu_torch.models import VGG16
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    t0 = time.perf_counter()
    model = VGG16(num_classes=1000, seed=SEED).init()
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32)
    scale = spread_softmax(model, x)
    e8 = InferenceEngine(model, buckets=[1, 8, 32], int8_serving=True)
    e32 = InferenceEngine(model, buckets=[1, 8, 32])
    init_s = time.perf_counter() - t0
    rep = e8.int8_report
    heads = e8._snap.params[VGG_FIRST_HEAD:]
    snap_ok = all("W" not in p and p["W_q8"].dtype == torch.int8
                  and p["W_q8"].device.type == e8.device.type for p in heads)
    print(f"phase 5 setup: VGG16 1000 classes 224x224x3 f32, {model.num_params():,} params, "
          f"init {init_s:.1f}s, output W scaled by {scale:.4g}; int8 report {rep}; "
          f"snapshot heads hold W_q8/W_scale only: {snap_ok}", flush=True)

    # the main path: counts from 0 just before, read just after
    fc.reset_launch_counts()
    warm8 = e8.warmup()
    r1, r7, r8 = e8.infer(x[:1]), e8.infer(x[:7]), e8.infer(x[:8])
    before = dict(fc.launch_counts)
    r32 = e8.infer(x)
    after = dict(fc.launch_counts)
    main_launches = dict(fc.launch_counts)
    per_forward = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    fc.reset_launch_counts()
    warm32 = e32.warmup()
    f1, f7, f8, f32 = (e32.infer(x[:n]) for n in (1, 7, 8, BATCH))
    f32_launches = sum(fc.launch_counts.values())
    print(f"phase 5 serve: warmup int8 {warm8} f32 {warm32}; launches in one int8 forward "
          f"{per_forward}, main-path launches {main_launches}; f32 engine launches "
          f"{f32_launches}", flush=True)

    # the int8 heads on their plain version, from the snapshot's activations
    # into the first head
    snap = e8._snap
    with torch.inference_mode():
        a, _, _ = model._forward(snap.params, snap.state, torch.from_numpy(x).cuda(),
                                 stop_before=VGG_FIRST_HEAD, cast_params=False)
        for i, p in enumerate(heads):
            z = im.int8_matmul_plain(a, p["W_q8"], p["W_scale"]) + p["b"]
            a = torch.relu(z) if i < len(heads) - 1 else torch.softmax(z, -1)
        ref8 = a.cpu().numpy()
    d_plain = float(np.abs(r32 - ref8).max())
    pad8 = float(np.abs(r7 - r8[:7]).max())
    pad32 = float(np.abs(f7 - f8[:7]).max())
    cross8 = float(max(np.abs(r1 - r32[:1]).max(), np.abs(r7 - r32[:7]).max()))
    cross32 = float(max(np.abs(f1 - f32[:1]).max(), np.abs(f7 - f32[:7]).max()))
    dp = float(np.abs(r32 - f32).max())
    top2 = np.sort(f32, 1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * dp
    agree = r32.argmax(1) == f32.argmax(1)
    maxprob = float(f32.max(1).mean())
    print(f"phase 5 check: rows sum to 1 (max dev int8 {_row_sum_dev(r32):.3g}, f32 "
          f"{_row_sum_dev(f32):.3g}); int8 vs its plain heads on the card max|dp| {d_plain:.3g} "
          f"(tol {INT8_PLAIN_TOL}); padding (7 rows in bucket 8 vs the same rows of 8) "
          f"max|dp| int8 {pad8:.3g} f32 {pad32:.3g} (tol {PAD_TOL}); across buckets (1 and 7 "
          f"rows vs 32) max|dp| int8 {cross8:.3g} f32 {cross32:.3g} (tol {BUCKET_TOL}); int8 vs f32 max|dp| {dp:.3g}, top-1 agreement "
          f"{int(agree.sum())}/{BATCH} ({int(decided.sum())} rows with f32 top-2 gap > "
          f"2 max|dp|, all of which must agree); mean max prob {maxprob:.3f}", flush=True)

    s8, l8, m8 = _speed(e8, x)
    s32, l32, m32 = _speed(e32, x)
    print(f"phase 5 speed: int8 heads {s8:.1f} images/s at bucket 32, {l8:.2f} ms median at "
          f"bucket 1, peak {m8:.2f} GiB; f32 {s32:.1f} images/s, {l32:.2f} ms, peak "
          f"{m32:.2f} GiB (host clock, copies included) on {card}", flush=True)

    failed = []
    if per_forward != {"int8_matmul": 3} or f32_launches:
        failed.append(f"launches: int8 forward {per_forward}, f32 engine {f32_launches}")
    if (rep["layers_quantized"], rep["weight_bytes_fp32"], rep["weight_bytes_int8"]) != (
            3, VGG_BYTES_F32, VGG_BYTES_INT8) or not snap_ok:
        failed.append(f"int8 report {rep} or snapshot")
    for name, rows in (("int8", (r1, r7, r8, r32)), ("f32", (f1, f7, f8, f32))):
        for r, n in zip(rows, (1, 7, 8, BATCH)):
            if r.shape != (n, 1000) or not np.isfinite(r).all() or _row_sum_dev(r) > 1e-5:
                failed.append(f"{name} engine: bad output for {n} rows")
    if d_plain > INT8_PLAIN_TOL:
        failed.append(f"int8 engine vs plain int8 heads {d_plain}")
    if max(pad8, pad32) > PAD_TOL:
        failed.append(f"bucket padding changed rows by {max(pad8, pad32)}")
    if max(cross8, cross32) > BUCKET_TOL:
        failed.append(f"rows differ across buckets by {max(cross8, cross32)}")
    if not agree[decided].all():
        failed.append("int8 top-1 differs from f32 on a decided row")
    if not 0.05 <= maxprob <= 0.9:
        failed.append(f"mean max probability {maxprob} outside [0.05, 0.9]")
    if failed:
        raise AssertionError("; ".join(failed))
    return e8, x, {
        "main_launches": main_launches, "per_forward": per_forward,
        "f32_engine_launches": f32_launches, "int8_report": rep, "output_w_scale": scale,
        "max_abs_dp_vs_plain_heads": d_plain, "pad_diff_int8": pad8, "pad_diff_f32": pad32,
        "bucket_diff_int8": cross8, "bucket_diff_f32": cross32,
        "max_abs_dp_int8_vs_f32": dp, "top1_agree": int(agree.sum()),
        "rows_decided": int(decided.sum()), "mean_max_prob": maxprob,
        "int8": {"images_per_s_b32": s8, "latency_ms_b1": l8, "peak_gib": m8},
        "f32": {"images_per_s_b32": s32, "latency_ms_b1": l32, "peak_gib": m32},
        "warmup_int8": warm8, "warmup_f32": warm32}


def _http(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npy_bytes(x) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def entry_points_phase(e8, x):
    """Phase 6: the HTTP server over the int8 VGG16 engine; ``cli serve
    --smoke`` on a LeNet checkpoint written by the port; ``/reload``."""
    import io

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.serving import InferenceEngine, InferenceServer
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer

    failed = []
    srv = InferenceServer(e8, port=0).start()
    try:
        req0 = e8.metrics.requests
        code, raw = _http(srv.port, "POST", "/predict_npy", _npy_bytes(x[:8]))
        d8 = float(np.abs(np.load(io.BytesIO(raw)) - e8.infer(x[:8])).max()) \
            if code == 200 else float("inf")
        code1, raw1 = _http(srv.port, "POST", "/predict",
                            json.dumps({"inputs": x[:1].tolist()}))
        d1 = (float(np.abs(np.asarray(json.loads(raw1)["outputs"]) - e8.infer(x[:1])).max())
              if code1 == 200 else float("inf"))
        _, h = _http(srv.port, "GET", "/healthz")
        h = json.loads(h)
        _, m = _http(srv.port, "GET", "/metrics")
        m = json.loads(m)
    finally:
        srv.shutdown()
    print(f"phase 6 http: /predict_npy 8 rows HTTP {code} max|d| {d8:.3g} vs engine.infer, "
          f"/predict 1 row HTTP {code1} max|d| {d1:.3g}; /healthz int8_serving "
          f"{h.get('int8_serving')} report {h.get('int8_report')}; /metrics requests "
          f"{m.get('requests')} (before {req0})", flush=True)
    if max(d8, d1) > 1e-6:
        failed.append(f"HTTP answers differ from engine.infer by {max(d8, d1)}")
    if h.get("int8_serving") is not True or h.get("int8_report") != e8.int8_report:
        failed.append(f"/healthz {h}")
    if m.get("requests") != req0 + 2:
        failed.append(f"/metrics counted {m.get('requests')} requests, expected {req0 + 2}")

    out_dir = os.path.abspath(os.path.join("chiprun_out", "chip_smoke_ckpt"))
    os.makedirs(out_dir, exist_ok=True)
    zips = []
    for i in range(2):
        path = os.path.join(out_dir, f"lenet_{i}.zip")
        ModelSerializer.write_model(LeNet(num_classes=10, seed=SEED + i).init(), path)
        zips.append(path)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                        "--model", zips[0], "--int8-serving", "--port", "0", "--smoke"],
                       cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=300)
    cli_ok = r.returncode == 0 and "smoke: HTTP 200 ok" in r.stdout
    print(f"phase 6 cli serve --model {zips[0]} --int8-serving --port 0 --smoke: exit "
          f"{r.returncode} in {time.perf_counter() - t0:.1f}s; "
          f"{' | '.join(r.stdout.strip().splitlines())}", flush=True)
    if not cli_ok:
        failed.append(f"cli serve --smoke failed: {r.stdout[-2000:]} {r.stderr[-2000:]}")

    eng = InferenceEngine.from_checkpoint(zips[0], buckets=[1, 8], int8_serving=True)
    srv = InferenceServer(eng, port=0).start()
    xl = json.dumps({"inputs": np.random.default_rng(SEED + 8).standard_normal(
        (2, 28, 28, 1)).astype(np.float32).tolist()})
    try:
        _, a = _http(srv.port, "POST", "/predict", xl)
        code_r, rep = _http(srv.port, "POST", "/reload", json.dumps({"path": zips[1]}))
        _, b = _http(srv.port, "POST", "/predict", xl)
    finally:
        srv.shutdown()
    a, rep, b = json.loads(a), json.loads(rep), json.loads(b)
    change = float(np.abs(np.asarray(a["outputs"]) - np.asarray(b["outputs"])).max())
    print(f"phase 6 reload: HTTP {code_r} {rep}; answers from version {b['model_version']} "
          f"differ from version {a['model_version']} by max|d| {change:.3g}", flush=True)
    if not (code_r == 200 and rep.get("version") == 1 and b["model_version"] == 1
            and change > 1e-3):
        failed.append("/reload did not swap in the second checkpoint")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"http_max_abs_diff": max(d8, d1), "cli_smoke_stdout": r.stdout,
            "reload": rep, "reload_answer_change": change}


# ---------------------------------------------------------------------------
# the fused LSTM cell (phase 2d) and TextGenerationLSTM generation (phase 7)
# ---------------------------------------------------------------------------
F32, BF16 = torch.float32, torch.bfloat16
# (x, weights, carries): all f32 (the main path), all bf16, and the
# compute-dtype flow (bf16 x and weights with f32 carries)
LSTM_DTYPES = {"f32": (F32, F32, F32), "bf16": (BF16, BF16, BF16), "mixed": (BF16, BF16, F32)}
LSTM_UNITS, TEXTGEN_VOCAB = 256, 77
GEN_SLOTS, GEN_MAX_LENGTH, GEN_BUCKETS = 32, 256, [8, 16, 32, 64, 256]
GEN_REQUESTS, GEN_MAX_NEW = 64, 64
SAMPLED = {"temperature": 0.8, "top_k": 20, "top_p": 0.95}
# per-step probabilities, kernel path vs the plain path on the card: f32
# summation order through a recurrence of up to 163 steps (PERF.md)
TEACHER_TOL = 1e-4
INT8_HEAD_TOL = 0.05          # int8 vs f32 head, probabilities


def lstm_cases():
    """(B, n_in, n, peephole, dtype): TextGenerationLSTM's two layers (n_in
    77 and 256, n 256) at the prefill row (B 1) and decode batches 8, 32, 64,
    and a ragged case."""
    return ([(b, n_in, LSTM_UNITS, pe, dt) for n_in in (TEXTGEN_VOCAB, LSTM_UNITS)
             for b in (1, 8, 32, 64) for pe in (False, True) for dt in LSTM_DTYPES]
            + [(3, 33, 100, pe, dt) for pe in (False, True) for dt in LSTM_DTYPES])


def lstm_args(gen, b, n_in, n, peephole, dtypes):
    """Seeded cell operands on the card at the full-width scales: x and h in
    (-1, 1), c N(0, 1), xavier-like weights, live biases and peepholes."""
    tx, tw, ts = dtypes
    dev = "cuda"
    x = (torch.rand(b, n_in, generator=gen, device=dev) * 2 - 1).to(tx)
    h = (torch.rand(b, n, generator=gen, device=dev) * 2 - 1).to(ts)
    c = torch.randn(b, n, generator=gen, device=dev).to(ts)
    std = math.sqrt(2.0 / (n_in + n))
    ws = [torch.randn(n_in, 4 * n, generator=gen, device=dev) * std,
          torch.randn(n, 4 * n, generator=gen, device=dev) * std,
          torch.randn(4 * n, generator=gen, device=dev) * 0.3]
    if peephole:
        ws += [torch.randn(n, generator=gen, device=dev) * 0.3 for _ in range(3)]
    return [x, h, c] + [w.to(tw) for w in ws]


# the cell's f32 outputs against the plain version in f32: the reference
# probe's limit (summation order, expf/tanhf against torch's, in ulps)
LSTM_F32_TOL = 1e-5


def lstm_oracle(fl, args, out_dtype):
    """The plain version in f32 on the operands widened exactly (what the
    kernel computes: f32 products and gate chain), rounded once to the
    kernel's output dtype; also the unrounded f32 ``h'``, for the tolerance."""
    h32, c32 = fl.reference_lstm_cell(*[a.float() for a in args])
    return (h32.to(out_dtype), c32.to(out_dtype)), (h32, c32)


def lstm_tolerance(ref32, out_dtype):
    """f32 outputs: LSTM_F32_TOL. bf16 outputs: the kernel and the oracle
    each round once from f32 values at most LSTM_F32_TOL apart, so they
    differ by at most one bf16 step (2^-7 |ref|) plus twice that."""
    if out_dtype == BF16:
        return BF16_STEP * ref32.abs() + 2 * LSTM_F32_TOL
    return torch.full_like(ref32, LSTM_F32_TOL)


def lstm_cost(args, out_dtype):
    """(FLOPs, bytes) of one cell call: the two products and the gate chain;
    each input read once (the weights too), each output written once."""
    x, h, _c, wx = args[:4]
    b, n_in = x.shape
    n = h.shape[1]
    flops = 2.0 * b * (n_in + n) * 4 * n + 20.0 * b * n
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + 2 * b * n * torch.tensor([], dtype=out_dtype).element_size())
    peak = PEAK_BF16_FLOPS if wx.dtype == BF16 else PEAK_F32_FLOPS
    return bound(flops, nbytes, peak)


def library_cell(args):
    """``torch.lstm_cell`` on the same weights, reordered to its [i, f, g, o]
    gates and (4n, K) layout (a non-peephole cell only: no single PyTorch
    call has the peepholes). Built once, outside the timed call."""
    x, h, c, wx, wh, b = args[:6]
    n = h.shape[1]

    def ifgo(w):
        i, f, o, g = w.split(n, dim=-1)
        return torch.cat([i, f, g, o], dim=-1)

    w_ih, w_hh = ifgo(wx).t().contiguous(), ifgo(wh).t().contiguous()
    b_ih, b_hh = ifgo(b).contiguous(), torch.zeros_like(b)
    return lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)


def lstm_rows_alone(fl, args, hk, ck) -> bool:
    """Whether each row of a call's ``h'`` and ``c'`` equals that row run
    alone (B 1), bit for bit."""
    return all(
        torch.equal(o1, o[r:r + 1]) for r in range(hk.shape[0])
        for o1, o in zip(fl.fused_lstm_cell(*[a[r:r + 1].contiguous() if i < 3 else a
                                              for i, a in enumerate(args)]), (hk, ck)))


LSTM_TIMED = ("kernel_ms", "plain_ms", "library_ms", "kernel_device_ms", "plain_device_ms",
              "library_device_ms")


def lstm_phase(fl):
    """Phase 2d: the fused cell against its plain version on the card at
    every case; times at the f32 shapes (and bf16 GravesLSTM at B 32) by
    CUDA events and device only (CUDA graph), the kernel, the plain version
    and, without peepholes, ``torch.lstm_cell``; batch invariance across
    row tiles and bitwise reruns."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for b, n_in, n, pe, dt in lstm_cases():
        args = lstm_args(gen, b, n_in, n, pe, LSTM_DTYPES[dt])
        with torch.inference_mode():
            hk, ck = fl.fused_lstm_cell(*args)
            hp, cp = fl.reference_lstm_cell(*args)
            (ho, co), refs32 = lstm_oracle(fl, args, hk.dtype)
        torch.cuda.synchronize()
        if (hk.dtype, hk.shape) != (hp.dtype, hp.shape) or ck.dtype != hk.dtype:
            raise AssertionError(f"fused_lstm_cell gave {hk.dtype} {tuple(hk.shape)}, the "
                                 f"plain version {hp.dtype} {tuple(hp.shape)}")
        errs, ratios = [], []
        for k_, o_, r32 in ((hk, ho, refs32[0]), (ck, co, refs32[1])):
            err = (k_.float() - o_.float()).abs()
            errs.append(float(err.max()))
            ratios.append(float((err / lstm_tolerance(r32, hk.dtype)).max()))
        row = {"b": b, "n_in": n_in, "n": n, "peephole": pe, "dtype": dt,
               "out_dtype": str(hk.dtype).split(".")[-1], "max_abs_err": max(errs),
               "err_over_tol": max(ratios),
               "finite": bool(torch.isfinite(hk.float()).all() and torch.isfinite(ck.float()).all())}
        timing = ""
        if (dt == "f32" and n == LSTM_UNITS) or (dt == "bf16" and pe and b == 32):
            fns = {"kernel": lambda: fl.fused_lstm_cell(*args),
                   "plain": lambda: fl.reference_lstm_cell(*args)}
            row["library_ms"] = row["library_device_ms"] = None
            with torch.inference_mode():
                if not pe and dt == "f32":
                    lib = library_cell(args)
                    hl, cl = lib()
                    lib_err = max(float((hl - hp).abs().max()), float((cl - cp).abs().max()))
                    if lib_err > 1e-4:
                        raise AssertionError(f"torch.lstm_cell on the reordered weights differs "
                                             f"from the plain cell by {lib_err}")
                    fns["library"] = lib
                for name, fn in fns.items():
                    row[f"{name}_ms"] = time_ms(fn)
                    row[f"{name}_device_ms"] = graph_ms(fn)
            row["bound_ms"], row["bound_by"] = lstm_cost(args, hk.dtype)
            timing = (f" kernel_ms {row['kernel_ms']:.4f} (device only, CUDA graph: "
                      f"{row['kernel_device_ms']:.4f}) plain_ms {row['plain_ms']:.4f} (device "
                      f"{row['plain_device_ms']:.4f}) bound_ms {row['bound_ms']:.5f} "
                      f"({row['bound_by']}) library_ms "
                      + ("none" if row["library_ms"] is None else
                         f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f})"))
        rows.append(row)
        ok = row["err_over_tol"] <= 1 and row["finite"]
        print(f"phase 2d kernel fused_lstm_cell B {b} n_in {n_in} n {n} "
              f"{'peephole' if pe else 'plain'} {dt} -> {row['out_dtype']}: max_abs_err "
              f"{row['max_abs_err']:.3g} vs the plain version in f32 rounded once (tol "
              f"{'2^-7|ref| + 2e-5' if hk.dtype == BF16 else LSTM_F32_TOL}) err/tol "
              f"{row['err_over_tol']:.3g}{timing} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"fused_lstm_cell disagrees with its plain version: {row}")
    # batch invariance: each row of a 32-row call, and of 33- and 65-row calls
    # (which cross a row tile of the kernel's plan), equals the row alone,
    # bitwise; and a rerun of each call gives the same bits
    invariant, reruns = {}, {}
    for dt in ("f32", "bf16"):
        for n_in in (TEXTGEN_VOCAB, LSTM_UNITS):
            for b in (32, 33, 65):
                args = lstm_args(gen, b, n_in, LSTM_UNITS, True, LSTM_DTYPES[dt])
                with torch.inference_mode():
                    hk, ck = fl.fused_lstm_cell(*args)
                    h2, c2 = fl.fused_lstm_cell(*args)
                    invariant[f"{dt}_n_in{n_in}_b{b}"] = lstm_rows_alone(fl, args, hk, ck)
                reruns[f"{dt}_n_in{n_in}_b{b}"] = torch.equal(hk, h2) and torch.equal(ck, c2)
    print(f"phase 2d batch invariance (each row at B 32, 33, 65 == the row at B 1, bitwise): "
          f"{invariant}; reruns bitwise equal: {reruns}", flush=True)
    if not all(invariant.values()):
        raise AssertionError(f"fused_lstm_cell is not batch-invariant: {invariant}")
    if not all(reruns.values()):
        raise AssertionError(f"fused_lstm_cell reruns differ: {reruns}")

    def step(b, pe):
        mine = [r for r in rows if r["dtype"] == "f32" and r["b"] == b and r["peephole"] == pe
                and r["n"] == LSTM_UNITS]
        out = {k: sum(r[k] for r in mine) for k in LSTM_TIMED + ("bound_ms",)
               if not (pe and k.startswith("library"))}
        if pe:
            out["library_ms"] = out["library_device_ms"] = None
        weight = {k: sum(r["bound_ms"] for r in mine if r["bound_by"] == k)
                  for k in ("bytes", "operations")}
        out["bound_by"] = max(weight, key=weight.get)
        return out

    by_batch = {b: {"peephole": step(b, True), "no_peephole": step(b, False)}
                for b in (1, 8, 32, 64)}
    for b, st in by_batch.items():
        g, p = st["peephole"], st["no_peephole"]
        print(f"phase 2d step B {b} (2 cells, f32, device only by CUDA graph, events in "
              f"parentheses): GravesLSTM kernel {g['kernel_device_ms']:.4f} "
              f"({g['kernel_ms']:.4f}); no peepholes kernel {p['kernel_device_ms']:.4f} "
              f"({p['kernel_ms']:.4f}), torch.lstm_cell {p['library_device_ms']:.4f} "
              f"({p['library_ms']:.4f}); plain {g['plain_device_ms']:.4f}; bound "
              f"{g['bound_ms']:.5f} ({g['bound_by']})", flush=True)
    summary = {**by_batch[32]["peephole"], "max_abs_err": max(r["max_abs_err"] for r in rows),
               "max_err_over_tol": max(r["err_over_tol"] for r in rows),
               "b1": by_batch[1]["peephole"], "no_peephole_b32": by_batch[32]["no_peephole"],
               "no_peephole_b1": by_batch[1]["no_peephole"], "by_batch": by_batch,
               "batch_invariant": invariant, "reruns_equal": reruns}
    print(f"phase 2d one decode step (2 cells, B 32, GravesLSTM, f32): "
          f"{ {k: v for k, v in summary.items() if k != 'by_batch'} }", flush=True)
    return rows, summary


def randomize_lstm(model, seed: int) -> None:
    """Seeded biases and peepholes for the GravesLSTM layers (peepholes
    start at 0, which would leave the peephole path untested)."""
    g = torch.Generator().manual_seed(seed)
    for p in model.params_:
        for k in ("b", "pI", "pF", "pO"):
            if k in p and "Wh" in p:
                p[k] = p[k] + (torch.randn(p[k].shape, generator=g) * 0.3).to(p[k].device)


def plain_forward(fl, model, x, mask):
    """TextGenerationLSTM on its plain path on the card, written out here:
    ``reference_lstm_cell`` per layer and step, the reference's masked carry
    hold, and the per-timestep softmax head by torch ops."""
    params, (b, t_len, _) = model.params_, x.shape
    seq = x
    for p in params[:-1]:
        n = p["Wh"].shape[0]
        h = torch.zeros(b, n, device=x.device)
        c = torch.zeros(b, n, device=x.device)
        outs = []
        for t in range(t_len):
            hn, cn = fl.reference_lstm_cell(seq[:, t], h, c, p["Wx"], p["Wh"], p["b"],
                                            p["pI"], p["pF"], p["pO"])
            m = mask[:, t:t + 1]
            h, c = m * hn + (1 - m) * h, m * cn + (1 - m) * c
            outs.append(hn * m)
        seq = torch.stack(outs, dim=1)
    head = params[-1]
    return torch.softmax(seq @ head["W"] + head["b"], -1) * mask[..., None]


def _one_hot(seqs, t_len):
    x = np.zeros((len(seqs), t_len, TEXTGEN_VOCAB), np.float32)
    mask = np.zeros((len(seqs), t_len), np.float32)
    for i, s in enumerate(seqs):
        x[i, np.arange(len(s)), s] = 1.0
        mask[i, :len(s)] = 1.0
    return torch.from_numpy(x).cuda(), torch.from_numpy(mask).cuda()


def _decided(probs, dp):
    """Whether each position's top-2 gap exceeds 2 max|dp|."""
    top2 = torch.topk(probs, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * dp


def generation_phase(fl, card: str):
    """Phase 7: a full-width TextGenerationLSTM (77 characters, two
    GravesLSTM(256), RnnOutputLayer(77); seeded) served by a 32-slot
    GenerationEngine, a seq-bucketed InferenceEngine and an int8-head
    engine."""
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine

    t0 = time.perf_counter()
    model = TextGenerationLSTM(num_classes=TEXTGEN_VOCAB, units=LSTM_UNITS, seed=SEED).init()
    randomize_lstm(model, SEED)
    rng = np.random.default_rng(SEED + 21)
    spread_x = np.eye(TEXTGEN_VOCAB, dtype=np.float32)[rng.integers(0, TEXTGEN_VOCAB, (16, 32))]
    scale = spread_softmax(model, spread_x)
    engine = GenerationEngine(model, n_slots=GEN_SLOTS, max_length=GEN_MAX_LENGTH,
                              prefill_buckets=GEN_BUCKETS, queue_limit=2 * GEN_REQUESTS,
                              default_timeout_s=600.0)
    prompts = [rng.integers(0, TEXTGEN_VOCAB, int(rng.integers(3, 101))).astype(np.int32)
               for _ in range(GEN_REQUESTS)]
    knobs = [SAMPLED if i % 2 else {} for i in range(GEN_REQUESTS)]
    print(f"phase 7 setup: TextGenerationLSTM {TEXTGEN_VOCAB} classes, 2 x GravesLSTM"
          f"({LSTM_UNITS}), f32, {model.num_params():,} params, output W scaled by "
          f"{scale:.4g}, init {time.perf_counter() - t0:.1f}s; engine {engine.describe()}",
          flush=True)

    # the main path: counts from 0 just before, read just after
    fl.reset_launch_counts()
    warm = engine.warmup()
    decode_s, prefill_s = [], {}
    # cell launches of each decode step, and of each prefill by its bucket
    decode_n, prefill_n = [], {}
    decode, prefill = engine.backend.decode, engine.backend.prefill

    def timed_decode(*a):
        n0, t = fl.launch_counts[fl.OP], time.perf_counter()
        out = decode(*a)  # ends in the device-to-host copy of the tokens
        decode_s.append(time.perf_counter() - t)
        decode_n.append(fl.launch_counts[fl.OP] - n0)
        return out

    def timed_prefill(*a):
        n0, t = fl.launch_counts[fl.OP], time.perf_counter()
        out = prefill(*a)
        prefill_s.setdefault(out[2], []).append(time.perf_counter() - t)
        prefill_n.setdefault(out[2], []).append(fl.launch_counts[fl.OP] - n0)
        return out

    engine.backend.decode, engine.backend.prefill = timed_decode, timed_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors still alive
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new=GEN_MAX_NEW, seed=SEED + i, **kw)
            for i, (p, kw) in enumerate(zip(prompts, knobs))]
    outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    main_launches = dict(fl.launch_counts)
    engine.backend.decode, engine.backend.prefill = decode, prefill
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    steps = engine.metrics.snapshot()["decode_steps"]
    tbs = [engine.backend.bucket_for(len(p)) for p in prompts]
    expected = (2 * sum(engine.backend.buckets) + 2   # warmup: a prefill per bucket, a decode
                + 2 * steps + 2 * sum(tbs))
    tokens = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    tok_s = tokens / wall
    step_ms = float(np.median(decode_s) * 1e3)
    prefill_ms = {int(tb): float(np.median(v) * 1e3) for tb, v in sorted(prefill_s.items())}
    per_decode = sorted(set(decode_n))
    per_prefill = {int(tb): sorted(set(v)) for tb, v in sorted(prefill_n.items())}
    print(f"phase 7 generate: {GEN_REQUESTS} requests (prompts 3-100, max_new {GEN_MAX_NEW}, "
          f"half greedy, half {SAMPLED}) in {wall:.3f}s: {tokens} tokens, {tok_s:.1f} tokens/s, "
          f"{steps} decode steps, median decode step {step_ms:.3f} ms (host clock, ends in the "
          f"token copy), median prefill ms by bucket {prefill_ms}, peak {peak_gib:.4f} GiB above "
          f"the {held / 2 ** 30:.3f} GiB earlier phases hold; "
          f"warmup {warm}; launches {main_launches} (expected fused_lstm_cell {expected} = 2 per "
          f"decode step, 2 tb per prefill, and the warmup's); measured per decode step "
          f"{per_decode} over {len(decode_n)} steps, per prefill by bucket {per_prefill} on "
          f"{card}", flush=True)

    # teacher-forced: each request's own tokens through both paths
    seqs = [o[:-1] for o in outs]
    t_len = max(len(s) for s in seqs)
    x, mask = _one_hot(seqs, t_len)
    with torch.inference_mode():
        yk, _, _ = model._forward(model.params_, model.state_, x, fmask=mask)
        yp = plain_forward(fl, model, x, mask)
    dp = float((yk - yp).abs().max())
    decided_all = _decided(yp, dp)
    greedy_ok, decided_n, greedy_n = True, 0, 0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if knobs[i]:
            continue
        pos = np.arange(len(p) - 1, len(o) - 1)
        want = yp[i, pos].argmax(-1).cpu().numpy()
        dec = decided_all[i, pos].cpu().numpy()
        got = o[len(p):]
        greedy_ok &= bool(np.all(got[dec] == want[dec]))
        decided_n += int(dec.sum())
        greedy_n += len(pos)
    maxprob = float(yp.amax(-1)[mask > 0].mean())
    print(f"phase 7 check: teacher-forced per-step probabilities, kernel path vs plain path on "
          f"the card, max|dp| {dp:.3g} (tol {TEACHER_TOL}); greedy tokens equal the plain "
          f"argmax at {decided_n}/{greedy_n} decided steps (top-2 gap > 2 max|dp|): "
          f"{greedy_ok}; mean max prob {maxprob:.3f}", flush=True)

    # engine == solo: four greedy requests alone in a 1-slot engine
    solo_eng = GenerationEngine(model, n_slots=1, max_length=GEN_MAX_LENGTH,
                                prefill_buckets=GEN_BUCKETS, default_timeout_s=600.0)
    exact, solo_ok = [], True
    try:
        for i in (0, 2, 4, 6):
            alone = solo_eng.submit(prompts[i], max_new=GEN_MAX_NEW, seed=SEED + i).result(600)
            exact.append(bool(np.array_equal(alone, outs[i])))
            if not exact[-1]:  # the first divergence must sit on an undecided step
                j = int(np.argmax(alone != outs[i]))
                solo_ok &= not bool(decided_all[i, j - 1])
    finally:
        solo_eng.shutdown()
    print(f"phase 7 engine == solo: 4 greedy requests alone in a 1-slot engine, token-identical "
          f"{exact} (cuBLAS f32 head batch-invariant here: {all(exact)})", flush=True)

    # seq-bucketed predict and the int8 head engine
    seq_buckets = list(TextGenerationLSTM.serving_seq_buckets)
    e32 = InferenceEngine(model, buckets=BucketPolicy(batch_buckets=[1, 4],
                                                      seq_buckets=seq_buckets))
    e8 = InferenceEngine(model, buckets=BucketPolicy(batch_buckets=[1, 4],
                                                     seq_buckets=seq_buckets), int8_serving=True)
    predict, failed = [], []
    for length in (5, 17, 40):
        ids = rng.integers(0, TEXTGEN_VOCAB, length)
        xs, ms = _one_hot([ids], length)
        tb = next(t for t in seq_buckets if t >= length)
        fl.reset_launch_counts()
        y = e32.infer(xs.cpu().numpy())
        l32 = dict(fl.launch_counts)
        fl.reset_launch_counts()
        y8 = e8.infer(xs.cpu().numpy())
        l8 = dict(fl.launch_counts)
        with torch.inference_mode():
            ref = plain_forward(fl, model, xs, ms).cpu().numpy()
        row = {"length": length, "bucket": tb, "launches_f32": l32, "launches_int8": l8,
               "max_abs_dp_vs_plain": float(np.abs(y - ref).max()),
               "max_abs_dp_int8_vs_f32": float(np.abs(y8 - y).max())}
        predict.append(row)
        if l32 != {"fused_lstm_cell": 2 * tb}:
            failed.append(f"seq predict {length}: launches {l32}, expected {2 * tb} cells")
        if l8 != {"fused_lstm_cell": 2 * tb, "int8_matmul": 1}:
            failed.append(f"int8 predict {length}: launches {l8}")
        if row["max_abs_dp_vs_plain"] > TEACHER_TOL or row["max_abs_dp_int8_vs_f32"] > INT8_HEAD_TOL:
            failed.append(f"seq predict {row}")
        if y.shape != (1, length, TEXTGEN_VOCAB) or _row_sum_dev(y.reshape(-1, TEXTGEN_VOCAB)) > 1e-5:
            failed.append(f"seq predict {length}: bad output {y.shape}")
    print(f"phase 7 predict: seq-bucketed InferenceEngine (buckets {seq_buckets}) and its int8 "
          f"head engine, {predict}; int8 report {e8.int8_report}", flush=True)

    if main_launches.get("fused_lstm_cell") != expected or set(main_launches) != {"fused_lstm_cell"}:
        failed.append(f"launches {main_launches}, expected fused_lstm_cell {expected}")
    if per_decode != [2] or any(v != [2 * tb] for tb, v in per_prefill.items()):
        failed.append(f"cell launches per decode step {per_decode}, per prefill {per_prefill}: "
                      f"expected [2] and 2 tb")
    if any(len(o) != len(p) + GEN_MAX_NEW or o.min() < 0 or o.max() >= TEXTGEN_VOCAB
           for o, p in zip(outs, prompts)):
        failed.append("a generated sequence has the wrong length or a token out of range")
    if dp > TEACHER_TOL or not np.isfinite(dp):
        failed.append(f"teacher-forced max|dp| {dp}")
    if not greedy_ok:
        failed.append("a greedy token differs from the plain argmax at a decided step")
    if not solo_ok:
        failed.append(f"engine vs solo diverged at a decided step: {exact}")
    if not 0.05 <= maxprob <= 0.9:
        failed.append(f"mean max probability {maxprob} outside [0.05, 0.9]")
    if failed:
        raise AssertionError("; ".join(failed))
    return engine, e32, prompts, outs, {
        "main_launches": main_launches, "expected_launches": expected,
        "decode_steps": steps, "prefill_buckets": tbs, "output_w_scale": scale,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tok_s,
        "launches_per_decode_step": per_decode, "launches_per_prefill_by_bucket": per_prefill,
        "median_decode_step_ms": step_ms, "decode_step_ms": [d * 1e3 for d in decode_s],
        "median_prefill_ms_by_bucket": prefill_ms, "peak_gib": peak_gib, "warmup": warm,
        "teacher_forced_max_abs_dp": dp, "greedy_decided_steps": decided_n,
        "greedy_steps": greedy_n, "mean_max_prob": maxprob, "engine_vs_solo_exact": exact,
        "predict": predict, "int8_report": e8.int8_report}


def generation_entry_points(engine_seq, gen, prompts, outs):
    """Phase 6 for generation: ``POST /generate`` over HTTP equals
    ``engine.submit``; ``cli serve --model textgenlstm --gen-slots 4
    --smoke`` exits 0."""
    from deeplearning4j_tpu_torch.serving import InferenceServer

    srv = InferenceServer(engine_seq, port=0, generation=gen).start()
    try:
        code, raw = _http(srv.port, "POST", "/generate", json.dumps(
            {"prompt": prompts[0].tolist(), "max_new": GEN_MAX_NEW, "stream": False}))
        body = json.loads(raw)
        _, h = _http(srv.port, "GET", "/healthz")
        h = json.loads(h)
    finally:
        srv.shutdown()  # also drains and stops the generation engine
    same = code == 200 and body.get("sequence") == outs[0].tolist()
    print(f"phase 6 generate: POST /generate (greedy, {len(prompts[0])}-token prompt) HTTP "
          f"{code}, equals engine.submit: {same}; /healthz generation "
          f"{h.get('generation', {}).get('backend')} inflight {h.get('generation_inflight')}",
          flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                        "--model", "textgenlstm", "--num-classes", str(TEXTGEN_VOCAB),
                        "--gen-slots", "4", "--port", "0", "--smoke"],
                       cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=300)
    cli_ok = (r.returncode == 0 and "smoke: HTTP 200 ok" in r.stdout
              and "smoke: generate HTTP 200 ok" in r.stdout)
    print(f"phase 6 cli serve --model textgenlstm --num-classes {TEXTGEN_VOCAB} --gen-slots 4 "
          f"--port 0 --smoke: exit {r.returncode} in {time.perf_counter() - t0:.1f}s; "
          f"{' | '.join(r.stdout.strip().splitlines())}", flush=True)
    failed = []
    if not same:
        failed.append(f"/generate answered {code} {body}")
    if not cli_ok:
        failed.append(f"cli serve --gen-slots --smoke failed: {r.stdout[-2000:]} "
                      f"{r.stderr[-2000:]}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"generate_equals_submit": same, "cli_smoke_stdout": r.stdout}


# ---------------------------------------------------------------------------
# the flash-attention forward (phase 2e) and TransformerLM serving (phase 8)
# ---------------------------------------------------------------------------
# GPT-2 small's widths, depth and context, the JAX package's benchmark
# vocabulary and dtype (bench.py _bench_lm_decode / _bench_transformer)
LM_CONF = dict(vocab_size=32000, d_model=768, n_heads=12, n_layers=12, max_length=1024,
               compute_dtype="bfloat16")
LM_HEADS, LM_HD = 12, 64
LM_SLOTS, LM_REQUESTS, LM_MAX_NEW = 32, 64, 64
LM_BUCKETS = [16, 32, 64, 128, 256, 512, 1024]
LM_TARGET_MAXPROB = 0.3
# phase 8's limits on max|dlogit| (bf16 model, logits f32). Each is set from
# a reading on the H100 with room on both sides: the teacher-forced forward
# (kernel vs plain attention) read 0.25 and is held to 1.0; prefill against
# forward read exactly 0 at buckets >= 128 (the same kernel and row-wise ops;
# the limit leaves one bf16 step of the final logits) and 0.22 at bucket 32
# (the einsum path); the decode path teacher-forced read 0.23; /predict
# against the plain-attention forward 0.25 and 0.26
PREFILL_LIMIT_KERNEL = 0.0625
PREFILL_LIMIT_EINSUM = 0.5
DECODE_LIMIT = 1.0
PREDICT_LIMIT = 1.0
# (b, h, T, hd, causal, dtype, segmented): the prefill buckets >= 128 (b 1),
# a /predict forward (b 2, T 1024), the train step's (b 16 x T 512, b 4 x T
# 2048), non-causal, segment ids cut off the 128-row tiles, head dims 32,
# 128, 40 and a ragged 20 (the padded layout copy), and f32 at two shapes
FLASH_CASES = ([(1, LM_HEADS, t, LM_HD, True, BF16, False) for t in (128, 256, 512, 1024)]
               + [(2, LM_HEADS, 1024, LM_HD, True, BF16, False),
                  (16, LM_HEADS, 512, LM_HD, True, BF16, False),
                  (4, LM_HEADS, 2048, LM_HD, True, BF16, False),
                  (1, LM_HEADS, 512, LM_HD, False, BF16, False),
                  (1, LM_HEADS, 512, LM_HD, True, BF16, True),
                  (1, 4, 256, 32, True, BF16, False), (1, 4, 256, 128, True, BF16, False),
                  (1, 4, 256, 40, True, BF16, True), (1, 4, 256, 20, True, BF16, False),
                  (1, LM_HEADS, 256, LM_HD, True, F32, False),
                  (2, 4, 512, 40, False, F32, True)])
FLASH_F32_TOL = 1e-5          # f32 o and lse, and bf16 lse, against the plain version in f32


def flash_segments(b, t_len):
    """Three packed sequences per row, cut at T/3 and T/3 + 77 (off the
    kernels' 64- and 128-row tiles)."""
    seg = torch.zeros(b, t_len, dtype=torch.int32, device="cuda")
    seg[:, t_len // 3:] = 1
    seg[:, t_len // 3 + 77:] = 2
    return seg


def flash_oracle(fa, q, k, v, causal, scale, seg):
    """The plain version in f32 on the exactly widened operands, and the
    per-element limit: f32 FLASH_F32_TOL; bf16 2^-8 (P @ |v|) + 2^-8 |o| +
    1e-5 (one rounding of p and one of o, nothing more)."""
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_plain(q32, k32, v32, causal, scale, seg)
    if q.dtype == F32:
        return o_ref, lse_ref, torch.full_like(o_ref, FLASH_F32_TOL)
    p_ref = torch.softmax(fa.masked_scores(q32, k32, causal, scale, seg), -1)
    tol = 2.0 ** -8 * (p_ref @ v32.abs()) + 2.0 ** -8 * o_ref.abs() + FLASH_F32_TOL
    return o_ref, lse_ref, tol


def flash_cost(b, h, t_len, hd, causal, dtype, segmented):
    """(FLOPs, bytes) of one call: QK^T and PV, 4 T^2 hd b h FLOPs, half of
    it causal; q, k, v read once, o and lse written once, segment ids read."""
    flops = 4.0 * t_len * t_len * hd * b * h * (0.5 if causal else 1.0)
    size = 2 if dtype == BF16 else 4
    nbytes = 4 * t_len * b * h * hd * size + 4 * t_len * b * h + (4 * b * t_len if segmented else 0)
    return bound(flops, nbytes, PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)


def flash_phase(fa):
    """Phase 2e: the flash-attention forward against its plain version on
    the card at every case; times at the prefill and /predict shapes, beside
    F.scaled_dot_product_attention on the same inputs (the yardstick only)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    rows = []
    for b, h, t_len, hd, causal, dtype, segmented in FLASH_CASES:
        q, k, v = (torch.randn(b, h, t_len, hd, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        seg = flash_segments(b, t_len) if segmented else None
        scale = hd ** -0.5
        with torch.inference_mode():
            o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, seg)
            torch.cuda.synchronize()
            o_ref, lse_ref, tol = flash_oracle(fa, q, k, v, causal, scale, seg)
            err = (o.float() - o_ref).abs()
            lse_err = float((lse - lse_ref).abs().max())
            row = {"b": b, "h": h, "T": t_len, "hd": hd, "causal": causal,
                   "dtype": str(dtype).split(".")[-1], "segmented": segmented,
                   "max_abs_err": float(err.max()), "err_over_tol": float((err / tol).max()),
                   "lse_max_abs_err": lse_err,
                   "finite": bool(torch.isfinite(o.float()).all())}
            if causal:  # the limit would catch a lost causal mask
                o_nc = fa.flash_attention_plain(q.float(), k.float(), v.float(), False, scale,
                                                seg)[0]
                row["lost_mask_over_tol"] = float(((o_nc - o_ref).abs() / tol).max())
            timing = ""
            if dtype == BF16 and hd == LM_HD and causal and not segmented:
                kern = lambda: fa.flash_attention_fwd(q, k, v, True, scale)  # noqa: E731
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=True, scale=scale)
                row["kernel_ms"] = time_ms(kern)
                row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, scale))
                sdpa = lib()
                row["library_max_abs_err"] = float((sdpa.float() - o_ref).abs().max())
                row["library_ms"] = time_ms(lib)
                row["kernel_device_ms"], row["library_device_ms"] = graph_ms(kern), graph_ms(lib)
                row["bound_ms"], row["bound_by"] = flash_cost(b, h, t_len, hd, causal, dtype,
                                                              segmented)
                timing = (f" kernel_ms {row['kernel_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                          f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}) library_ms "
                          f"{row['library_ms']:.4f} (SDPA, max|d| vs f32 "
                          f"{row['library_max_abs_err']:.3g}); device only (CUDA graph): "
                          f"kernel {row['kernel_device_ms']:.4f} SDPA "
                          f"{row['library_device_ms']:.4f}")
        rows.append(row)
        ok = (row["err_over_tol"] <= 1 and lse_err <= FLASH_F32_TOL and row["finite"]
              and row.get("lost_mask_over_tol", 2.0) > 1)
        mask_txt = (f" lost-mask diff/tol {row['lost_mask_over_tol']:.3g}" if causal else "")
        print(f"phase 2e kernel flash_attention_fwd b {b} h {h} T {t_len} hd {hd} "
              f"{'causal' if causal else 'full'}{' segments' if segmented else ''} "
              f"{row['dtype']}: max_abs_err {row['max_abs_err']:.3g} vs the plain version in f32 "
              f"(tol {'2^-8 P|v| + 2^-8|o| + 1e-5' if dtype == BF16 else FLASH_F32_TOL}) "
              f"err/tol {row['err_over_tol']:.3g}; lse max_abs_err {lse_err:.3g}"
              f"{mask_txt}{timing} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {row}")
    timed = [r for r in rows if "kernel_ms" in r]
    head = next(r for r in timed if r["b"] == 1 and r["T"] == 1024)
    summary = {k: head[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
    summary.update({"max_abs_err": max(r["max_abs_err"] for r in rows),
                    "max_err_over_tol": max(r["err_over_tol"] for r in rows),
                    "min_lost_mask_over_tol": min(r["lost_mask_over_tol"] for r in rows
                                                  if "lost_mask_over_tol" in r),
                    "by_shape": [{k: r[k] for k in ("b", "T", "kernel_ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms",
                                                    "kernel_device_ms", "library_device_ms")}
                                 for r in timed]})
    print(f"phase 2e summary (headline: b 1, 12 heads, T 1024, causal bf16): {summary}",
          flush=True)
    return rows, summary


def lm_spread_softmax(tlm, model, ids: torch.Tensor, target: float = LM_TARGET_MAXPROB) -> float:
    """Scale the seeded head (in place) so that the mean max probability of
    the served softmax on ``ids`` is about ``target``: with head ~ N(0, 1/d)
    over 32,000 tokens it is ~1e-3, and every greedy check would be decided
    by noise. Returns the scale."""
    with torch.inference_mode():
        z = tlm.forward(model.cfg, model.compute_params(), ids).reshape(-1, model.cfg.vocab_size)
        lo, hi = 1e-2, 1e3
        for _ in range(50):
            mid = math.sqrt(lo * hi)
            m = float(torch.softmax(mid * z, -1).amax(-1).mean())
            lo, hi = (lo, mid) if m > target else (mid, hi)
    scale = math.sqrt(lo * hi)
    with torch.no_grad():
        model.params_["head"].mul_(scale)
    return scale


def _top2_gap(logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _first_divergence(a, b):
    """Index of the first differing generated token, or None."""
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return None if diff.size == 0 else int(diff[0])


def lm_phase(fa, card: str):
    """Phase 8: a full-width TransformerLM (GPT-2 small's shape, 32,000
    tokens, bf16; seeded, head scaled) served by a 32-slot GenerationEngine
    (64 requests) and an InferenceEngine (/predict)."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    from deeplearning4j_tpu_torch.serving import BucketPolicy, InferenceEngine
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine

    t0 = time.perf_counter()
    model = tlm.TransformerLM(seed=SEED, **LM_CONF).init()
    cfg = model.cfg
    n_layers = cfg.n_layers  # one flash launch per layer of a prefill or forward
    rng = np.random.default_rng(SEED + 41)
    V = cfg.vocab_size
    ids2 = torch.from_numpy(rng.integers(0, V, (2, 1024))).cuda()
    scale = lm_spread_softmax(tlm, model, ids2[:, :256])
    init_s = time.perf_counter() - t0

    def plain_attn(q, k, v, *, causal, mask=None):
        return fa.flash_attention_plain(q, k, v, causal, q.shape[-1] ** -0.5)[0]

    # teacher-forced: the kernel route against the plain attention, b 2, T 1024
    fa.reset_launch_counts()
    with torch.inference_mode():
        params = model.compute_params()
        yk = tlm.forward(cfg, params, ids2)
        fwd_launches = dict(fa.launch_counts)
        yp = tlm.forward(cfg, params, ids2, attn_fn=plain_attn)
    d_kernel = float((yk - yp).abs().max())
    # the one noise yardstick of phase 8: two positions' top-1 must agree
    # where the top-2 gap is over twice the kernel's measured difference
    # from the plain attention
    thr = 2 * d_kernel
    decided = _top2_gap(yp) > thr
    top1_ok = bool((yk.argmax(-1) == yp.argmax(-1))[decided].all())
    maxprob_fwd = float(torch.softmax(yk, -1).amax(-1).mean())
    # prefill at length= against forward at that position (row 0). At a
    # bucket >= 128 both run the kernel and the same row-wise ops (measured
    # bitwise equal on the H100); below, prefill's einsum path differs from
    # the kernel by bf16 rounding, as the kernel differs from the plain path
    prefill_rows = []
    for length in (20, 100, 128, 129, 300, 1000):
        tb = next(t for t in LM_BUCKETS if t >= length)
        padded = torch.zeros(1, tb, dtype=torch.int64, device="cuda")
        padded[0, :length] = ids2[0, :length]
        cache = tlm.init_decode_cache(cfg, 1, device="cuda")
        fa.reset_launch_counts()
        with torch.inference_mode():
            lg, cache = tlm.prefill_cache(cfg, params, cache, padded, length=length)
        n = fa.launch_counts[fa.OP]
        d = float((lg[0] - yk[0, length - 1]).abs().max())
        decided_p = float(_top2_gap(yk[0, length - 1])) > thr
        same = bool(lg[0].argmax() == yk[0, length - 1].argmax()) or not decided_p
        prefill_rows.append({"length": length, "bucket": tb, "launches": n,
                             "max_abs_dlogit_vs_forward": d,
                             "limit": PREFILL_LIMIT_KERNEL if tb >= 128 else PREFILL_LIMIT_EINSUM,
                             "decided": decided_p, "top1_ok": same})
    # the decode path teacher-forced: prefill a prompt, feed the sequence's
    # own next tokens one decode step at a time, against forward's logits
    tp, steps = 300, 64
    cache = tlm.init_decode_cache(cfg, 1, device="cuda")
    padded = torch.zeros(1, 512, dtype=torch.int64, device="cuda")
    padded[0, :tp] = ids2[0, :tp]
    with torch.inference_mode():
        lg, cache = tlm.prefill_cache(cfg, params, cache, padded, length=tp)
        dec = [lg[0]]
        fa.reset_launch_counts()
        for j in range(steps - 1):
            lg, cache = tlm.decode_step(cfg, params, cache, ids2[0, tp + j:tp + j + 1])
            dec.append(lg[0])
        decode_launches = fa.launch_counts[fa.OP]
    d_decode = float((torch.stack(dec) - yk[0, tp - 1:tp - 1 + steps]).abs().max())
    print(f"phase 8 setup: TransformerLM {LM_CONF}, {model.num_params():,} params, head "
          f"scaled by {scale:.4g}, init {init_s:.1f}s", flush=True)
    print(f"phase 8 check: teacher-forced forward b 2 T 1024, kernel route vs plain attention "
          f"on the card: max|dlogit| {d_kernel:.4g}, top-1 equal at {int(decided.sum())}/"
          f"{decided.numel()} decided positions (top-2 gap > 2 max|dlogit|): {top1_ok}; "
          f"launches {fwd_launches} (expected {n_layers}); mean max prob {maxprob_fwd:.3f}; prefill at "
          f"length= vs forward: {prefill_rows}; decode path teacher-forced ({steps} steps after "
          f"a {tp}-token prompt) vs forward max|dlogit| {d_decode:.4g}, flash launches in "
          f"those decode steps {decode_launches} (limit {DECODE_LIMIT}); decided-step threshold "
          f"2 x the kernel's max|dlogit| = {thr:.4g}",
          flush=True)

    # the generation storm
    engine = GenerationEngine(model, n_slots=LM_SLOTS, max_length=cfg.max_length,
                              prefill_buckets=LM_BUCKETS, queue_limit=2 * LM_REQUESTS,
                              default_timeout_s=600.0)
    lengths = list(rng.integers(20, 129, LM_REQUESTS // 2)) + \
        list(rng.integers(129, 901, LM_REQUESTS // 2))
    rng.shuffle(lengths)
    prompts = [rng.integers(0, V, int(n)).astype(np.int32) for n in lengths]
    knobs = [SAMPLED if i % 2 else {} for i in range(LM_REQUESTS)]
    print(f"phase 8 engine: {engine.describe()}", flush=True)
    fa.reset_launch_counts()
    warm = engine.warmup()
    warm_launches = fa.launch_counts[fa.OP]
    decode_s, prefill_s, decode_n, prefill_n = [], {}, [], {}
    decode, prefill = engine.backend.decode, engine.backend.prefill

    def timed_decode(*a):
        n0, t = fa.launch_counts[fa.OP], time.perf_counter()
        out = decode(*a)  # ends in the device-to-host copy of the tokens
        decode_s.append(time.perf_counter() - t)
        decode_n.append(fa.launch_counts[fa.OP] - n0)
        return out

    def timed_prefill(*a):
        n0, t = fa.launch_counts[fa.OP], time.perf_counter()
        out = prefill(*a)
        prefill_s.setdefault(out[2], []).append(time.perf_counter() - t)
        prefill_n.setdefault(out[2], []).append(fa.launch_counts[fa.OP] - n0)
        return out

    engine.backend.decode, engine.backend.prefill = timed_decode, timed_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new=LM_MAX_NEW, seed=SEED + i, **kw)
            for i, (p, kw) in enumerate(zip(prompts, knobs))]
    outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    main_launches = dict(fa.launch_counts)
    engine.backend.decode, engine.backend.prefill = decode, prefill
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    n_steps = len(decode_s)
    tbs = [engine.backend.bucket_for(len(p)) for p in prompts]
    expected = n_layers * sum(tb >= 128 for tb in tbs)
    tokens = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    tok_s = tokens / wall
    step_ms = float(np.median(decode_s) * 1e3)
    prefill_ms = {int(tb): float(np.median(v) * 1e3) for tb, v in sorted(prefill_s.items())}
    per_decode = sorted(set(decode_n))
    per_prefill = {int(tb): sorted(set(v)) for tb, v in sorted(prefill_n.items())}
    print(f"phase 8 generate: {LM_REQUESTS} requests (prompts {min(lengths)}-{max(lengths)} "
          f"tokens, {sum(n > 128 for n in lengths)} over 128, max_new {LM_MAX_NEW}, half greedy, "
          f"half {SAMPLED}) in {wall:.3f}s: {tokens} tokens, {tok_s:.1f} tokens/s, {n_steps} "
          f"decode steps, median decode step {step_ms:.3f} ms (host clock, ends in the token "
          f"copy), median prefill ms by bucket {prefill_ms}, peak {peak_gib:.4f} GiB above the "
          f"{held / 2 ** 30:.3f} GiB held (the slab "
          f"{engine.backend.cache_bytes / 2 ** 30:.3f} GiB among it); warmup {warm} with "
          f"{warm_launches} flash launches; launches {main_launches} (expected "
          f"flash_attention_fwd {expected} = {n_layers} per prefill at a bucket >= 128); measured per "
          f"decode step {per_decode} over {n_steps} steps, per prefill by bucket {per_prefill} "
          f"on {card}", flush=True)

    # agreement: generate_cached, engine == solo, on the greedy requests
    greedy = [i for i in range(LM_REQUESTS) if not knobs[i]]
    picks = [i for i in greedy if len(prompts[i]) > 128][:2] + \
        [i for i in greedy if len(prompts[i]) <= 128][:2]
    solo = GenerationEngine(model, n_slots=1, max_length=cfg.max_length,
                            prefill_buckets=LM_BUCKETS, default_timeout_s=600.0)
    agree, failed = [], []
    try:
        for i in picks:
            p, o = prompts[i], outs[i]
            cached = model.generate_cached(p[None], max_new=LM_MAX_NEW)[0]
            alone = solo.submit(p, max_new=LM_MAX_NEW, seed=SEED + i).result(600)
            with torch.inference_mode():
                gap = _top2_gap(tlm.forward(cfg, params, torch.from_numpy(
                    o[:-1].astype(np.int64))[None].cuda())[0, len(p) - 1:])
            row = {"request": i, "prompt": len(p)}
            for name, other in (("generate_cached", cached), ("solo", alone)):
                j = _first_divergence(o[len(p):], other[len(p):])
                row[name] = "identical" if j is None else \
                    f"diverges at step {j}, top-2 gap {float(gap[j]):.4g}"
                if j is not None and float(gap[j]) > thr:
                    failed.append(f"request {i}: {name} diverges at a decided step {j}")
            agree.append(row)
    finally:
        solo.shutdown()
    with torch.inference_mode():
        gen_probs = [float(torch.softmax(tlm.forward(cfg, params, torch.from_numpy(
            o[:-1].astype(np.int64))[None].cuda())[0, len(p) - 1:], -1).amax(-1).mean())
            for p, o in zip(prompts[:8], outs[:8])]
    maxprob = float(np.mean(gen_probs))
    print(f"phase 8 agreement: {agree}; mean max prob over the first 8 generated sequences "
          f"{maxprob:.3f}", flush=True)

    # /predict: T 1024 (12 launches per forward) and T 100 (the einsum path)
    pe = InferenceEngine(model, buckets=BucketPolicy(batch_buckets=[1, 2]))
    predict = []
    for b, t_len in ((2, 1024), (1, 100)):
        x = ids2[:b, :t_len].cpu().numpy()
        fa.reset_launch_counts()
        y = pe.infer(x)
        n = dict(fa.launch_counts)
        with torch.inference_mode():
            ref = tlm.forward(cfg, params, ids2[:b, :t_len], attn_fn=plain_attn)
        yt = torch.from_numpy(y).cuda()
        d = float((yt - ref).abs().max())
        dec = _top2_gap(ref) > thr
        ok1 = bool((yt.argmax(-1) == ref.argmax(-1))[dec].all())
        predict.append({"rows": b, "T": t_len, "launches": n, "max_abs_dlogit_vs_plain": d,
                        "limit": PREDICT_LIMIT, "top1_equal_at_decided": ok1,
                        "decided": int(dec.sum())})
        want = {"flash_attention_fwd": n_layers} if t_len % 128 == 0 else {}
        if n != want or not ok1 or not int(dec.sum()) or not d <= PREDICT_LIMIT or \
                y.shape != (b, t_len, V) or not np.isfinite(y).all():
            failed.append(f"/predict {predict[-1]}")
    print(f"phase 8 predict: InferenceEngine(TransformerLM), buckets [1, 2]: {predict}",
          flush=True)

    if fwd_launches != {"flash_attention_fwd": n_layers}:
        failed.append(f"forward launches {fwd_launches}, expected {n_layers}")
    if not d_kernel <= 1.0 or not top1_ok or not int(decided.sum()):
        failed.append(f"teacher-forced max|dlogit| {d_kernel} (limit 1.0), top-1 at "
                      f"{int(decided.sum())} decided positions {top1_ok}")
    for r in prefill_rows:
        want = n_layers if r["bucket"] >= 128 else 0
        if r["launches"] != want or not r["top1_ok"] or \
                not r["max_abs_dlogit_vs_forward"] <= r["limit"]:
            failed.append(f"prefill {r}: expected {want} launches")
    if not any(r["decided"] for r in prefill_rows):
        failed.append("no prefill position decided its top-1")
    if not d_decode <= DECODE_LIMIT:
        failed.append(f"decode path max|dlogit| vs forward {d_decode} over {DECODE_LIMIT}")
    if decode_launches != 0:
        failed.append(f"{decode_launches} flash launches in decode steps")
    if main_launches.get(fa.OP, 0) != expected or set(main_launches) - {fa.OP}:
        failed.append(f"launches {main_launches}, expected flash_attention_fwd {expected}")
    if warm_launches != n_layers * sum(tb >= 128 for tb in engine.backend.buckets):
        failed.append(f"warmup launched {warm_launches}")
    if per_decode != [0] or any(v != [n_layers if tb >= 128 else 0]
                                for tb, v in per_prefill.items()):
        failed.append(f"launches per decode step {per_decode}, per prefill {per_prefill}: "
                      f"expected [0], {n_layers} at buckets >= 128 and 0 below")
    if sum(n > 128 for n in lengths) < 8:
        failed.append("fewer than 8 prompts over 128 tokens")
    if any(len(o) != len(p) + LM_MAX_NEW or o.min() < 0 or o.max() >= V
           for o, p in zip(outs, prompts)):
        failed.append("a generated sequence has the wrong length or a token out of range")
    if not 0.05 <= maxprob <= 0.9:
        failed.append(f"mean max probability {maxprob} outside [0.05, 0.9]")
    if failed:
        raise AssertionError("; ".join(failed))
    return engine, pe, prompts, outs, {
        "conf": LM_CONF, "num_params": model.num_params(), "head_scale": scale,
        "teacher_forced_max_abs_dlogit": d_kernel, "top1_decided": int(decided.sum()),
        "prefill_vs_forward": prefill_rows, "decode_vs_forward_max_abs_dlogit": d_decode,
        "decided_threshold": thr, "main_launches": main_launches,
        "expected_launches": expected, "warmup_launches": warm_launches,
        "launches_per_decode_step": per_decode, "launches_per_prefill_by_bucket": per_prefill,
        "decode_steps": n_steps, "tokens": tokens, "wall_s": wall, "tokens_per_s": tok_s,
        "median_decode_step_ms": step_ms, "decode_step_ms": [s * 1e3 for s in decode_s],
        "median_prefill_ms_by_bucket": prefill_ms, "peak_gib": peak_gib,
        "slab_bytes": engine.backend.cache_bytes, "warmup": warm, "agreement": agree,
        "mean_max_prob": maxprob, "predict": predict}


def lm_entry_points(pe, gen, prompts, outs):
    """Phase 6 for the TransformerLM: ``POST /generate`` over HTTP equals
    ``engine.submit``; ``POST /predict`` of a 16-token row equals
    ``engine.infer``."""
    from deeplearning4j_tpu_torch.serving import InferenceServer

    i = next(j for j in range(len(prompts)) if j % 2 == 0)  # a greedy request
    srv = InferenceServer(pe, port=0, generation=gen).start()
    try:
        code, raw = _http(srv.port, "POST", "/generate", json.dumps(
            {"prompt": prompts[i].tolist(), "max_new": LM_MAX_NEW, "stream": False}))
        body = json.loads(raw)
        row = prompts[i][:16][None]
        code_p, raw_p = _http(srv.port, "POST", "/predict",
                              json.dumps({"inputs": row.tolist()}))
        yp = np.asarray(json.loads(raw_p)["outputs"], np.float32)
        _, h = _http(srv.port, "GET", "/healthz")
        h = json.loads(h)
    finally:
        srv.shutdown()  # also drains and stops the generation engine
    same = code == 200 and body.get("sequence") == outs[i].tolist()
    dp = float(np.abs(yp - pe.infer(row)).max())
    print(f"phase 6 generate (TransformerLM): POST /generate (greedy, {len(prompts[i])}-token "
          f"prompt) HTTP {code}, equals engine.submit: {same}; POST /predict 16 tokens HTTP "
          f"{code_p}, max|d| vs engine.infer {dp:.3g}; /healthz generation "
          f"{h.get('generation', {}).get('backend')}", flush=True)
    if not same or code_p != 200 or dp > 1e-6:
        raise AssertionError(f"TransformerLM HTTP: /generate {code} {body}, /predict {code_p} {dp}")
    return {"generate_equals_submit": same, "predict_max_abs_diff": dp}


# ---------------------------------------------------------------------------
# the flash-attention backward (phase 2f) and TransformerLM training (phase 9)
# ---------------------------------------------------------------------------
# (b, h, T, hd, causal, dtype, segmented): the train step's shape (b 16, T
# 512) and its long-context variant (b 4, T 2048), T 128 and 1024,
# non-causal, segment ids cut off the 64- and 128-row tiles, head dims 32,
# 128, 40 and a ragged 20 (the padded layout copy), f32 at two shapes, and T
# 192 (the backward's T % 64: dq's and dkv's last 128-row block half past T;
# o and lse from the plain forward, which takes it); the first two are timed
FLASH_BWD_CASES = [(16, LM_HEADS, 512, LM_HD, True, BF16, False),
                   (4, LM_HEADS, 2048, LM_HD, True, BF16, False),
                   (2, LM_HEADS, 128, LM_HD, True, BF16, False),
                   (2, LM_HEADS, 1024, LM_HD, True, BF16, False),
                   (2, LM_HEADS, 512, LM_HD, False, BF16, False),
                   (2, LM_HEADS, 512, LM_HD, True, BF16, True),
                   (1, 4, 256, 32, True, BF16, False), (1, 4, 256, 128, True, BF16, False),
                   (1, 4, 256, 40, True, BF16, True), (1, 4, 256, 20, True, BF16, True),
                   (1, LM_HEADS, 256, LM_HD, True, F32, False),
                   (2, 4, 512, 40, False, F32, True),
                   (2, LM_HEADS, 192, LM_HD, True, BF16, False),
                   (1, 4, 192, 128, False, BF16, True)]
FLASH_BWD_TIMED = 2
# the JAX probe's gradient limits (8 x its forward's 2e-4 f32 and 2e-2 bf16,
# deeplearning4j_tpu/nn/conf/layers/attention.py:123,136-139): no per-element
# limit of phase 2f is looser
FLASH_BWD_CAP = {F32: 8 * 2e-4, BF16: 8 * 2e-2}
WARM_CALLS = 10


def warmed_ms(fn):
    """(ms, warm-up ms): WARM_CALLS calls each timed by CUDA events, then
    :func:`time_ms` (its own warm-up included)."""
    warm = []
    for _ in range(WARM_CALLS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        warm.append(a.elapsed_time(b))
    return time_ms(fn), warm


def flash_bwd_oracle(fa, q, k, v, o, lse, do, causal, scale, seg):
    """(dq, dk, dv) of the plain backward in f32 on the exactly widened
    operands, and per-element limits: FLASH_F32_TOL x (1 + the sum of the
    terms' magnitudes) for the f32 summation order; bf16 adds one rounding
    of ds (dq, dk) or of p (dv), 2^-8 of the terms' magnitudes, and one of
    the output, 2^-8 |ref| (each allowed twice); every limit capped at
    FLASH_BWD_CAP."""
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    ref = fa.flash_attention_bwd_plain(q32, k32, v32, o32, lse, do32, causal, scale, seg)
    b, h, t_len, _ = q.shape
    p = torch.exp(fa.masked_scores(q32, k32, causal, scale, seg) - lse.reshape(b, h, t_len, 1))
    ds = p * (do32 @ v32.transpose(-1, -2)
              - fa.row_dot(o32, do32).reshape(b, h, t_len, 1)) * scale
    terms = (ds.abs() @ k32.abs(), ds.abs().transpose(-1, -2) @ q32.abs(),
             p.transpose(-1, -2) @ do32.abs())
    del p, ds
    tols = []
    for r, m in zip(ref, terms):
        tol = FLASH_F32_TOL * (1 + m)
        if q.dtype == BF16:
            tol = tol + 2.0 ** -8 * m + 2.0 ** -8 * r.abs()
        tols.append(tol.clamp_max(FLASH_BWD_CAP[q.dtype]))
    return ref, tols


def flash_bwd_cost(kernel, b, h, t_len, hd, causal, dtype, segmented):
    """(FLOPs, bytes) of one call: dq 6 T^2 hd and dkv 8 T^2 hd FLOPs per
    head (the recomputed scores and dp, then one product per output), half
    of it causal; q, k, v, dO, lse and D read once, the outputs written
    once, segment ids read."""
    n_out = 1 if kernel == "dq" else 2
    flops = (6.0 if kernel == "dq" else 8.0) * t_len * t_len * hd * b * h
    flops *= 0.5 if causal else 1.0
    size = 2 if dtype == BF16 else 4
    nbytes = ((4 + n_out) * t_len * b * h * hd * size + 2 * 4 * t_len * b * h
              + (4 * b * t_len if segmented else 0))
    return bound(flops, nbytes, PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)


def flash_bwd_phase(fa):
    """Phase 2f: the flash-attention backward kernels against their plain
    version in f32 on the card at every case, two runs bit-identical, a lost
    causal mask over the limit; times at the train shapes beside the backward
    of F.scaled_dot_product_attention (the yardstick only)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    rows = []
    for n, (b, h, t_len, hd, causal, dtype, segmented) in enumerate(FLASH_BWD_CASES):
        q, k, v, do = (torch.randn(b, h, t_len, hd, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        seg = flash_segments(b, t_len) if segmented else None
        scale = hd ** -0.5
        row = {"b": b, "h": h, "T": t_len, "hd": hd, "causal": causal,
               "dtype": str(dtype).split(".")[-1], "segmented": segmented}
        with torch.inference_mode():
            fwd = fa.flash_attention_fwd if t_len % 128 == 0 else fa.flash_attention_plain
            o, lse = fwd(q, k, v, causal, scale, seg)
            dcap = fa.row_dot(o, do).contiguous()
            got = (fa.flash_attention_dq(q, k, v, lse, do, dcap, causal, scale, seg),
                   *fa.flash_attention_dkv(q, k, v, lse, do, dcap, causal, scale, seg))
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale, seg)
            torch.cuda.synchronize()
            ref, tols = flash_bwd_oracle(fa, q, k, v, o, lse, do, causal, scale, seg)
            lost = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse,
                                                do.float(), False, scale, seg) if causal else None
            for i, name in enumerate(("dq", "dk", "dv")):
                err = (got[i].float() - ref[i]).abs()
                row[f"{name}_max_abs_err"] = float(err.max())
                row[f"{name}_err_over_tol"] = float((err / tols[i]).max())
                row[f"{name}_max_tol"] = float(tols[i].max())
                if causal:
                    row[f"{name}_lost_mask_over_tol"] = float(((lost[i] - ref[i]).abs()
                                                               / tols[i]).max())
            row["bit_identical"] = all(torch.equal(x, y) for x, y in zip(got, again))
            row["finite"] = all(bool(torch.isfinite(x.float()).all()) for x in got)
            row["max_abs_err"] = max(row[f"{n_}_max_abs_err"] for n_ in ("dq", "dk", "dv"))
            del ref, tols, lost
        timing = ""
        if n < FLASH_BWD_TIMED:
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, scale=scale)
            lib_ms, lib_warm = warmed_ms(lambda: torch.autograd.grad(
                sdpa, (qr, kr, vr), do, retain_graph=True))
            del sdpa
            args = (q, k, v, lse, do, dcap, causal, scale)
            with torch.inference_mode():
                for kern, fn, plain in (
                        ("dq", lambda: fa.flash_attention_dq(*args),
                         lambda: fa.flash_attention_dq_plain(*args)),
                        ("dkv", lambda: fa.flash_attention_dkv(*args),
                         lambda: fa.flash_attention_dkv_plain(*args))):
                    ms, warm = warmed_ms(fn)
                    bms, by = flash_bwd_cost(kern, b, h, t_len, hd, causal, dtype, segmented)
                    row[kern] = {"kernel_ms": ms, "warmup_ms": warm, "plain_ms": time_ms(plain),
                                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                                 "library_warmup_ms": lib_warm,
                                 "kernel_device_ms": graph_ms(fn)}
                    timing += (f" {kern}: kernel_ms {ms:.4f} (warm-up calls "
                               f"{[round(w, 3) for w in warm[:3]]}...; device only, CUDA "
                               f"graph: {row[kern]['kernel_device_ms']:.4f}) plain_ms "
                               f"{row[kern]['plain_ms']:.4f} bound_ms {bms:.5f} ({by});")
            timing += f" library_ms {lib_ms:.4f} (SDPA's whole backward)"
        rows.append(row)
        over = max(row[f"{n_}_err_over_tol"] for n_ in ("dq", "dk", "dv"))
        lost_min = min((row[f"{n_}_lost_mask_over_tol"] for n_ in ("dq", "dk", "dv")),
                       default=2.0) if causal else 2.0
        ok = over <= 1 and row["finite"] and row["bit_identical"] and lost_min > 1
        print(f"phase 2f kernels flash_attention_dq/dkv b {b} h {h} T {t_len} hd {hd} "
              f"{'causal' if causal else 'full'}{' segments' if segmented else ''} "
              f"{row['dtype']}: max_abs_err dq {row['dq_max_abs_err']:.3g} dk "
              f"{row['dk_max_abs_err']:.3g} dv {row['dv_max_abs_err']:.3g} vs the plain version "
              f"in f32, err/tol {over:.3g} (largest limit "
              f"{max(row[f'{n_}_max_tol'] for n_ in ('dq', 'dk', 'dv')):.3g}, cap "
              f"{FLASH_BWD_CAP[dtype]}); bit-identical rerun {row['bit_identical']}"
              f"{f'; lost-mask diff/tol >= {lost_min:.3g}' if causal else ''};{timing} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with the plain version: {row}")
        del q, k, v, do, o, lse, dcap, got, again
    summary = {}
    for kern, op in (("dq", fa.OP_DQ), ("dkv", fa.OP_DKV)):
        head = rows[0][kern]
        summary[op] = {key: head[key] for key in ("kernel_ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")}
        summary[op]["max_abs_err"] = max(
            r[f"{n_}_max_abs_err"] for r in rows for n_ in ((kern,) if kern == "dq"
                                                           else ("dk", "dv")))
        summary[op]["by_shape"] = [{"b": r["b"], "T": r["T"], **{
            key: r[kern][key] for key in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "kernel_device_ms")}}
            for r in rows[:FLASH_BWD_TIMED]]
    print(f"phase 2f summary (headline: b 16, 12 heads, T 512, causal bf16): {summary}",
          flush=True)
    return rows, summary


# bench.py's TransformerLM train step (_bench_transformer): GPT-2 small's
# widths and depth, vocabulary 32,000, bf16, Adam(3e-4), batch 16 x T 512 and
# the long-context variant 4 x 2048
LM_TRAIN_CONF = dict(vocab_size=32000, d_model=768, n_heads=12, n_layers=12, max_length=512,
                     compute_dtype="bfloat16")
LM_TRAIN_LR = 3e-4
LM_TRAIN_BATCH, LM_LONG_BATCH = (16, 512), (4, 2048)
LM_TRAIN_STEPS = 10            # phase 9's main path: fit_batch steps on one batch
LM_PACKED_STEPS = 3
LM_TIMED_STEPS = 10
LM_WARM_STEPS = 3


def lm_batch(rng, b, t_len, vocab):
    """Seeded ids, targets = ids rolled by -1 with the last target -1
    (bench.py:274-276), on the card."""
    ids = rng.integers(0, vocab, (b, t_len))
    tgt = np.roll(ids, -1, axis=1)
    tgt[:, -1] = -1
    return torch.from_numpy(ids).cuda(), torch.from_numpy(tgt).cuda()


def packed_batch(ids, tgt):
    """Two documents per row, the cut at 201 + 37 (r mod 8) in row r (off the
    64-row tiles); the target before each cut is -1, so that no token
    predicts into the next document (tests/test_flash_kernel.py:218-233)."""
    b, t_len = ids.shape
    seg = torch.zeros(b, t_len, dtype=torch.int32, device=ids.device)
    tgt = tgt.clone()
    for r in range(b):
        cut = 201 + 37 * (r % 8)
        seg[r, cut:] = 1
        tgt[r, cut - 1] = -1
    return seg, tgt


def plain_flash(fa):
    """``seg -> attn_fn``: the flash function's plain forward and backward,
    differentiable, as ``forward``'s ``attn_fn`` (phase 9's plain path)."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, seg, causal, scale):
            o, lse = fa.flash_attention_plain(q, k, v, causal, scale, seg)
            ctx.save_for_backward(q, k, v, o, lse, seg)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, seg = ctx.saved_tensors
            return (*fa.flash_attention_bwd_plain(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                                                  seg), None, None, None)

    def attn_fn(seg=None):
        def fn(q, k, v, *, causal, mask=None):
            return PlainFlash.apply(q, k, v, seg, causal, q.shape[-1] ** -0.5)
        return fn

    return attn_fn


def lm_gradients(fa, tlm, model, ids, tgt, seg):
    """Phase 9 (a): one step's gradients, kernel path (``lm_loss``) against
    the plain path (``forward`` with the plain flash function) on the same
    params and batch, and the plain path in f32 as the bf16-noise yardstick;
    phase 4's rule per tensor."""
    cfg = model.cfg
    cfg32 = tlm.TransformerLMConfig.from_dict({**cfg.to_dict(), "compute_dtype": None})
    plain = plain_flash(fa)(seg)

    def plain_loss(c):
        return lambda p: tlm.token_nll(tlm.forward(c, p, ids, attn_fn=plain, cast_logits=False),
                                       tgt)[0]

    fa.reset_launch_counts()
    lk, gk = tlm.value_and_grad(lambda p: tlm.lm_loss(cfg, p, ids, tgt, segment_ids=seg),
                                model.params_)
    launches = dict(fa.launch_counts)
    fa.reset_launch_counts()
    lp, gp = tlm.value_and_grad(plain_loss(cfg), model.params_)
    l32, g32 = tlm.value_and_grad(plain_loss(cfg32), model.params_)
    plain_launches = sum(fa.launch_counts.values())
    ok, rels, ratios, to_f32 = grad_agreement(*(dict(_flat(g)) for g in (gk, gp, g32)))
    lk, lp, l32 = float(lk), float(lp), float(l32)
    loss_rel = abs(lk - lp) / abs(lp)
    return {"ok": ok and loss_rel <= 1e-3, "loss": lk, "plain_loss": lp, "f32_loss": l32, "loss_rel": loss_rel,
            "launches": launches, "plain_launches": plain_launches, "grad_rel_err": rels,
            "grad_err_over_bf16_noise": ratios, "grad_f32_distance_ratio": to_f32}


def lm_fit_steps(fa, model, ids, tgt, steps, seg=None):
    """``steps`` fit_batch calls, the counts read around each -> (losses,
    launches per step)."""
    losses, per_step = [], []
    for _ in range(steps):
        before = dict(fa.launch_counts)
        losses.append(model.fit_batch(ids, tgt, segment_ids=seg))
        per_step.append({k: fa.launch_counts[k] - before.get(k, 0) for k in fa.launch_counts
                         if fa.launch_counts[k] - before.get(k, 0)})
    return losses, per_step


def lm_step_speed(model, ids, tgt, timed):
    """Host seconds per ``_make_step`` call (bench.py's way of driving the
    step) over ``timed`` calls, synchronized once at the end, after
    LM_WARM_STEPS warm-up calls each timed alone; the peak memory of the
    timed window and the memory held when it began (GiB), and the last
    loss."""
    step = model._make_step()
    params, opt, t = model.params_, model.opt_state_, model.iteration
    warm = []
    for _ in range(LM_WARM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t += 1
        params, opt, loss = step(params, opt, ids, tgt, t)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        t += 1
        params, opt, loss = step(params, opt, ids, tgt, t)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return sec, warm, peak, held, float(loss)


def lm_train_phase(fa, card: str):
    """Phase 9: TransformerLM.fit_batch at bench.py's train config (GPT-2
    small's shape, 32,000 tokens, bf16, Adam(3e-4); seeded): gradients
    against the plain path, exact launch counts, falling losses (dense and
    packed), tokens/s at 16 x 512 and 4 x 2048, and logits after training
    against the uncached forward."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    from deeplearning4j_tpu_torch.updaters import Adam

    t0 = time.perf_counter()
    model = tlm.TransformerLM(seed=SEED, updater=Adam(LM_TRAIN_LR), **LM_TRAIN_CONF).init()
    init_s = time.perf_counter() - t0
    n_layers, V = model.cfg.n_layers, model.cfg.vocab_size
    want_step = {fa.OP: n_layers, fa.OP_DQ: n_layers, fa.OP_DKV: n_layers}
    rng = np.random.default_rng(SEED + 71)
    ids, tgt = lm_batch(rng, *LM_TRAIN_BATCH, V)
    seg, tgt_p = packed_batch(ids, tgt)

    # (a) gradients of one step, dense and packed
    grads = {"dense": lm_gradients(fa, tlm, model, ids, tgt, None),
             "packed": lm_gradients(fa, tlm, model, ids, tgt_p, seg)}
    for kind, g in grads.items():
        print(f"phase 9 gradients ({kind}{', two documents per row' if kind == 'packed' else ''})"
              f": TransformerLM {LM_TRAIN_CONF}, {model.num_params():,} params, batch "
              f"{LM_TRAIN_BATCH}, init {init_s:.1f}s; over {len(g['grad_rel_err'])} tensors "
              f"(k kernel path, p plain path, f32 plain path in f32): ||g_k - g_p|| / ||g_p|| "
              f"{_quantiles(g['grad_rel_err'])}; ||g_k - g_p|| / ||g_p - g_f32|| "
              f"{_quantiles(g['grad_err_over_bf16_noise'])} (each <= {GRAD_NOISE_FACTOR} where "
              f"the first > {GRAD_REL_TOL}); ||g_k - g_f32|| / ||g_p - g_f32|| "
              f"{_quantiles(g['grad_f32_distance_ratio'])} (median <= {GRAD_F32_MEDIAN}); loss "
              f"{g['loss']:.6g} vs plain {g['plain_loss']:.6g} (rel {g['loss_rel']:.3g}, tol "
              f"1e-3), f32 {g['f32_loss']:.6g}; launches {g['launches']}, plain path "
              f"{g['plain_launches']} {'ok' if g['ok'] else 'FAIL'}", flush=True)

    # (b, c) the main path: LM_TRAIN_STEPS fit_batch steps, counts from 0
    # just before and read just after; the cache filled before training
    before = model.logits(ids[:2].cpu().numpy())
    fa.reset_launch_counts()
    losses, per_step = lm_fit_steps(fa, model, ids, tgt, LM_TRAIN_STEPS)
    main_launches = dict(fa.launch_counts)
    fa.reset_launch_counts()
    p_losses, p_per_step = lm_fit_steps(fa, model, ids, tgt_p, LM_PACKED_STEPS, seg)
    print(f"phase 9 steps: {LM_TRAIN_STEPS} fit_batch steps, Adam({LM_TRAIN_LR}); losses "
          f"{[round(x, 5) for x in losses]}; launches per step {per_step[0]} (expected "
          f"{want_step}); main-path launches {main_launches}; then {LM_PACKED_STEPS} packed "
          f"steps: losses {[round(x, 5) for x in p_losses]}, launches per step {p_per_step[0]}",
          flush=True)

    # (g) after training: logits through compute_params' cache == the
    # uncached forward, and not the cast of the params before training
    after = model.logits(ids[:2].cpu().numpy())
    with torch.inference_mode():
        fresh = tlm.forward(model.cfg, tlm.compute_params(model.cfg, model.params_),
                            ids[:2]).cpu().numpy()
    d_fresh = float(np.abs(after - fresh).max())
    d_before = float(np.abs(after - before).max())
    print(f"phase 9 cache: logits after training vs the uncached forward max|d| {d_fresh:.4g} "
          f"(limit {PREFILL_LIMIT_KERNEL}); vs the logits before training {d_before:.4g}",
          flush=True)

    # (d) speed at 16 x 512
    tokens = LM_TRAIN_BATCH[0] * LM_TRAIN_BATCH[1]
    sec, warm, peak, held, last = lm_step_speed(model, ids, tgt, LM_TIMED_STEPS)
    print(f"phase 9 speed: {tokens / sec:.1f} train tokens/s at batch {LM_TRAIN_BATCH} "
          f"({sec * 1e3:.2f} ms per _make_step call, host clock, {LM_TIMED_STEPS} calls "
          f"synchronized at the end, after {LM_WARM_STEPS} warm-up calls of "
          f"{[round(w, 1) for w in warm]} ms); peak memory {peak:.2f} GiB, of it "
          f"{held:.2f} GiB held when the window began (this phase's model and earlier "
          f"phases' engines); last loss {last:.5g}; on {card}", flush=True)
    finite = all(bool(torch.isfinite(p).all()) for _, p in _flat(model.params_))
    del model, before, after, fresh
    torch.cuda.empty_cache()

    # (e) long context: 4 x 2048
    long_model = tlm.TransformerLM(seed=SEED, updater=Adam(LM_TRAIN_LR),
                                   **{**LM_TRAIN_CONF, "max_length": LM_LONG_BATCH[1]}).init()
    ids_l, tgt_l = lm_batch(rng, *LM_LONG_BATCH, V)
    fa.reset_launch_counts()
    l_losses, l_per_step = lm_fit_steps(fa, long_model, ids_l, tgt_l, LM_PACKED_STEPS)
    l_sec, l_warm, l_peak, l_held, _ = lm_step_speed(long_model, ids_l, tgt_l,
                                                     LM_TIMED_STEPS // 2)
    l_tokens = LM_LONG_BATCH[0] * LM_LONG_BATCH[1]
    print(f"phase 9 long context: batch {LM_LONG_BATCH}, {LM_PACKED_STEPS} fit_batch steps: "
          f"losses {[round(x, 5) for x in l_losses]}, launches per step {l_per_step[0]}; "
          f"{l_tokens / l_sec:.1f} train tokens/s ({l_sec * 1e3:.2f} ms per _make_step call, "
          f"warm-up {[round(w, 1) for w in l_warm]} ms); peak memory {l_peak:.2f} GiB, "
          f"{l_held:.2f} GiB held",
          flush=True)
    del long_model
    torch.cuda.empty_cache()

    failed = [f"{kind} gradients disagree with the plain path"
              for kind, g in grads.items() if not g["ok"]]
    failed += [f"{kind} gradient launches {g['launches']}, plain {g['plain_launches']}"
               for kind, g in grads.items()
               if g["launches"] != want_step or g["plain_launches"]]
    for name, ls, steps in (("dense", losses, per_step), ("packed", p_losses, p_per_step),
                            ("long-context", l_losses, l_per_step)):
        if any(s != want_step for s in steps):
            failed.append(f"{name}: a step launched {steps}, expected {want_step}")
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            failed.append(f"{name}: losses {ls} not finite or not falling")
    if not finite:
        failed.append("params not finite after training")
    if not d_fresh <= PREFILL_LIMIT_KERNEL or not d_before > 4 * PREFILL_LIMIT_KERNEL:
        failed.append(f"logits after training: {d_fresh} from the uncached forward, "
                      f"{d_before} from those before training")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"conf": LM_TRAIN_CONF, "lr": LM_TRAIN_LR, "batch": LM_TRAIN_BATCH,
            "init_s": init_s, "gradients": grads, "losses": losses,
            "launches_per_step": per_step[0], "main_launches": main_launches,
            "packed_losses": p_losses, "packed_launches_per_step": p_per_step[0],
            "logits_vs_uncached_max_abs": d_fresh, "logits_moved_max_abs": d_before,
            "tokens_per_s": tokens / sec, "ms_per_step": sec * 1e3, "warmup_ms": warm,
            "peak_mem_gib": peak, "held_mem_gib": held,
            "long": {"batch": LM_LONG_BATCH, "losses": l_losses,
                     "launches_per_step": l_per_step[0], "tokens_per_s": l_tokens / l_sec,
                     "ms_per_step": l_sec * 1e3, "warmup_ms": l_warm, "peak_mem_gib": l_peak,
                     "held_mem_gib": l_held}}


# phase 2g: the fused Adam at the sizes of the sharded update's flat groups:
# ResNet-50's (from its layout), VGG16's 138,357,544 parameters, ragged ones
VGG16_PARAMS = 138_357_544
ADAM_RAGGED = [1, 3, 4095, 4097, 1_000_003]
ADAM_STEPS = [1, 2, 1000]
ADAM_LR = 1e-4                # phase 10: Adam(ADAM_LR) on ResNet-50 and LeNet
ADAM_BYTES_PER_ELEM = 28      # reads p, g, m, v; writes p', m', v' (f32)
ZERO1_STEPS = 5               # phase 10's main path: sharded fit steps on one batch
LENET_STEPS = 3


def adam_inputs(n, seed):
    """Seeded f32 (p, g, m, v) on the card; v non-negative."""
    g = torch.Generator().manual_seed(seed)
    p, grad, m = (torch.randn(n, generator=g).cuda() for _ in range(3))
    v = torch.randn(n, generator=g).abs().cuda() * 1e-4
    return p, grad, m * 1e-2, v


def resnet50_adam_groups():
    """The element counts of the flat groups of a one-rank sharded update
    of the full-width ResNet-50 under Adam(ADAM_LR)."""
    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.updaters import Adam

    model, _ = resnet50(updater=Adam(ADAM_LR))
    sizes = [g.total for g in zero.build_layout(model, 1).groups]
    del model
    torch.cuda.empty_cache()
    return sizes


def library_adam(p, grad, m, v, alpha_step):
    """``torch._fused_adam_`` over the one flat tensor (in place): a timing
    yardstick only (its eps sits inside the bias correction, so it is not
    DL4J's Adam), never called by the port. None where torch lacks it."""
    fn = getattr(torch, "_fused_adam_", None)
    if fn is None:
        return None
    step = torch.tensor([float(alpha_step)], device=p.device)
    return lambda: fn([p], [grad], [m], [v], [], [step], lr=ADAM_LR, beta1=0.9,
                      beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                      maximize=False)


def adam_phase(fu):
    """Phase 2g: the fused Adam kernel against its plain version (the eager
    ``Adam.apply`` composition) on the card: torch.equal on p', m', v' at
    every size and step, the zero padding lanes of a group padded to 4
    shards, two runs bit-identical; times at ResNet-50's group size."""
    from deeplearning4j_tpu_torch.updaters import Adam

    upd = Adam(ADAM_LR)
    groups = resnet50_adam_groups()
    sizes = groups + [VGG16_PARAMS] + ADAM_RAGGED
    rows, failed = [], []
    for n in sizes:
        p, grad, m, v = adam_inputs(n, SEED + n % 9973)
        for t in ADAM_STEPS:
            alpha = upd.alpha(t, t - 1, 0)
            got = fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
            want = fu.fused_adam_plain(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
            again = fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            rerun = all(torch.equal(a, b) for a, b in zip(got, again))
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            rows.append({"n": n, "t": t, "equal": equal, "rerun_identical": rerun,
                         "max_abs_err": err})
            if not (equal and rerun):
                failed.append((n, t, err, rerun))
            del got, want, again
        del p, grad, m, v
    # a group of 1,000,003 elements padded to 4 shards of 250,001: one zero lane
    n = ADAM_RAGGED[-1]
    padded = [torch.cat([a, a.new_zeros((-n) % 4)]).view(4, -1) for a in adam_inputs(n, SEED)]
    lanes = [a.reshape(-1)[n:] for a in fu.fused_adam_apply(
        *padded, upd.alpha(3, 2, 0), b1=0.9, b2=0.999, eps=1e-8)]
    lanes_zero = all(bool((a == 0).all()) for a in lanes) and lanes[0].numel() == 1
    # times at ResNet-50's group size
    n = groups[0]
    p, grad, m, v = adam_inputs(n, SEED)
    alpha = upd.alpha(2, 1, 0)
    kernel_ms = time_ms(lambda: fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9, b2=0.999,
                                                    eps=1e-8))
    plain_ms = time_ms(lambda: fu.fused_adam_plain(p, grad, m, v, alpha, b1=0.9, b2=0.999,
                                                   eps=1e-8))
    lib = library_adam(p.clone(), grad, m.clone(), v.clone(), 2)
    library_ms = None if lib is None else time_ms(lib)
    bound_ms, bound_by = bound(0.0, ADAM_BYTES_PER_ELEM * n)
    vgg_kernel_ms = None
    del p, grad, m, v
    p, grad, m, v = adam_inputs(VGG16_PARAMS, SEED)
    vgg_kernel_ms = time_ms(lambda: fu.fused_adam_apply(p, grad, m, v, alpha, b1=0.9,
                                                        b2=0.999, eps=1e-8))
    vgg_bound_ms = bound(0.0, ADAM_BYTES_PER_ELEM * VGG16_PARAMS)[0]
    del p, grad, m, v
    torch.cuda.empty_cache()
    print(f"phase 2g fused_adam: {len(rows)} cases (sizes {sizes}, t {ADAM_STEPS}) "
          f"torch.equal to the plain version on p, m, v: "
          f"{sum(r['equal'] for r in rows)}/{len(rows)}, reruns bit-identical "
          f"{sum(r['rerun_identical'] for r in rows)}/{len(rows)}; padding lane of a "
          f"4-shard group stays 0: {lanes_zero}; at ResNet-50's {n:,} elements: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch._fused_adam_ "
          f"{library_ms if library_ms is None else round(library_ms, 4)} ms (yardstick "
          f"only: not DL4J's eps), bound {bound_ms:.4f} ms ({bound_by}, "
          f"{ADAM_BYTES_PER_ELEM} B/element); VGG16's {VGG16_PARAMS:,}: kernel "
          f"{vgg_kernel_ms:.4f} ms, bound {vgg_bound_ms:.4f} ms", flush=True)
    if failed or not lanes_zero:
        raise AssertionError(f"fused_adam disagrees with its plain version: {failed}, "
                             f"padding lanes zero {lanes_zero}")
    return rows, {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
                  "elements": n, "vgg16": {"elements": VGG16_PARAMS,
                                           "kernel_ms": vgg_kernel_ms,
                                           "bound_ms": vgg_bound_ms}}


# phase 2h: the shared-training encoder at the real models' flat sizes
ENCODE_SIZES = {"ResNet-50": 25_557_032, "VGG16": VGG16_PARAMS}
ENCODE_CAPACITY = 16384
ENCODE_THRESHOLD = 1e-3


def plain_encode(flat, threshold, capacity):
    """The threshold encode written another way than the port's stable sort
    of every score: the k-th score from ``torch.topk``, every element above
    it and the lowest-index elements equal to it (a cumsum), the kept ones
    by index (``nonzero``, a host sync) in a stable sort by score.
    -> ((indices, values, count), residual)."""
    mag = flat.abs()
    score = torch.where(mag >= threshold, mag, torch.full_like(mag, -1.0))
    kth = torch.topk(score, capacity).values[-1]
    above, equal = score > kth, score == kth
    keep = above | (equal & (torch.cumsum(equal, 0) <= capacity - above.sum()))
    kept = torch.nonzero(keep).reshape(-1)
    vals, order = torch.sort(score[kept], descending=True, stable=True)
    idx = kept[order]
    valid = vals > 0
    send = torch.where(valid, torch.sign(flat[idx]) * threshold, torch.zeros_like(vals))
    residual = flat.clone()
    residual[idx] = flat[idx] - send
    return (torch.where(valid, idx, -1).to(torch.int32), send,
            valid.sum().to(torch.int32)), residual


def plain_decode(indices, values, n):
    """Messages ``indices``/``values`` (ranks, K) added into a dense (n,)
    vector rank by rank."""
    out = torch.zeros(n, dtype=torch.float32, device=values.device)
    for idx, val in zip(indices, values):
        keep = idx >= 0
        out[idx[keep].long()] += val[keep]
    return out


def encoder_phase():
    """Phase 2h: ``parallel/compression.py``'s encode and decode at
    ResNet-50's and VGG16's flat gradient sizes (capacity 16384, threshold
    1e-3, seeded N(0, 1e-3) gradients): message, residual and decode
    torch.equal to the plain versions (another selection: top-k, the ties
    filled by index), reruns bit-identical; device times beside
    ``torch.topk`` alone. Plain torch, not a kernel port: no row of
    the kernels' table."""
    from deeplearning4j_tpu_torch.parallel import compression as pc

    out, failed = {}, []
    for name, n in ENCODE_SIZES.items():
        g = torch.Generator(device="cuda").manual_seed(SEED + n % 9973)
        grad = torch.randn(n, generator=g, device="cuda") * 1e-3
        thr = torch.full((), ENCODE_THRESHOLD, dtype=torch.float32, device="cuda")
        msg, res = pc.threshold_encode(grad, thr, ENCODE_CAPACITY)
        again, res2 = pc.threshold_encode(grad, thr, ENCODE_CAPACITY)
        (p_idx, p_val, p_count), p_res = plain_encode(grad, thr, ENCODE_CAPACITY)
        dec = pc.threshold_decode(msg, n)
        p_dec = plain_decode(p_idx[None], p_val[None], n)
        torch.cuda.synchronize()
        equal = {"indices": torch.equal(msg.indices, p_idx),
                 "values": torch.equal(msg.values, p_val),
                 "count": torch.equal(msg.count, p_count),
                 "residual": torch.equal(res, p_res), "decode": torch.equal(dec, p_dec)}
        rerun = all(torch.equal(a, b) for a, b in zip(msg, again)) and torch.equal(res, res2)
        del again, res2, p_res, p_dec
        encode_ms = graph_ms(lambda: pc.threshold_encode(grad, thr, ENCODE_CAPACITY),
                             calls=5, replays=4)
        decode_ms = graph_ms(lambda: pc.threshold_decode(msg, n), calls=5, replays=4)
        topk_ms = graph_ms(lambda: torch.topk(grad.abs(), ENCODE_CAPACITY), calls=5,
                           replays=4)
        plain_ms = time_ms(lambda: plain_encode(grad, thr, ENCODE_CAPACITY))
        out[name] = {"n": n, "equal": equal, "rerun_identical": rerun,
                     "count": int(msg.count), "encode_graph_ms": encode_ms,
                     "decode_graph_ms": decode_ms, "topk_graph_ms": topk_ms,
                     "plain_encode_ms": plain_ms}
        print(f"phase 2h encoder {name} {n:,} elements, capacity {ENCODE_CAPACITY}, threshold "
              f"{ENCODE_THRESHOLD}: {int(msg.count)} sent; vs the plain version (topk, ties "
              f"filled by index) torch.equal {equal}; reruns bit-identical {rerun}; device ms (CUDA "
              f"graph): encode {encode_ms:.4f}, decode {decode_ms:.4f}, torch.topk of |g| "
              f"alone {topk_ms:.4f}; plain encode {plain_ms:.4f} ms (events)", flush=True)
        if not (all(equal.values()) and rerun):
            failed.append((name, equal, rerun))
        del grad, msg, res, dec
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the encoder disagrees with its plain version: {failed}")
    return out


class RecordingIterator:
    """Iterates ``batches``, calling ``before(i)`` ahead of handing out
    batch i (a train step follows each): where a step's launches are read,
    and where a checkpoint is written in the middle of a fit."""

    def __init__(self, batches, before):
        from deeplearning4j_tpu_torch.data import ExistingDataSetIterator

        self.inner = ExistingDataSetIterator(batches)
        self.before, self.i = before, 0

    def __iter__(self):
        for ds in self.inner:
            self.before(self.i)
            self.i += 1
            yield ds

    def reset(self):
        self.inner.reset()
        self.i = 0


def _opt_tensors(opt):
    """(name, tensor) for every slot of a graph's or a list network's
    updater state."""
    groups = opt.items() if isinstance(opt, dict) else enumerate(opt)
    for key, o in groups:
        for pn in sorted(o):
            for slot in sorted(o[pn]):
                yield f"{key}/{pn}/{slot}", o[pn][slot]


def zero1_phase(fc, fu, card: str, train: dict):
    """Phase 10: ResNet-50 (and LeNet) through ParallelWrapper with the
    ZeRO-1 sharded update on a one-rank NCCL group."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import LeNet
    from deeplearning4j_tpu_torch.nn.graph import _as_multi
    from deeplearning4j_tpu_torch.nn.multilayer import apply_layer_updates
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh, zero
    from deeplearning4j_tpu_torch.train.model_serializer import ModelSerializer
    from deeplearning4j_tpu_torch.updaters import Adam

    failed = []
    mesh = TrainingMesh(workers=1, device="cuda")
    model, _ = resnet50(updater=Adam(ADAM_LR))
    rng = np.random.default_rng(SEED + 10)
    x = rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)]
    ds = DataSet(x, y)
    names = model.layer_names
    layers = [model._layer(nm) for nm in names]

    # (a) one update, bitwise: the sharded update with the kernel against
    # the per-layer eager Adam.apply, from the same params, gradients, slots
    _, _, grads = model._value_and_grad(*model._batch(_as_multi(ds)))
    g = torch.Generator().manual_seed(SEED)
    opt = {nm: {pn: {"m": (torch.randn(t.shape, generator=g) * 1e-3).cuda(),
                     "v": (torch.rand(t.shape, generator=g) * 1e-6).cuda()}
                for pn, t in model.params_[nm].items()} for nm in names}
    p_list, g_list = [model.params_[nm] for nm in names], [grads[nm] for nm in names]
    o_list = [opt[nm] for nm in names]
    ref_p, ref_o = apply_layer_updates(layers, p_list, g_list, o_list, 3, 2, 0)
    layout = zero.build_layout(model, mesh.n_data)
    impls = fu.resolve_group_impls(layout)
    n_groups = sum(i is not None for i in impls)
    fc.reset_launch_counts()
    got_p, zopt = zero.apply_sharded_updates(layout, p_list, g_list,
                                             layout.shard_opt_state(o_list, mesh), 3, 2, 0,
                                             mesh=mesh, fused_impls=impls)
    one_update = fc.launch_counts.get("fused_adam", 0)
    got_o = layout.unshard_opt_state(zopt, o_list, mesh)
    torch.cuda.synchronize()
    unequal = [f"{nm}/{k}" for nm, a, b in zip(names, got_p, ref_p) for k in b
               if not torch.equal(a[k], b[k])]
    unequal += [f"{nm}/{k}/{s}" for nm, a, b in zip(names, got_o, ref_o) for k in b
                for s in b[k] if not torch.equal(a[k][s], b[k][s])]
    n_tensors = sum(len(b) for b in ref_p) + sum(len(b[k]) for b in ref_o for k in b)
    print(f"phase 10 one update: ResNet-50 1000 classes 224x224 bf16 fused, Adam({ADAM_LR}), "
          f"{mesh}; layout: {len(layout.groups)} groups, {n_groups} f32 Adam groups (G) of "
          f"{[grp.total for grp in layout.groups]} elements; sharded update with the kernel "
          f"({one_update} fused_adam launches) vs per-layer eager Adam.apply: "
          f"{n_tensors - len(unequal)}/{n_tensors} params and slots torch.equal", flush=True)
    if unequal or one_update != n_groups or n_groups < 1:
        failed.append(f"one update: {len(unequal)} tensors differ ({unequal[:5]}), "
                      f"{one_update} launches for {n_groups} groups")
    del grads, opt, p_list, g_list, o_list, ref_p, ref_o, got_p, got_o, zopt

    # (b) the main path: sharded fit steps through the wrapper; counts from 0
    # just before, read just after; each step's launches read as the next
    # batch is handed out
    pw = ParallelWrapper.builder(model).workers(1).sharded_update(True).build()
    marks = []
    fc.reset_launch_counts()
    it = RecordingIterator([ds] * ZERO1_STEPS, lambda i: marks.append(
        (dict(fc.launch_counts), None if model.score_ is None else float(model.score_))))
    pw.fit(it)
    torch.cuda.synchronize()
    main_launches = dict(fc.launch_counts)
    marks.append((main_launches, float(model.score_)))
    per_step = [{k: b[0].get(k, 0) - a[0].get(k, 0) for k in b[0]}
                for a, b in zip(marks, marks[1:])]
    scores = [s for _, s in marks[1:]]
    want_step = dict(STEP_LAUNCHES, fused_adam=n_groups)
    canonical = (isinstance(model.opt_state_, dict) and list(model.opt_state_) == names
                 and all(model.opt_state_[nm][pn][s].shape == model.params_[nm][pn].shape
                         for nm in names for pn in model.params_[nm] for s in ("m", "v")))
    print(f"phase 10 steps: {ZERO1_STEPS} ParallelWrapper(workers=1, sharded_update) fit "
          f"steps, Adam({ADAM_LR}); scores {[round(s, 5) for s in scores]}; launches per "
          f"step {per_step[0]}; main-path launches {main_launches}; opt_state_ back in the "
          f"per-layer layout: {canonical}", flush=True)
    if any(s != want_step for s in per_step):
        failed.append(f"a sharded step launched {per_step}, expected {want_step}")
    if not (_finite(model) and all(math.isfinite(s) for s in scores) and scores[-1] < scores[0]):
        failed.append(f"sharded fit: not finite, or score {scores[-1]} not below {scores[0]}")
    if not canonical:
        failed.append("opt_state_ not gathered back to the per-layer layout")

    # (c) checkpoint round trip: a zip written in the middle of a sharded fit
    # (through _opt_state_sync) restores with its updater state and resumes;
    # its next step equals the uninterrupted run's, bit for bit under
    # deterministic cuDNN
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    at = model.iteration + 1
    t0 = time.perf_counter()
    # the zip (~270 MiB) lives in a directory of the checkout that is removed
    # at once
    with tempfile.TemporaryDirectory(dir=os.getcwd(), prefix=".phase10-") as tmp:
        path = os.path.join(tmp, "midfit.zip")

        def write_at(i):
            if model.iteration == at:
                ModelSerializer.write_model(model, path)

        pw.fit(RecordingIterator([ds] * 2, write_at))
        uninterrupted = (model.params_flat(), model.opt_state_flat(), float(model.score_))
        zip_mib = os.path.getsize(path) / 2 ** 20
        resumed = ModelSerializer.restore_computation_graph(path)
    restored_it = resumed.iteration
    ParallelWrapper.builder(resumed).workers(1).sharded_update(True).build().fit(
        ExistingDataSetIterator([ds]))
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    p_equal = np.array_equal(resumed.params_flat(), uninterrupted[0])
    o_equal = np.array_equal(resumed.opt_state_flat(), uninterrupted[1])
    p_err = float(np.abs(resumed.params_flat() - uninterrupted[0]).max())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    print(f"phase 10 checkpoint: zip written mid-fit at iteration {at} "
          f"({zip_mib:.1f} MiB, with updaterState.bin), restored at "
          f"iteration {restored_it}, one resumed step vs the uninterrupted run (deterministic "
          f"cuDNN): params equal {p_equal} (max|dp| {p_err:.3g}), slots equal {o_equal}, "
          f"score {float(resumed.score_):.6g} vs {uninterrupted[2]:.6g}; {ckpt_s:.1f}s",
          flush=True)
    if not (p_equal and o_equal and restored_it == at):
        failed.append("checkpoint: the resumed step differs from the uninterrupted run")
    del resumed

    # (d) speed, after the warm-up above: one fit over TIMED_STEPS batches
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pw.fit(ExistingDataSetIterator([ds] * TIMED_STEPS))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 10 speed: {BATCH / step_s:.1f} train images/s at batch {BATCH} "
          f"({step_s * 1e3:.2f} ms per step, host clock, synchronized, {TIMED_STEPS} steps in "
          f"one fit incl. its re-shard and gather), peak memory {peak_gib:.2f} GiB (held when "
          f"the window began {held_gib:.2f} GiB); phase 4 "
          f"(ComputationGraph.fit, Nesterovs) {train['images_per_s']:.1f} images/s; on {card}",
          flush=True)
    del model, pw
    torch.cuda.empty_cache()

    # (e) LeNet: MultiLayerNetwork.fit, and the wrapper replicated and sharded
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    rng = np.random.default_rng(SEED + 11)
    lx = rng.standard_normal((64, 28, 28, 1)).astype(np.float32)
    ly = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    lds = DataSet(lx, ly)
    nets, lenet_launch = [], []
    for how in ("fit", "replicated", "sharded"):
        net = LeNet(num_classes=10, seed=SEED, updater=Adam(ADAM_LR)).init()
        fc.reset_launch_counts()
        if how == "fit":
            net.fit(ExistingDataSetIterator([lds] * LENET_STEPS))
        else:
            ParallelWrapper.builder(net).workers(1).sharded_update(how == "sharded").build() \
                .fit(ExistingDataSetIterator([lds] * LENET_STEPS))
        torch.cuda.synchronize()
        lenet_launch.append(fc.launch_counts.get("fused_adam", 0))
        nets.append(net)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    lenet_groups = sum(i is not None for i in fu.resolve_group_impls(
        zero.build_layout(nets[2], 1)))
    same = [np.array_equal(nets[0].params_flat(), n.params_flat())
            and np.array_equal(nets[0].opt_state_flat(), n.opt_state_flat()) for n in nets[1:]]
    lenet_scores = [n.score() for n in nets]
    print(f"phase 10 LeNet: {LENET_STEPS} steps of batch 64, Adam({ADAM_LR}), deterministic "
          f"cuDNN; fused_adam launches fit/replicated/sharded {lenet_launch} (G {lenet_groups}); "
          f"replicated == fit {same[0]}, sharded == fit {same[1]} (params and slots); "
          f"scores {[round(s, 5) for s in lenet_scores]}", flush=True)
    if lenet_launch != [0, 0, LENET_STEPS * lenet_groups] or not all(same):
        failed.append(f"LeNet: launches {lenet_launch}, equal {same}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"main_launches": main_launches, "launches_per_step": per_step[0],
            "groups": [grp.total for grp in layout.groups], "fused_groups": n_groups,
            "scores": scores, "lr": ADAM_LR, "one_update_equal": not unequal,
            "checkpoint": {"params_equal": p_equal, "slots_equal": o_equal,
                           "seconds": ckpt_s},
            "images_per_s": BATCH / step_s, "ms_per_step": step_s * 1e3,
            "peak_mem_gib": peak_gib, "held_gib": held_gib,
            "phase4_images_per_s": train["images_per_s"],
            "lenet": {"launches": lenet_launch, "groups": lenet_groups, "equal": same,
                      "scores": lenet_scores}}


ZERO1_BUNDLE_K = 2            # phase 10b: the ZeRO-1 wrapper at steps_per_call=2
ZERO1_BUNDLE_BATCHES = 4
#: phase 10b's statistics-collective net: rows, image side, channels, width, classes
STATS_NET = (16, 16, 32, 16, 10)
LENET_BUNDLE_K = 4            # phase 10b: LeNet MultiLayerNetwork.fit at steps_per_call=4
LENET_BUNDLE_BATCHES = 8


def bundled_zero1_phase(fc, fu, card: str, zero1: dict):
    """Phase 10b: phase 10's ResNet-50 (Adam(ADAM_LR)) through
    ``ParallelWrapper(workers=1, sharded_update=True)`` at ``steps_per_call``
    ZERO1_BUNDLE_K against the same wrapper at 1, and LeNet's
    ``MultiLayerNetwork.fit`` at LENET_BUNDLE_K against 1, under
    deterministic cuDNN."""
    return _deterministic_cudnn(lambda: _bundled_zero1(fc, fu, card, zero1))


def _bundled_zero1(fc, fu, card, zero1):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import LeNet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, zero
    from deeplearning4j_tpu_torch.updaters import Adam

    k = ZERO1_BUNDLE_K
    single, _ = resnet50(updater=Adam(ADAM_LR))
    bundled, _ = resnet50(updater=Adam(ADAM_LR))
    n_groups = sum(i is not None for i in fu.resolve_group_impls(zero.build_layout(bundled, 1)))
    rng = np.random.default_rng(SEED + 12)
    batches = [DataSet(rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32),
                       np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)])
               for _ in range(ZERO1_BUNDLE_BATCHES)]
    p1 = ParallelWrapper.builder(single).workers(1).sharded_update(True).build()
    pk = ParallelWrapper.builder(bundled).workers(1).sharded_update(True).steps_per_call(k) \
        .build()
    marks = []
    p1.fit(RecordingIterator(batches, lambda i: marks.append(single.score_)))
    single_scores = [float(v) for v in marks[1:] + [single.score_]]

    # the main path: counts from 0 just before, read just after
    seen = []
    fc.reset_launch_counts()
    pk.fit(RecordingIterator(batches, lambda i: seen.append(bundled.bundle_scores_)))
    torch.cuda.synchronize()
    main_launches = dict(fc.launch_counts)
    captured = dict(pk._bstep._runner.captured_launches)
    scores = _bundle_scores(bundled, seen)
    equal = _states_equal(single, bundled)
    want_capture = dict({n: k * v for n, v in STEP_LAUNCHES.items()}, fused_adam=k * n_groups)
    print(f"phase 10b bundled ZeRO-1: ResNet-50 (phase 10's model), Adam({ADAM_LR}), "
          f"ParallelWrapper(workers=1, sharded_update) at steps_per_call={k}, "
          f"{ZERO1_BUNDLE_BATCHES} batches (deterministic cuDNN): vs the same wrapper at 1 "
          f"torch.equal {equal}; scores equal {scores == single_scores}; launches captured "
          f"{captured} (want {want_capture}); main-path launches {main_launches}",
          flush=True)
    fc.reset_launch_counts()
    trace, busy_ms = trace_kernels(lambda: pk.fit(ExistingDataSetIterator(batches[:k])))
    replay_launches = sum(fc.launch_counts.values())
    print(f"phase 10b trace of one replay: kernels by name {trace} (want "
          f"{trace_want(captured)}: fused_adam_kernel {k} x G {n_groups}), device busy "
          f"{busy_ms:.3f} ms for {k} steps; wrapper launches during the replay "
          f"{replay_launches}", flush=True)
    timed_batches = batches * (TIMED_STEPS // ZERO1_BUNDLE_BATCHES) \
        + batches[:TIMED_STEPS % ZERO1_BUNDLE_BATCHES]
    timed = _in_turns([
        ("single", lambda: p1.fit(ExistingDataSetIterator(timed_batches))),
        ("bundled", lambda: pk.fit(ExistingDataSetIterator(timed_batches)))])
    speed = {label: {"images_per_s": [BATCH * len(timed_batches) / t for t in r["s"]],
                     "ms_per_step": [t * 1e3 / len(timed_batches) for t in r["s"]],
                     "peak_gib": r["peak_gib"], "peak_reserved_gib": r["peak_reserved_gib"]}
             for label, r in timed.items()}
    fmt = lambda v: [round(x, 2) for x in v]  # noqa: E731
    print(f"phase 10b speed (in turns: k 1, k {k}, k {k}, k 1; one fit of "
          f"{len(timed_batches)} batches incl. its re-shard and gather, host clock, "
          f"synchronized): k 1 {fmt(speed['single']['images_per_s'])} images/s, k {k} "
          f"{fmt(speed['bundled']['images_per_s'])} images/s; peak allocated GiB "
          f"{fmt(speed['single']['peak_gib'])} / {fmt(speed['bundled']['peak_gib'])}, "
          f"reserved {fmt(speed['single']['peak_reserved_gib'])} / "
          f"{fmt(speed['bundled']['peak_reserved_gib'])} (both models held); phase 10 "
          f"{zero1['images_per_s']:.1f} images/s; on {card}", flush=True)
    failed = []
    if not all(equal.values()) or scores != single_scores:
        failed.append(f"ZeRO-1 bundles differ from single steps: {equal}, scores {scores} "
                      f"vs {single_scores}")
    if captured != want_capture or trace != trace_want(captured) or replay_launches:
        failed.append(f"ZeRO-1 bundle: captured {captured} (want {want_capture}), trace "
                      f"{trace}, eager launches in the replay {replay_launches}")
    del single, bundled, p1, pk
    torch.cuda.empty_cache()
    stats = _bundled_stats_collectives(fc, failed)

    # LeNet: MultiLayerNetwork.fit at LENET_BUNDLE_K against 1
    rng = np.random.default_rng(SEED + 13)
    lbatches = [DataSet(rng.standard_normal((64, 28, 28, 1)).astype(np.float32),
                        np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
                for _ in range(LENET_BUNDLE_BATCHES)]
    a = LeNet(num_classes=10, seed=SEED, updater=Adam(ADAM_LR)).init()
    b = LeNet(num_classes=10, seed=SEED, updater=Adam(ADAM_LR)).init()
    b.conf.global_conf.steps_per_call = LENET_BUNDLE_K
    lenet_single = []
    for ds in lbatches:
        a.fit(ExistingDataSetIterator([ds]))
        lenet_single.append(a.score_)
    lenet_single = [float(v) for v in lenet_single]
    seen = []
    b.fit(RecordingIterator(lbatches, lambda i: seen.append(b.bundle_scores_)))
    lenet_scores = _bundle_scores(b, seen)
    lenet_equal = _states_equal(a, b)
    print(f"phase 10b LeNet: MultiLayerNetwork.fit at steps_per_call={LENET_BUNDLE_K}, "
          f"{LENET_BUNDLE_BATCHES} batches of 64, Adam({ADAM_LR}) (alpha from the bundle's "
          f"device buffer): vs {LENET_BUNDLE_BATCHES} single steps torch.equal "
          f"{lenet_equal}, scores equal {lenet_scores == lenet_single}", flush=True)
    if not all(lenet_equal.values()) or lenet_scores != lenet_single:
        failed.append(f"LeNet bundles differ: {lenet_equal}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"k": k, "equal": equal, "scores": scores, "single_scores": single_scores,
            "main_launches": main_launches, "captured_launches": captured,
            "fused_groups": n_groups, "trace_one_replay": trace, "trace_busy_ms": busy_ms,
            "speed": speed, "phase10_images_per_s": zero1["images_per_s"],
            "stats_collectives": stats, "lenet": {"k": LENET_BUNDLE_K, "equal": lenet_equal, "scores": lenet_scores}}


def _bundled_stats_collectives(fc, failed: list) -> dict:
    """Phase 10b's check of the batch-statistics collectives under capture.
    On one rank the wrapper takes the rows' own statistics with no
    collective; here a small bf16 network (a projecting fused bottleneck, a
    BatchNormalization) takes them through the one-rank NCCL sum all the
    same, as a step over several cards does, through
    ``ParallelWrapper(workers=1, sharded_update)`` at ZERO1_BUNDLE_K against
    1: torch.equal, with each step's sums counted eager and captured."""
    import deeplearning4j_tpu_torch.nn.conf as conf
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn import batch_stats
    from deeplearning4j_tpu_torch.nn.conf import layers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.updaters import Adam

    k, (rows, side, cin, width, classes) = ZERO1_BUNDLE_K, STATS_NET
    def net():
        return MultiLayerNetwork(
            conf.NeuralNetConfiguration.builder().seed(SEED).updater(Adam(ADAM_LR))
            .compute_dtype("bfloat16").list()
            .layer(layers.FusedResNetBottleneck(width=width, project=True))
            .layer(layers.BatchNormalization())
            .layer(layers.GlobalPoolingLayer(pooling_type="avg"))
            .layer(layers.OutputLayer(n_out=classes, activation="softmax"))
            .set_input_type(conf.InputType.convolutional(side, side, cin)).build()).init()

    single, bundled = net(), net()
    rng = np.random.default_rng(SEED + 14)
    batches = [DataSet(rng.standard_normal((rows, side, side, cin)).astype(np.float32),
                       np.eye(classes, dtype=np.float32)[rng.integers(0, classes, rows)])
               for _ in range(ZERO1_BUNDLE_BATCHES)]
    p1 = ParallelWrapper.builder(single).workers(1).sharded_update(True).build()
    pk = ParallelWrapper.builder(bundled).workers(1).sharded_update(True).steps_per_call(k) \
        .build()
    per_step = stats_launches(single, 1)
    with batch_stats.across_ranks(p1.mesh.all_reduce_sum, p1.mesh.n_data):
        fc.reset_launch_counts()
        p1.fit(ExistingDataSetIterator(batches))
        eager = {n: fc.launch_counts.get(n, 0) for n in per_step}
        pk.fit(ExistingDataSetIterator(batches))
    torch.cuda.synchronize()
    captured = {n: pk._bstep._runner.captured_launches.get(n, 0) for n in per_step}
    equal = _states_equal(single, bundled)
    want_eager = {n: len(batches) * v for n, v in per_step.items()}
    want_captured = {n: k * v for n, v in per_step.items()}
    print(f"phase 10b statistics collectives under capture: {rows}x{side}x{side}x{cin} "
          f"bf16, fused bottleneck (width {width}, projecting) + BatchNormalization, "
          f"their statistics through the one-rank NCCL sum; steps_per_call={k} vs 1 "
          f"torch.equal {equal}; sums eager {eager} (want {want_eager}), captured "
          f"{captured} (want {want_captured})", flush=True)
    if not all(equal.values()) or eager != want_eager or captured != want_captured:
        failed.append(f"statistics collectives under capture: equal {equal}, eager {eager} "
                      f"(want {want_eager}), captured {captured} (want {want_captured})")
    return {"equal": equal, "eager": eager, "captured": captured}


# phase 10c: two ranks share the card over gloo (NCCL refuses two ranks on
# one device); each trains phase 10's ResNet-50 on its 16 rows of 32
SHARED_CARD_RANKS = 2
SHARED_CARD_TIMED = 2         # steps timed after the compared one
# BN running statistics after one step, per tensor ||s_2 - s_1|| / ||s_1||:
# the same f32 sums of bf16 conv outputs, which the two runs round alike except
# where the conv kernels' tiling differs between 16 and 32 rows
STATE_REL_TOL = 2.0 ** -7
SCORE_REL_TOL = 1e-3          # phase 4's score rule


def _flat_grads(grads) -> dict:
    return {k: v.detach().float().cpu() for k, v in _flat(grads)}


def _rank_10c(rank: int, root: str) -> None:
    """One of phase 10c's ranks (a spawned process): the model phase 10c's
    process saved, its 16 rows of the batch through ParallelWrapper(workers=2)
    on a gloo group over CUDA tensors: the mean gradient of one step with
    cross-rank and with per-rank statistics, then fit steps; rank 0 saves."""
    import contextlib

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.ops import launch
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh
    from deeplearning4j_tpu_torch.parallel.wrapper import _mean_over_ranks
    from deeplearning4j_tpu_torch.updaters import Adam

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"),
                                                         SHARED_CARD_RANKS),
                            rank=rank, world_size=SHARED_CARD_RANKS)
    try:
        saved = torch.load(os.path.join(root, "model.pt"), weights_only=False)
        model, _ = resnet50(updater=Adam(ADAM_LR))
        model.params_, model.state_ = saved["params"], saved["state"]
        ds = saved["ds"]
        pw = ParallelWrapper.builder(model).workers(SHARED_CARD_RANKS).build()
        mesh = pw.mesh
        batch = pw._pack_batch(ds)
        out = {"host_staged": mesh.host_staged, "rows": int(batch[0][0].shape[0])}
        _, _, grads = _mean_over_ranks(mesh, *pw._value_and_grad(batch))
        out["grads"] = _flat_grads(grads)
        del grads
        real = TrainingMesh.batch_stats
        TrainingMesh.batch_stats = lambda self: contextlib.nullcontext()
        try:
            _, _, grads = _mean_over_ranks(mesh, *pw._value_and_grad(batch))
        finally:
            TrainingMesh.batch_stats = real
        out["grads_per_rank"] = _flat_grads(grads)
        del grads
        launch.reset_launch_counts()
        pw.fit(ExistingDataSetIterator([ds]))
        torch.cuda.synchronize()
        out["launches_per_step"] = dict(launch.launch_counts)
        out["state"] = {k: v.float().cpu() for k, v in _flat(model.state_)}
        out["score"] = float(model.score_)
        t0 = time.perf_counter()
        pw.fit(ExistingDataSetIterator([ds] * SHARED_CARD_TIMED))
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / SHARED_CARD_TIMED
        if rank == 0:
            torch.save(out, os.path.join(root, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tensor_rel(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b}


def shared_card_phase(card: str):
    """Phase 10c: two ranks on the one card (gloo on CUDA tensors), phase
    10's full-width bf16 ResNet-50 through ParallelWrapper(workers=2),
    replicated, each on its 16 rows of one seeded batch of 32, against this
    process's one-rank run (NCCL) on the 32 rows: one step's mean gradient
    under phase 4's gradient rule, the BN running statistics and the score
    after the step; the same ranks with per-rank statistics must be farther
    from the one-rank gradient."""
    import torch.multiprocessing as mp

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.ops import launch
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.wrapper import _mean_over_ranks
    from deeplearning4j_tpu_torch.updaters import Adam

    model, plain = resnet50(updater=Adam(ADAM_LR))
    rng = np.random.default_rng(SEED + 14)
    ds = DataSet(rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)])
    with tempfile.TemporaryDirectory(dir=os.getcwd(), prefix=".phase10c-") as root:
        torch.save({"params": model.params_, "state": model.state_, "ds": ds},
                   os.path.join(root, "model.pt"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(_rank_10c, args=(root,), nprocs=SHARED_CARD_RANKS,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=600):
                pass
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        ranks_s = time.perf_counter() - t0
        two = torch.load(os.path.join(root, "rank0.pt"), weights_only=False)

    # this process: one rank (phase 10's NCCL group) on the 32 rows, and the
    # plain path in f32 as the bf16 noise yardstick of phase 4's rule
    pw = ParallelWrapper.builder(model).workers(1).build()
    _, _, grads = _mean_over_ranks(pw.mesh, *pw._value_and_grad(pw._pack_batch(ds)))
    one = _flat_grads(grads)
    del grads
    f32_conf = copy.deepcopy(plain.conf)
    f32_conf.global_conf.compute_dtype = None
    g32 = _flat_grads(twin(model, f32_conf).compute_gradient_and_score(ds)[0])
    launch.reset_launch_counts()
    pw.fit(ExistingDataSetIterator([ds]))
    torch.cuda.synchronize()
    one_launches = dict(launch.launch_counts)
    state_one = {k: v.float().cpu() for k, v in _flat(model.state_)}
    score_one = float(model.score_)
    ok, rels, ratios, to_f32 = grad_agreement(two["grads"], one, g32)
    _, rels_local, _, _ = grad_agreement(two["grads_per_rank"], one, g32)
    dist_cross = float(np.median(list(rels.values())))
    dist_local = float(np.median(list(rels_local.values())))
    state_rel = _tensor_rel(two["state"], state_one)
    score_rel = abs(two["score"] - score_one) / abs(score_one)
    want = dict(STEP_LAUNCHES, **stats_launches(model, 1))
    want_one = dict(STEP_LAUNCHES)
    q = _quantiles
    print(f"phase 10c two ranks on one card: {SHARED_CARD_RANKS} processes, gloo on CUDA "
          f"tensors (host-staged {two['host_staged']}), ParallelWrapper(workers=2) replicated, "
          f"{two['rows']} rows each of one batch of {BATCH}; vs this process's one rank "
          f"(NCCL) on {BATCH} rows: gradient rule of phase 4 {'ok' if ok else 'FAIL'}, "
          f"||g_2 - g_1|| / ||g_1|| {q(rels)}, ||g_2 - g_1|| / ||g_1 - g_f32|| {q(ratios)}; "
          f"with per-rank statistics ||g - g_1|| / ||g_1|| {q(rels_local)} (median "
          f"{dist_local:.4g} vs cross-rank {dist_cross:.4g}); BN running statistics after the "
          f"step, per tensor ||s_2 - s_1|| / ||s_1|| {q(state_rel)} (tol {STATE_REL_TOL}); "
          f"score {two['score']:.6g} vs {score_one:.6g} (rel {score_rel:.3g}, tol "
          f"{SCORE_REL_TOL})", flush=True)
    print(f"phase 10c launches and collectives per step: ranks {two['launches_per_step']} "
          f"(want {want}), one rank {one_launches} (want {want_one}); "
          f"{two['ms_per_step']:.1f} ms per step on "
          f"the two ranks (host clock; gloo stages each all_reduce through the host, so this "
          f"is no speed figure); the ranks' processes took {ranks_s:.1f}s; on {card}",
          flush=True)
    failed = []
    if not ok or not dist_cross < dist_local:
        failed.append(f"gradients: rule {ok}, cross-rank {dist_cross} vs per-rank {dist_local}")
    if max(state_rel.values()) > STATE_REL_TOL or score_rel > SCORE_REL_TOL:
        failed.append(f"state {max(state_rel.values())} or score {score_rel} off")
    if two["launches_per_step"] != want or one_launches != want_one:
        failed.append(f"launches {two['launches_per_step']} / {one_launches}, want {want} / "
                      f"{want_one}")
    if not two["host_staged"]:
        failed.append("the ranks' mesh is not gloo on CUDA")
    del model, plain, pw
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"grad_rel_err": rels, "grad_err_over_bf16_noise": ratios,
            "grad_rel_err_per_rank_stats": rels_local, "median_rel_cross": dist_cross,
            "median_rel_per_rank": dist_local, "state_rel": state_rel,
            "score": two["score"], "score_one_rank": score_one,
            "launches_per_step": two["launches_per_step"], "one_rank_launches": one_launches,
            "ms_per_step": two["ms_per_step"], "ranks_s": ranks_s}


# phase 11: SharedTrainingMaster on the zoo's LeNet
MASTER_BATCH = 64
MASTER_STEPS = 3
MASTER_BUNDLE_K = 2
MASTER_BUNDLE_BATCHES = 4
MASTER_TIMED = 8


def _plain_master_step(model, ds, residual, threshold, capacity):
    """One shared-training step on one rank written out plainly: the
    gradient, phase 2h's plain selection, the decode, the eager per-layer
    ``Adam.apply``. -> (params, opt, residual, score); the model unchanged."""
    from deeplearning4j_tpu_torch.nn.multilayer import apply_layer_updates

    loss, _, grads = model._value_and_grad(*model._batch(ds))
    flat = torch.cat([g.reshape(-1) for d in grads for _, g in sorted(d.items())])
    (idx, val, _), new_res = plain_encode(residual + flat, threshold, capacity)
    summed = plain_decode(idx[None], val[None], flat.numel())
    synced, off = [], 0
    for d in grads:
        o = {}
        for k in sorted(d):
            o[k] = summed[off:off + d[k].numel()].view(d[k].shape)
            off += d[k].numel()
        synced.append(o)
    params, opt = apply_layer_updates(model.layers, model.params_, synced,
                                      model._ensure_opt_state(), model.iteration + 1,
                                      model.iteration, model.epoch)
    return params, opt, new_res, loss


def master_phase(fu, card: str):
    """Phase 11: SharedTrainingMaster on the zoo's LeNet (Adam(1e-3), batch
    64, threshold 1e-3, capacity 16384 of 431k params: the message is full)
    on phase 10's one-rank NCCL group, deterministic cuDNN."""
    return _deterministic_cudnn(lambda: _master(fu, card))


def _master(fu, card):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import LeNet
    from deeplearning4j_tpu_torch.nn.ops import launch
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster, zero
    from deeplearning4j_tpu_torch.updaters import Adam

    def lenet(k=1):
        net = LeNet(num_classes=10, seed=SEED, updater=Adam(1e-3)).init()
        net.conf.global_conf.steps_per_call = k
        return net

    def master(sharded=False):
        return (SharedTrainingMaster.builder(ENCODE_THRESHOLD)
                .update_capacity(ENCODE_CAPACITY).sharded_update(sharded).build())

    rng = np.random.default_rng(SEED + 15)
    batches = [DataSet(rng.standard_normal((MASTER_BATCH, 28, 28, 1)).astype(np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, MASTER_BATCH)])
               for _ in range(MASTER_BUNDLE_BATCHES)]
    failed = []

    # (a) one step against the same step written out plainly
    net = lenet()
    n_params = net.num_params()
    thr = torch.full((), ENCODE_THRESHOLD, dtype=torch.float32, device="cuda")
    want = _plain_master_step(net, batches[0], torch.zeros(n_params, device="cuda"), thr,
                              min(ENCODE_CAPACITY, n_params))
    m = master()
    m.fit(net, ExistingDataSetIterator(batches[:1]))
    torch.cuda.synchronize()
    got = (net.params_, net.opt_state_, m._residual, net.score_)
    one_step = {"params": _tensors_equal(got[0], want[0]),
                "updater": _tensors_equal(got[1], want[1]),
                "residual": torch.equal(got[2], want[2]), "score": torch.equal(got[3], want[3])}
    sent = int(min(ENCODE_CAPACITY, n_params))
    print(f"phase 11 one step: SharedTrainingMaster on LeNet ({n_params:,} params, capacity "
          f"{ENCODE_CAPACITY}, threshold {ENCODE_THRESHOLD}, Adam(1e-3), batch {MASTER_BATCH}, "
          f"{m.mesh}) vs the step written out plainly (phase 2h's plain selection, decode, eager "
          f"Adam.apply): torch.equal {one_step}", flush=True)
    if not all(one_step.values()):
        failed.append(f"one step differs from the plain step: {one_step}")

    # (b) the main path: replicated and sharded masters, MASTER_STEPS steps;
    # counts from 0 just before the sharded fit, read just after
    nets, masters = [], []
    for sharded in (False, True):
        net, mm = lenet(), master(sharded)
        if sharded:
            launch.reset_launch_counts()
        mm.fit(net, ExistingDataSetIterator(batches[:1] * MASTER_STEPS))
        torch.cuda.synchronize()
        nets.append(net)
        masters.append(mm)
    main_launches = dict(launch.launch_counts)
    groups = sum(i is not None for i in fu.resolve_group_impls(zero.build_layout(nets[1], 1)))
    equal = _states_equal(*nets)
    equal["residual"] = torch.equal(masters[0]._residual, masters[1]._residual)
    magnitude = masters[1].residual_magnitude()
    print(f"phase 11 steps: {MASTER_STEPS} steps, replicated vs sharded_update(True) "
          f"torch.equal {equal}; main-path launches (sharded) {main_launches} (want fused_adam "
          f"{MASTER_STEPS} x G {groups}); residual_magnitude {magnitude:.6g}; scores "
          f"{float(nets[0].score_):.6g} / {float(nets[1].score_):.6g}", flush=True)
    if not all(equal.values()) or main_launches.get("fused_adam", 0) != MASTER_STEPS * groups \
            or groups != 1 or not math.isfinite(magnitude):
        failed.append(f"masters: equal {equal}, launches {main_launches}, G {groups}, "
                      f"residual magnitude {magnitude}")

    # (c) steps_per_call MASTER_BUNDLE_K against 1, sharded: params, slots,
    # residual and scores bit for bit
    single, bundled = lenet(), lenet(MASTER_BUNDLE_K)
    ms, mb = master(True), master(True)
    marks = []
    for ds in batches:
        ms.fit(single, ExistingDataSetIterator([ds]))
        marks.append(float(single.score_))
    seen = []
    launch.reset_launch_counts()
    mb.fit(bundled, RecordingIterator(batches, lambda i: seen.append(bundled.bundle_scores_)))
    torch.cuda.synchronize()
    captured = dict(mb._bstep.captured_launches)
    scores = _bundle_scores(bundled, seen)
    bundle_equal = _states_equal(single, bundled)
    bundle_equal["residual"] = torch.equal(ms._residual, mb._residual)
    print(f"phase 11 bundled: sharded master at steps_per_call={MASTER_BUNDLE_K}, "
          f"{MASTER_BUNDLE_BATCHES} batches, vs the same master at 1 torch.equal "
          f"{bundle_equal}, scores equal {scores == marks}; launches captured {captured}",
          flush=True)
    if not all(bundle_equal.values()) or scores != marks \
            or captured != {"fused_adam": MASTER_BUNDLE_K * groups}:
        failed.append(f"bundles differ: {bundle_equal}, scores {scores} vs {marks}, "
                      f"captured {captured}")

    # (d) ms per step, eager and bundled, in turns
    timed = batches * (MASTER_TIMED // MASTER_BUNDLE_BATCHES)
    speed = _in_turns([("eager", lambda: ms.fit(single, ExistingDataSetIterator(timed))),
                       ("bundled", lambda: mb.fit(bundled, ExistingDataSetIterator(timed)))])
    ms_per_step = {label: [t * 1e3 / len(timed) for t in r["s"]] for label, r in speed.items()}
    fmt = lambda v: [round(x, 3) for x in v]  # noqa: E731
    print(f"phase 11 speed (in turns: eager, bundled, bundled, eager; {len(timed)} steps a fit, "
          f"host clock, synchronized): ms per step eager {fmt(ms_per_step['eager'])}, bundled "
          f"(k {MASTER_BUNDLE_K}) {fmt(ms_per_step['bundled'])}; on {card}", flush=True)
    del nets, masters, single, bundled, ms, mb
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"one_step_equal": one_step, "sharded_equal": equal, "main_launches": main_launches,
            "launches_per_step": {"fused_adam": groups}, "fused_groups": groups,
            "residual_magnitude": magnitude, "bundle_equal": bundle_equal,
            "captured_launches": captured, "ms_per_step": ms_per_step, "params": n_params}


# phase 12: the fault policy on phase 10's ResNet-50 (Adam(ADAM_LR)), seeded
# batches of BATCH, deterministic cuDNN
GUARD_BATCHES = 5             # the poisoned fits' batches
GUARD_POISON = 2              # the step whose gradients are injected NaN
GUARD_K = 5                   # (c): the poisoned fit in one bundle
GUARD_TIMED_K = 4             # (g): bundled fits at steps_per_call 4 ...
GUARD_TIMED = 8               # ... of 8 batches, eager and bundled
GUARD_OVERFLOW_FROM = 96      # (d): the loss scales probed, 2^k for k from here
GUARD_OVERFLOW_STEPS = 5      # (d): fit steps from twice the first overflowing scale


def _displacement(model, p0) -> dict:
    """{name: param - its value in p0} over a graph's params (f32)."""
    return {n: t.float() - p0[n].float() for n, t in _flat(model.params_)}


def _fault_states_equal(a, b) -> bool:
    fa, fb = a.fault_state_, b.fault_state_
    return fa is not None and fb is not None and fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) for k in fa)


def _kernel_overflow_probe(fc):
    """A context recording the fused-conv backward kernels that produced a
    non-finite output (dx, dscale, dshift, dW): from finite inputs ("made",
    an overflow inside the kernel) or from non-finite ones ("carried"); the
    probe of phase 12 (d), on no main path."""
    seen = {"made": set(), "carried": set()}
    saved = dict(fc._OPS)

    def finite(ts):
        return all(bool(torch.isfinite(a).all()) for a in ts
                   if isinstance(a, torch.Tensor) and a.is_floating_point())

    def wrap(name, fn):
        def run(*args):
            out = fn(*args)
            if not finite(out if isinstance(out, tuple) else (out,)):
                seen["made" if finite(args) else "carried"].add(name)
            return out
        return run

    class Probe:
        def __enter__(self):
            for op, (fwd, dx, dw) in saved.items():
                base = "pw_conv" if op == "pw" else "conv3x3"
                fc._OPS[op] = (fwd, wrap(f"{base}_dx", dx), wrap(f"{base}_dw", dw))
            return seen

        def __exit__(self, *exc):
            fc._OPS.update(saved)

    return Probe()


def overflow_kernels(fc) -> dict:
    """Phase 12 (d): each fused-conv kernel at a ResNet-50 shape (pointwise
    256 -> 64 and 3x3 64 -> 64 at 56x56, batch 2) on finite bf16 operands,
    all positive, whose f32 sums overflow in half the pixel rows (those rows
    of x, or of dz, scaled to 2^64 or 2^125): the kernel's outputs are
    non-finite exactly where the plain version's are and finite elsewhere,
    so no epilogue, statistics partial or bf16 conversion saturates the
    overflow or drops it; both halves present. -> {kernel: ok}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)

    def pos(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    out = {}
    for op, cin, cout in (("pw_conv", 256, 64), ("conv3x3", 64, 64)):
        xs = (2 * 56 * 56, cin) if op == "pw_conv" else (2, 56, 56, cin)
        ws = (cin, cout) if op == "pw_conv" else (3, 3, cin, cout)
        half = xs[0] // 2
        s, t = torch.ones(cin, device="cuda"), torch.zeros(cin, device="cuda")
        x = pos(xs, 1.0, 2.0)
        big = x.clone()
        big[:half] *= 2.0 ** 64
        w = pos(ws, 0.5, 1.0)
        fwd, plain = ((fc.pw_conv_fwd, fc.pw_conv_plain) if op == "pw_conv"
                      else (fc.conv3x3_fwd, fc.conv3x3_plain))
        pairs = {op: (fwd(big.bfloat16(), s, t, (w * 2.0 ** 64).bfloat16()),
                      plain(big.bfloat16(), s, t, (w * 2.0 ** 64).bfloat16()))}
        xb, wb = x.bfloat16(), w.bfloat16()
        z, _ = plain(xb, s, t, wb)
        dz = pos(tuple(z.shape), 0.5, 1.0)
        dz[:half] *= 2.0 ** 125
        dz = dz.bfloat16()
        dst = pos((2, cout), 1e-3, 2e-3)
        bwd = ((fc.pw_conv_bwd_dx, fc.pw_conv_bwd_dx_plain, fc.pw_conv_bwd_dw,
                fc.pw_conv_bwd_dw_plain) if op == "pw_conv" else
               (fc.conv3x3_bwd_dx, fc.conv3x3_bwd_dx_plain, fc.conv3x3_bwd_dw,
                fc.conv3x3_bwd_dw_plain))
        args = (xb, s, t, wb, z, dz, dst, False)
        pairs[f"{op}_dx"] = (bwd[0](*args), bwd[1](*args))
        pairs[f"{op}_dw"] = (bwd[2](*args), bwd[3](*args))
        for name, (k, p) in pairs.items():
            ks = k if isinstance(k, tuple) else (k,)
            ps = p if isinstance(p, tuple) else (p,)
            masks = [(torch.isfinite(a.float()), torch.isfinite(b.float())) for a, b in zip(ks, ps)]
            out[name] = {"ok": all(torch.equal(a, b) for a, b in masks)
                         and not bool(masks[0][1].all()),
                         "non_finite": [int((~b).sum()) for _, b in masks],
                         "elements": [int(b.numel()) for _, b in masks]}
    return out


def guard_phase(fc, fu, card: str):
    """Phase 12: the fault policy (train/faults.py) on the full-width bf16
    ResNet-50 through ``ComputationGraph.fit``, the ZeRO-1 wrapper and, on
    LeNet, ``SharedTrainingMaster``, under deterministic cuDNN."""
    return _deterministic_cudnn(lambda: _guard(fc, fu, card))


def _guard(fc, fu, card):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import LeNet
    from deeplearning4j_tpu_torch.nn.graph import _as_multi
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, SharedTrainingMaster, zero
    from deeplearning4j_tpu_torch.train import faults
    from deeplearning4j_tpu_torch.train import pipeline
    from deeplearning4j_tpu_torch.train.faults import FaultPolicy, fault_injection
    from deeplearning4j_tpu_torch.updaters import Adam

    failed = []
    rng = np.random.default_rng(SEED + 20)
    batches = [DataSet(rng.standard_normal((BATCH, 224, 224, 3)).astype(np.float32),
                       np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)])
               for _ in range(GUARD_BATCHES)]
    kept = [b for i, b in enumerate(batches) if i != GUARD_POISON]
    skip_only, scaled = FaultPolicy(loss_scaling=False), FaultPolicy()

    def net(policy=None, k=1):
        model, plain = resnet50(updater=Adam(ADAM_LR))
        if policy is not None:
            model.set_fault_policy(policy)
        model.conf.global_conf.steps_per_call = k
        return model, plain

    def fit(model, data, poison=None):
        with fault_injection([] if poison is None else [poison]):
            model.fit(ExistingDataSetIterator(data))
        torch.cuda.synchronize()

    def free(*models):
        for m in models:
            m.params_ = m.state_ = m.opt_state_ = m.fault_state_ = m._bundled = None
        torch.cuda.empty_cache()

    # (a) gradients of the guarded step (loss scaled by 2^15, unscaled) vs
    # the unguarded step's, phase 4's rule; the verdict's and the selects'
    # device time; then the main path: guarded fit steps, counts from 0
    guarded, plain = net(scaled)
    unguarded_conf = copy.deepcopy(guarded.conf)
    unguarded_conf.global_conf.fault_policy = None
    f32_conf = copy.deepcopy(plain.conf)
    f32_conf.global_conf.compute_dtype = None
    batch = guarded._batch(_as_multi(batches[0]))
    scale = guarded._step_scale()
    _, _, gk = guarded._value_and_grad(*batch, scale=scale)
    _, _, gp = twin(guarded, unguarded_conf)._value_and_grad(*batch)
    _, _, g32 = twin(guarded, f32_conf)._value_and_grad(*batch)
    grads_ok, rels, ratios, to_f32 = grad_agreement(*(dict(_flat(g)) for g in (gk, gp, g32)))
    verdict = faults.all_finite(gk)
    verdict_ms = graph_ms(lambda: faults.all_finite(gk), calls=5)
    opt = guarded._ensure_opt_state()
    tree = (guarded.params_, opt, guarded.state_)
    other = pipeline.tree_map(lambda t: t.clone(), tree)
    n_select = len(pipeline.tree_leaves(tree))
    select_bytes = 3 * sum(t.numel() * t.element_size() for t in pipeline.tree_leaves(tree))
    select_ms = graph_ms(lambda: faults.where_tree(verdict, other, tree), calls=5)
    unscale_ms = graph_ms(lambda: faults.unscale(scale, gk, scale), calls=5)
    del gk, gp, g32, other, opt, tree
    guarded.opt_state_ = None
    q = _quantiles
    print(f"phase 12 (a) gradients: ResNet-50 (phase 10's model, Adam({ADAM_LR})) with "
          f"FaultPolicy() (loss scaling on: bf16), scale {float(scale):g}: guarded vs "
          f"unguarded step over {len(rels)} tensors ||g_g - g_u|| / ||g_u|| {q(rels)}; "
          f"/ ||g_u - g_f32|| {q(ratios)}; ||g_g - g_f32|| / ||g_u - g_f32|| {q(to_f32)} "
          f"{'ok' if grads_ok else 'FAIL'}; device time by CUDA graph: verdict over "
          f"{len(rels)} gradients {verdict_ms:.4f} ms, unscale {unscale_ms:.4f} ms, selects "
          f"over {n_select} tensors (params, Adam slots, BN state; {select_bytes / 1e6:.1f} MB "
          f"moved, bound {select_bytes / PEAK_BYTES * 1e3:.4f} ms) {select_ms:.4f} ms",
          flush=True)
    if not grads_ok or not bool(verdict):
        failed.append("(a) guarded gradients disagree with the unguarded step's")
    fc.reset_launch_counts()
    per_step, scales = [], []
    for ds in batches:
        before = dict(fc.launch_counts)
        guarded.fit(ExistingDataSetIterator([ds]))
        per_step.append({k: fc.launch_counts[k] - before.get(k, 0) for k in fc.launch_counts})
        scales.append(guarded.loss_scale)
    main_launches = dict(fc.launch_counts)
    print(f"phase 12 (a) steps: {GUARD_BATCHES} guarded fit steps, launches per step "
          f"{per_step[0]}; main-path launches {main_launches}; loss scales {scales}; "
          f"bad steps {guarded.bad_step_count}; score {float(guarded.score_):.6g}", flush=True)
    if any(st != STEP_LAUNCHES for st in per_step) or guarded.bad_step_count \
            or not _finite(guarded) or set(scales) != {float(scale)}:
        failed.append(f"(a) guarded steps: launches {per_step}, bad {guarded.bad_step_count}, "
                      f"scales {scales}")
    free(guarded, plain)

    # (b) the skip guard alone, NaN injected at step GUARD_POISON of
    # GUARD_BATCHES, against a guarded run on the other batches; and the guard
    # without faults against an unguarded run on the card
    b1, _ = net(skip_only)
    fit(b1, batches, GUARD_POISON)
    b2, _ = net(skip_only)
    fit(b2, kept)
    equal_b = _states_equal(b1, b2)
    ub, _ = net()
    fit(ub, kept)
    noop_equal = _states_equal(b2, ub)
    noop_dp = float(np.abs(b2.params_flat() - ub.params_flat()).max())
    upd = Adam(ADAM_LR)
    ts = torch.arange(1, 1001, dtype=torch.int32)
    alpha_dev = upd.alpha(ts.cuda(), 0, 0).cpu()
    alpha_host = torch.stack([upd.alpha(int(t), 0, 0) for t in ts])
    alpha_diff = int((alpha_dev != alpha_host).sum())
    alpha_first = ts[alpha_dev != alpha_host][:5].tolist()
    alpha_ulps = int((alpha_dev.view(torch.int32) - alpha_host.view(torch.int32)).abs().max())
    print(f"phase 12 (b) skip guard alone (FaultPolicy(loss_scaling=False)), NaN at step "
          f"{GUARD_POISON} of {GUARD_BATCHES}: vs a guarded run on the other {len(kept)} "
          f"batches torch.equal {equal_b}, bad steps {b1.bad_step_count}; guard without "
          f"faults vs unguarded on the card torch.equal {noop_equal} (max|dp| {noop_dp:.3g}); "
          f"Adam alpha from the device clock vs the host's for t 1..1000: {alpha_diff} "
          f"differ (first at t {alpha_first}), at most {alpha_ulps} ulp", flush=True)
    if not all(equal_b.values()) or b1.bad_step_count != 1:
        failed.append(f"(b) skipped step: equal {equal_b}, bad {b1.bad_step_count}")
    free(b2, ub)

    # (b') the same with loss scaling: the scale halves after the poisoned
    # step; against the removed-batch run by phase 4's rule on the params'
    # displacement, the f32 plain path's on the same batches as yardstick
    b3, _ = net(scaled)
    p0 = {n: t for n, t in _flat(b3.params_)}
    trace = []
    with fault_injection([GUARD_POISON]):
        for ds in batches:
            b3.fit(ExistingDataSetIterator([ds]))
            trace.append(b3.loss_scale)
    b4, plain4 = net(scaled)
    m32 = twin(b4, f32_conf)
    fit(b4, kept)
    fit(m32, kept)
    ok_b3, rels3, ratios3, to_f32_3 = grad_agreement(
        _displacement(b3, p0), _displacement(b4, p0), _displacement(m32, p0))
    s0 = float(scaled.init_loss_scale)
    want_trace = [s0] * GUARD_POISON + [s0 / 2] * (GUARD_BATCHES - GUARD_POISON)
    print(f"phase 12 (b') loss scaling on, NaN at step {GUARD_POISON}: scale trace {trace} "
          f"(want {want_trace}), bad steps {b3.bad_step_count}; displacement vs the "
          f"removed-batch run ||d - d_r|| / ||d_r|| {q(rels3)}, / ||d_r - d_f32|| {q(ratios3)}, "
          f"||d - d_f32|| / ||d_r - d_f32|| {q(to_f32_3)} {'ok' if ok_b3 else 'FAIL'}",
          flush=True)
    if trace != want_trace or b3.bad_step_count != 1 or not ok_b3:
        failed.append(f"(b') trace {trace}, bad {b3.bad_step_count}, rule {ok_b3}")
    free(b4, plain4, m32)

    # (c) (b) and (b') at steps_per_call GUARD_K, the poison inside the one
    # bundle: bit-equal to their eager runs, the fault state (the scale
    # trace's end) too
    bundle = {}
    for label, policy, eager in (("skip", skip_only, b1), ("scaled", scaled, b3)):
        c, _ = net(policy, GUARD_K)
        fc.reset_launch_counts()
        fit(c, batches, GUARD_POISON)
        bundle[label] = {"equal": _states_equal(c, eager),
                         "fault_state": _fault_states_equal(c, eager),
                         "bundles": len(c.bundle_scores_),
                         "captured": dict(c._bundled.captured_launches),
                         "main_launches": dict(fc.launch_counts),
                         "loss_scale": c.loss_scale, "bad": c.bad_step_count}
        free(c)
    print(f"phase 12 (c) bundled at steps_per_call={GUARD_K} (one replay of a captured "
          f"graph), poison inside: {bundle}", flush=True)
    want_capture = {k: GUARD_K * v for k, v in STEP_LAUNCHES.items()}
    for label, r in bundle.items():
        if not all(r["equal"].values()) or not r["fault_state"] or r["bundles"] != GUARD_K \
                or r["captured"] != want_capture:
            failed.append(f"(c) {label}: {r}")
    free(b1, b3)

    # (d) overflow: each kernel on operands whose sums overflow; then the
    # lowest loss scale 2^k (k from GUARD_OVERFLOW_FROM) whose step has
    # non-finite gradients, and where the first non-finite value is made; a
    # fit from twice that scale skips its first steps and backs off until
    # they are finite
    kernel_overflow = overflow_kernels(fc)
    print(f"phase 12 (d) kernels on overflowing operands (non-finite where the plain "
          f"version is, finite elsewhere): {kernel_overflow}", flush=True)
    if not all(r["ok"] for r in kernel_overflow.values()):
        failed.append(f"(d) a kernel saturated or dropped an overflow: {kernel_overflow}")
    d, _ = net(FaultPolicy(loss_scaling=True))
    _, _, g1 = d._value_and_grad(*d._batch(_as_multi(batches[0])))
    g_max = max(float(t.abs().max()) for _, t in _flat(g1))
    del g1
    # the step's largest gradient times a loss scale must pass f32's 2^128
    # below 2^127: where it is under 4, the rows' loss weight (a label mask
    # of one weight, as the wrapper's padding uses) makes it 4 or more
    weight = 2.0 ** max(0, math.ceil(math.log2(4.0 / g_max)))
    probe_ds = DataSet(batches[0].features, batches[0].labels, None,
                       np.full((BATCH, 1), weight, np.float32))
    batch = d._batch(_as_multi(probe_ds))
    k_over, probed, in_kernels = None, [], {}
    for k in range(GUARD_OVERFLOW_FROM, 128):
        with _kernel_overflow_probe(fc) as seen:
            loss, _, g = d._value_and_grad(
                *batch, scale=torch.tensor(2.0 ** k, dtype=torch.float32, device="cuda"))
            ok = bool(faults.all_finite(g))
        probed.append((k, ok, math.isfinite(float(loss))))
        if not ok:
            k_over, in_kernels = k, {n: sorted(v) for n, v in seen.items()}
            break
    free(d)
    overflow = {"kernels": kernel_overflow, "k": k_over, "max_abs_grad_at_scale_1": g_max,
                "loss_weight": weight, "loss_finite": probed[-1][2], "kernel_outputs": in_kernels}
    if k_over is None:
        failed.append(f"(d) no loss scale up to 2^127 overflows the step's gradients "
                      f"(max |g| at scale 1: {g_max:.4g}): {probed[-4:]}")
        print(f"phase 12 (d) overflow probe: max |g| at scale 1 {g_max:.4g}; {probed[-4:]} "
              f"FAIL", flush=True)
    else:
        # the probed batch at every step: each meets the probed scales; a
        # skipped step halves the scale and keeps the params, a good one
        # keeps the scale (no growth in GUARD_OVERFLOW_STEPS) and moves them
        init = 2.0 ** (k_over + 1)
        dn, _ = net(FaultPolicy(init_loss_scale=init))
        steps, scale_now = [], init
        for _ in range(GUARD_OVERFLOW_STEPS):
            held = [t.clone() for _, t in _flat(dn.params_)]
            bad0 = dn.bad_step_count
            dn.fit(ExistingDataSetIterator([probe_ds]))
            skipped = dn.bad_step_count - bad0 == 1
            kept = all(torch.equal(a, b) for a, (_, b) in zip(held, _flat(dn.params_)))
            want = scale_now / 2 if skipped else scale_now
            steps.append({"log2_scale": math.log2(scale_now), "skipped": skipped,
                          "params_kept": kept, "scale_ok": dn.loss_scale == want})
            scale_now = dn.loss_scale
        overflow.update(init_scale=init, steps=steps)
        print(f"phase 12 (d) overflow: max |g| at scale 1 {g_max:.4g}, loss weight "
              f"{weight:g}; gradients first non-finite at scale 2^{k_over} (loss times scale "
              f"finite: {probed[-1][2]}); fused-conv backward kernels with non-finite outputs "
              f"{in_kernels}; fit from 2^{k_over + 1}, step by step: {steps}; params finite "
              f"{_finite(dn)}", flush=True)
        if not (steps[0]["skipped"] and any(not st["skipped"] for st in steps) and _finite(dn)
                and all(st["scale_ok"] and st["params_kept"] == st["skipped"] for st in steps)):
            failed.append(f"(d) overflow fit: {overflow}")
        free(dn)

    # (e) phase 10's ZeRO-1 wrapper, guarded, at k 1 (the poisoned step's p,
    # m, v kept, one fused Adam a group) and k 2 (== k 1)
    z1, _ = net(scaled)
    pw = ParallelWrapper.builder(z1).workers(1).sharded_update(True).build()
    pw.fit(ExistingDataSetIterator(batches[:1]))
    before = (pipeline.tree_map(lambda t: t.clone(), z1.params_),
              pipeline.tree_map(lambda t: t.clone(), z1.opt_state_))
    fc.reset_launch_counts()
    with fault_injection([1]):
        pw.fit(ExistingDataSetIterator(batches[1:2]))
    torch.cuda.synchronize()
    zero_launches = dict(fc.launch_counts)
    kept_pmv = {"params": _tensors_equal(before[0], z1.params_),
                "slots": _tensors_equal(before[1], z1.opt_state_)}
    pw.fit(ExistingDataSetIterator(batches[2:4]))
    groups = sum(i is not None for i in fu.resolve_group_impls(zero.build_layout(z1, 1)))
    z2, _ = net(scaled)
    with fault_injection([1]):
        (ParallelWrapper.builder(z2).workers(1).sharded_update(True).steps_per_call(2).build()
         .fit(ExistingDataSetIterator(batches[:4])))
    torch.cuda.synchronize()
    k2_equal = _states_equal(z1, z2)
    k2_equal["fault_state"] = _fault_states_equal(z1, z2)
    print(f"phase 12 (e) guarded ZeRO-1 wrapper (workers=1, sharded_update): the poisoned "
          f"step keeps p, m, v torch.equal {kept_pmv}, launches in it {zero_launches} (want "
          f"fused_adam {groups} = G); k 2 vs k 1 over 4 batches torch.equal {k2_equal}; bad "
          f"steps {z1.bad_step_count} / {z2.bad_step_count}, scales {z1.loss_scale} / "
          f"{z2.loss_scale}", flush=True)
    if not all(kept_pmv.values()) or zero_launches != dict(STEP_LAUNCHES, fused_adam=groups) \
            or not all(k2_equal.values()) or z1.bad_step_count != 1:
        failed.append(f"(e) ZeRO-1: kept {kept_pmv}, launches {zero_launches}, k2 {k2_equal}")
    free(z1, z2)

    # (f) the LeNet master, guarded: the skipped step keeps the params and
    # the residual
    rng = np.random.default_rng(SEED + 21)
    lb = [DataSet(rng.standard_normal((MASTER_BATCH, 28, 28, 1)).astype(np.float32),
                  np.eye(10, dtype=np.float32)[rng.integers(0, 10, MASTER_BATCH)])
          for _ in range(3)]
    lnet = LeNet(num_classes=10, seed=SEED, updater=Adam(1e-3)).init()
    lnet.set_fault_policy(FaultPolicy())
    master = (SharedTrainingMaster.builder(ENCODE_THRESHOLD).update_capacity(ENCODE_CAPACITY)
              .build())
    master.fit(lnet, ExistingDataSetIterator(lb[:1]))
    held = ([t.clone() for t in pipeline.tree_leaves(lnet.params_)], master._residual.clone())
    with fault_injection([1]):
        master.fit(lnet, ExistingDataSetIterator(lb[1:2]))
    master_kept = {"params": all(torch.equal(a, b) for a, b in
                                 zip(held[0], pipeline.tree_leaves(lnet.params_))),
                   "residual": torch.equal(held[1], master._residual)}
    master.fit(lnet, ExistingDataSetIterator(lb[2:]))
    moved = not all(torch.equal(a, b) for a, b in zip(held[0], pipeline.tree_leaves(lnet.params_)))
    print(f"phase 12 (f) guarded SharedTrainingMaster on LeNet: the skipped step keeps "
          f"{master_kept}; bad steps {lnet.bad_step_count}; trains after it {moved}", flush=True)
    if not all(master_kept.values()) or lnet.bad_step_count != 1 or not moved:
        failed.append(f"(f) master: {master_kept}, bad {lnet.bad_step_count}, moved {moved}")
    del lnet, master

    # (g) images/s, guarded against unguarded, eager and bundled, in turns
    ug, _ = net()
    gd, _ = net(scaled)
    timed = (batches * 2)[:GUARD_TIMED]
    speed = {}
    for mode, k in (("eager", 1), ("bundled", GUARD_TIMED_K)):
        for m in (ug, gd):
            m.conf.global_conf.steps_per_call = k
            m.fit(ExistingDataSetIterator(timed))  # warm (and capture)
        runs = _in_turns([("unguarded", lambda: ug.fit(ExistingDataSetIterator(timed))),
                          ("guarded", lambda: gd.fit(ExistingDataSetIterator(timed)))])
        speed[mode] = {label: [BATCH * GUARD_TIMED / t for t in r["s"]]
                       for label, r in runs.items()}
    fmt = lambda v: [round(x, 2) for x in v]  # noqa: E731
    print(f"phase 12 (g) speed (in turns: unguarded, guarded, guarded, unguarded; "
          f"{GUARD_TIMED} batches a fit, host clock, synchronized): eager images/s "
          f"unguarded {fmt(speed['eager']['unguarded'])} guarded "
          f"{fmt(speed['eager']['guarded'])}; bundled (k {GUARD_TIMED_K}) unguarded "
          f"{fmt(speed['bundled']['unguarded'])} guarded {fmt(speed['bundled']['guarded'])}; "
          f"on {card}", flush=True)
    free(ug, gd)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"main_launches": dict(main_launches, fused_adam=zero_launches.get("fused_adam", 0)),
            "launches_per_step": per_step[0], "zero1_poisoned_step_launches": zero_launches,
            "grad_rel_err": rels, "verdict_ms": verdict_ms, "select_ms": select_ms,
            "select_tensors": n_select, "select_bytes": select_bytes,
            "unscale_ms": unscale_ms, "skip_equal": equal_b, "noop_equal": noop_equal,
            "noop_max_dp": noop_dp, "alpha_differ": alpha_diff, "alpha_first_t": alpha_first,
            "alpha_max_ulps": alpha_ulps,
            "scaled_trace": trace, "bundles": bundle, "overflow": overflow,
            "zero1": {"kept": kept_pmv, "k2_equal": k2_equal, "groups": groups},
            "master_kept": master_kept, "speed": speed}


# phase 13: ParallelInference and the shared engine on phase 3's model
PI_THREADS = 8                # callers
PI_ROWS = 4                   # rows a request
PI_REQUESTS = 6               # requests a caller in the timed runs


def _threads(fn, n):
    """``fn(i)`` for i < n on n threads at once -> {i: result}; the first
    exception raises."""
    import threading

    out, errors = {}, []

    def call(i):
        try:
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _serve_rule(got, ref):
    """Phase 3's rule: (max |dp|, every decided row's top-1 equal)."""
    dp = float(np.abs(got - ref).max())
    top2 = np.sort(ref, 1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * dp
    return dp, bool((got.argmax(1) == ref.argmax(1))[decided].all())


def parallel_inference_phase(fc, card: str, serve: dict):
    """Phase 13: ``ParallelInference`` (sequential, inplace, batched) and an
    ``InferenceEngine`` sharing each dispatch over two devices (the card
    named twice) on phase 3's served bf16 ResNet-50, under deterministic
    cuDNN; ``cli serve --workers``."""
    return _deterministic_cudnn(lambda: _parallel_inference(fc, card, serve))


def _parallel_inference(fc, card, serve):
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    failed = []
    model, _ = resnet50()
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((PI_THREADS * PI_ROWS, 224, 224, 3)).astype(np.float32)
    rows = [x[i * PI_ROWS:(i + 1) * PI_ROWS] for i in range(PI_THREADS)]
    ref = [model.output_single(r) for r in rows]

    seq = ParallelInference.builder(model).inference_mode("sequential").build()
    seq_equal = all(np.array_equal(seq.output(r), want) for r, want in zip(rows, ref))
    inplace = ParallelInference.builder(model).inference_mode("inplace").workers(3).build()
    got = _threads(lambda i: inplace.output(rows[i]), PI_THREADS)
    inplace_equal = all(np.array_equal(got[i], ref[i]) for i in range(PI_THREADS))
    batched = (ParallelInference.builder(model).batch_limit(BATCH).max_wait_ms(20).build())
    got = _threads(lambda i: batched.output(rows[i]), PI_THREADS)
    rule = [_serve_rule(got[i], ref[i]) for i in range(PI_THREADS)]
    batched_dp = max(r[0] for r in rule)
    dispatches = batched.metrics.dispatches
    print(f"phase 13 ParallelInference: ResNet-50 (phase 3's model), {PI_THREADS} callers x "
          f"{PI_ROWS} rows: sequential == model.output {seq_equal}; inplace (3 replicas: the "
          f"model and 2 clones) == model.output on each caller's rows {inplace_equal}; batched "
          f"{dispatches} dispatches, max|dp| vs model.output {batched_dp:.3g} (tol "
          f"{SERVE_PROB_TOL}), decided top-1 equal {all(r[1] for r in rule)}", flush=True)
    if not (seq_equal and inplace_equal) or batched_dp > SERVE_PROB_TOL \
            or not all(r[1] for r in rule) or not 1 <= dispatches < PI_THREADS:
        failed.append(f"ParallelInference: sequential {seq_equal}, inplace {inplace_equal}, "
                      f"batched dp {batched_dp}, dispatches {dispatches}")

    # the shared engine: two row blocks of 16 a bucket-32 dispatch, one caller
    one = InferenceEngine(model, buckets=[BATCH])
    two = InferenceEngine(model, buckets=[BATCH], devices=["cuda:0", "cuda:0"])
    one.warmup()
    two.warmup()
    fc.reset_launch_counts()
    y2 = two.infer(x)
    shared_launches = dict(fc.launch_counts)
    y1 = one.infer(x)
    dp2, top2_ok = _serve_rule(y2, y1)
    want = {k: 2 * v for k, v in serve["per_forward"].items()}
    t_one = time_ms(lambda: one.infer(x))
    t_two = time_ms(lambda: two.infer(x))
    print(f"phase 13 shared engine: devices [cuda:0, cuda:0], bucket {BATCH}: launches in one "
          f"dispatch {shared_launches} (want {want}); vs the one-device engine max|dp| "
          f"{dp2:.3g}, decided top-1 equal {top2_ok}; ms a dispatch (events) one device "
          f"{t_one:.2f}, two blocks {t_two:.2f}", flush=True)
    if shared_launches != want or dp2 > SERVE_PROB_TOL or not top2_ok:
        failed.append(f"shared engine: launches {shared_launches}, dp {dp2}")

    # requests/s, batched against sequential, in turns
    def storm(pi):
        return lambda: _threads(lambda i: [pi.output(rows[i]) for _ in range(PI_REQUESTS)],
                                PI_THREADS)

    timed = _in_turns([("sequential", storm(seq)), ("batched", storm(batched))])
    rps = {label: [PI_THREADS * PI_REQUESTS / t for t in r["s"]] for label, r in timed.items()}
    batched.shutdown()
    seq.shutdown()
    inplace.shutdown()

    # cli serve --workers: 1 serves; one more than the cards refuses, typed
    cards = torch.cuda.device_count()
    cli = {}
    for n in (1, cards + 1):
        r = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                            "--model", "lenet", "--workers", str(n), "--port", "0", "--smoke"],
                           capture_output=True, text=True, timeout=300)
        cli[n] = {"exit": r.returncode, "smoke_ok": "smoke: HTTP 200 ok" in r.stdout,
                  "typed": "NotEnoughDevicesError" in r.stderr
                  and f"has {cards}" in r.stderr}
    fmt = lambda v: [round(t, 1) for t in v]  # noqa: E731
    print(f"phase 13 requests/s (in turns: sequential, batched, batched, sequential; "
          f"{PI_THREADS} callers x {PI_REQUESTS} requests of {PI_ROWS} rows, host clock): "
          f"sequential {fmt(rps['sequential'])}, batched {fmt(rps['batched'])}; cli serve "
          f"--workers 1 --smoke {cli[1]}, --workers {cards + 1} {cli[cards + 1]}; on {card}",
          flush=True)
    if cli[1]["exit"] != 0 or not cli[1]["smoke_ok"] or cli[cards + 1]["exit"] == 0 \
            or not cli[cards + 1]["typed"]:
        failed.append(f"cli serve --workers: {cli}")
    del model, one, two
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"main_launches": shared_launches, "sequential_equal": seq_equal,
            "inplace_equal": inplace_equal, "batched_max_dp": batched_dp,
            "batched_dispatches": dispatches, "shared_max_dp": dp2, "ms_one_device": t_one,
            "ms_two_blocks": t_two, "requests_per_s": rps, "cli": cli}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.ops import build
    from deeplearning4j_tpu_torch.nn.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
    from deeplearning4j_tpu_torch.nn.ops import int8_matmul as im

    card = smi_line()
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel build {build_s:.1f}s", flush=True)
    for lib in ("fused_conv", "fused_conv_bwd", "int8_matmul", "fused_lstm", "flash_attention",
                "flash_attention_bwd", "fused_update"):
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1 ptxas {lib}: {line.strip()}", flush=True)

    rows, summary = kernels_phase(fc)
    bwd_rows, bwd_summary = backward_phase(fc)
    summary.update(bwd_summary)
    int8_rows, summary["int8_matmul"] = int8_phase(im)
    lstm_rows, summary["fused_lstm_cell"] = lstm_phase(fl)
    flash_rows, summary["flash_attention_fwd"] = flash_phase(fa)
    flash_bwd_rows, bwd_flash_summary = flash_bwd_phase(fa)
    summary.update(bwd_flash_summary)
    adam_rows, summary["fused_adam"] = adam_phase(fu)
    encoder = encoder_phase()
    serve = serve_phase(fc, card)
    train = train_phase(fc, card)
    bundle = bundled_train_phase(fc, card, train)
    e8, x, vgg = vgg_phase(fc, im, card)
    entry = entry_points_phase(e8, x)
    gen_engine, seq_engine, prompts, outs, gen = generation_phase(fl, card)
    entry["generate"] = generation_entry_points(seq_engine, gen_engine, prompts, outs)
    lm_gen, lm_predict, lm_prompts, lm_outs, lm = lm_phase(fa, card)
    entry["transformer"] = lm_entry_points(lm_predict, lm_gen, lm_prompts, lm_outs)
    del lm_gen, lm_predict
    lm_train = lm_train_phase(fa, card)
    zero1 = zero1_phase(fc, fu, card, train)
    zero1_bundle = bundled_zero1_phase(fc, fu, card, zero1)
    shared_card = shared_card_phase(card)
    master = master_phase(fu, card)
    guard = guard_phase(fc, fu, card)
    pinf = parallel_inference_phase(fc, card, serve)

    # launches: the fused convs' from the train phase's main path (TRAIN_STEPS
    # fit steps), the int8 matmul's from phase 5's (the int8 VGG16 engine),
    # the LSTM cell's from phase 7's (the generation engine), the flash
    # forward's from phase 8's (the TransformerLM generation engine), the flash
    # backward's from phase 9's (TransformerLM.fit_batch); times: the
    # convs' summed over one batch-32 forward (or backward) at the 19 shapes,
    # the int8 matmul's over the three heads of one VGG16 forward at bucket
    # 32 (bucket 1 under "b1"), the LSTM cell's over the two cells of one
    # decode step at 32 slots (one prefill step, B 1, under "b1"), the flash
    # forward's at the T 1024 prefill (b 1, 12 heads; every timed shape under
    # "by_shape"), the flash backward's at the train step's shape (b 16, 12
    # heads, T 512; T 2048 under "by_shape"); the fused Adam's launches from
    # phase 10's (ParallelWrapper's sharded fit steps), its times at
    # ResNet-50's flat group (VGG16's under "vgg16")
    kernels = []
    main_of = {"int8_matmul": vgg, "fused_lstm_cell": gen, "flash_attention_fwd": lm,
               "flash_attention_dq": lm_train, "flash_attention_dkv": lm_train,
               "fused_adam": zero1}
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        entry_k = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_of.get(name, train)["main_launches"].get(name, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        if name == "fused_lstm_cell":
            entry_k["launches_per_decode_step"] = gen["launches_per_decode_step"]
            entry_k["launches_per_prefill_by_bucket"] = gen["launches_per_prefill_by_bucket"]
            entry_k["device_ms"] = s["kernel_device_ms"]
            entry_k["plain_device_ms"] = s["plain_device_ms"]
            entry_k["library_device_ms"] = s["library_device_ms"]
            entry_k["b1"] = s["b1"]
            entry_k["no_peephole"] = {"b32": s["no_peephole_b32"], "b1": s["no_peephole_b1"]}
        elif name == "flash_attention_fwd":
            entry_k["launches_per_decode_step"] = lm["launches_per_decode_step"]
            entry_k["launches_per_prefill_by_bucket"] = lm["launches_per_prefill_by_bucket"]
            entry_k["launches_per_train_step"] = lm_train["launches_per_step"].get(name, 0)
            entry_k["by_shape"] = s["by_shape"]
        elif name in ("flash_attention_dq", "flash_attention_dkv"):
            entry_k["launches_per_train_step"] = lm_train["launches_per_step"].get(name, 0)
            entry_k["by_shape"] = s["by_shape"]
        elif name == "fused_adam":
            entry_k["launches_per_train_step"] = zero1["launches_per_step"].get(name, 0)
            entry_k["launches_shared_training_master"] = master["main_launches"].get(name, 0)
            entry_k["elements"] = s["elements"]
            entry_k["vgg16"] = s["vgg16"]
        elif name == "int8_matmul":
            entry_k["launches_per_forward"] = vgg["per_forward"].get(name, 0)
            entry_k["device_ms"] = s["kernel_device_ms"]
            entry_k["plain_device_ms"] = s["plain_device_ms"]
            entry_k["library_device_ms"] = s["library_device_ms"]
            entry_k["b1"] = {k: s["b1"][k] for k in (
                "kernel_ms", "kernel_device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
        else:
            entry_k["launches_per_train_step"] = train["launches_per_step"].get(name, 0)
            entry_k["device_ms"] = s["kernel_device_ms"]
            entry_k["library_device_ms"] = s["library_device_ms"]
        # phase 12's guarded steps (the convs' five fit steps, the fused
        # Adam's poisoned ZeRO-1 step) and phase 13's shared-engine dispatch
        if name in guard["main_launches"]:
            entry_k["launches_guarded"] = guard["main_launches"][name]
        if name in pinf["main_launches"]:
            entry_k["launches_shared_engine"] = pinf["main_launches"][name]
        kernels.append(entry_k)
    import torch.distributed as dist

    dist.destroy_process_group()  # phase 10's one-rank NCCL group (phases 10-11)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build_s": build_s,
                   "cases": rows, "backward_cases": bwd_rows, "int8_cases": int8_rows,
                   "lstm_cases": lstm_rows, "flash_cases": flash_rows,
                   "flash_bwd_cases": flash_bwd_rows, "adam_cases": adam_rows,
                   "summary": summary,
                   "serve": serve, "train": train, "train_bundled": bundle,
                   "zero1_bundled": zero1_bundle, "encoder": encoder,
                   "shared_card": shared_card, "shared_training_master": master,
                   "vgg16": vgg, "generation": gen,
                   "transformer": lm, "transformer_train": lm_train, "zero1": zero1,
                   "entry_points": entry, "guard": guard, "parallel_inference": pinf,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
