#!/usr/bin/env python3
"""Where the serving time goes: profile one of the PyTorch port's engines.

Run from the repository root on a CUDA card::

    python3 scripts/torch_serve_profile.py                      # ResNet-50
    python3 scripts/torch_serve_profile.py --model vgg16 --int8 # VGG16, int8 heads
    python3 scripts/torch_serve_profile.py --model vgg16        # VGG16, f32 heads
    python3 scripts/torch_serve_profile.py --model textgenlstm --generate
    python3 scripts/torch_serve_profile.py --model transformerlm --generate
    python3 scripts/torch_serve_profile.py --model transformerlm   # /predict

Builds the same model as ``chip_smoke.py``: for ``resnet50`` its serve
phase's (full-width bf16 ResNet-50, 1000 classes, 224x224, fused
bottlenecks, seeded random weights with randomized BN), for ``vgg16`` its
phase 5's (full-width f32 VGG16, 1000 classes, 224x224x3, seeded, the
output layer's W scaled to spread the softmax; ``--int8`` serves the three
dense heads through the int8 kernel), for ``textgenlstm --generate`` its
phase 7's (full-width TextGenerationLSTM, 77 characters, two
GravesLSTM(256), seeded, in a 32-slot GenerationEngine), for
``transformerlm`` its phase 8's (GPT-2 small's shape, 32,000 tokens, bf16,
seeded, the head scaled; ``--generate`` in a 32-slot GenerationEngine, else
in an InferenceEngine answering token ids). It warms the engine up, then
profiles requests of 32 rows and of 1 row (transformerlm: 2 rows of 1024
tokens and 1 row of 100) with ``torch.profiler`` (CPU + CUDA activities);
with ``--generate``, one decode step with all 32 slots active (half greedy,
half sampled; a TransformerLM's slots at position 512 of the window) and
one prefill at each prefill bucket. It prints, per request size (or step): host milliseconds per call,
device busy milliseconds (the sum of device kernel and copy time), the
device's idle share, device ops per request, the device time by group
(the port's kernels, convolutions, copies, the rest; groups are read from
the kernel names) and the top device-time entries by name. The full tables
go to ``chiprun_out/serve_profile_<model>[_int8|_generate].json``.
"""

from __future__ import annotations

import argparse
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


# device-time groups, by kernel name (first match wins): cuDNN's kernels
# carry "cudnn" or an FFT/layout-transform name (its FFT path runs a complex
# GEMM, "gemm_cf32"); cuBLAS's GEMM/GEMV come after them (its bf16 kernels
# are named "nvjet_*" or "cutlass*")
GROUPS = (
    ("flash-attention kernels", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel")),
    ("fused LSTM cell kernels", ("lstm_cell_kernel",)),
    ("fused Adam kernel", ("fused_adam_kernel",)),
    ("collectives (NCCL)", ("nccl",)),
    ("concatenations (torch.cat)", ("catarraybatchedcopy",)),
    ("int8_matmul kernels", ("int8_partial_kernel", "int8_reduce_kernel")),
    ("fused conv kernels", ("fused_conv_fwd_kernel", "conv_bwd_dx_kernel",
                            "conv_bwd_dw_kernel", "dw_reduce_kernel", "stats_reduce")),
    ("copies", ("memcpy", "memset")),
    ("convolutions (cuDNN)", ("cudnn", "convolve", "fft", "flip_filter",
                              "mult_and_sum_complex", "nchwtonhwc", "nhwctonchw",
                              "gemm_cf32", "winograd", "dgrad", "wgrad")),
    ("matmuls (cuBLAS)", ("gemm", "gemv", "nvjet", "cutlass")),
    ("sorts (the sampler)", ("radixsort", "sort")),
    ("reductions (norms, softmax sums, argmax)", ("reduce_kernel",)),
)


def groups(rows) -> dict:
    """Device us per request by group of kernel names; the rest is "other"."""
    out = {name: 0.0 for name, _ in GROUPS}
    out["other"] = 0.0
    for r in rows:
        key = r["name"].lower()
        name = next((g for g, pats in GROUPS if any(p in key for p in pats)), "other")
        out[name] += r["device_us"]
    return out


def profile_calls(fn, reps: int):
    """Profile ``reps`` calls of ``fn`` after one warm-up call. Per call:
    host ms, device busy ms, idle share, device ops, and the top device-time
    entries (device us and count per call) and the device us by group."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for evt in prof.key_averages():
        dev = _device_time_us(evt)
        if dev > 0 and evt.device_type.name in ("CUDA", "PrivateUse1"):
            rows.append({"name": evt.key, "device_us": dev / reps,
                         "count": evt.count / reps})
    rows.sort(key=lambda r: -r["device_us"])
    busy_ms = sum(r["device_us"] for r in rows) / 1e3
    launches = sum(r["count"] for r in rows)
    return {"host_ms": host_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / host_ms),
            "device_ops": launches, "groups_us": groups(rows), "top": rows[:40]}


def build_engine(model_name: str, int8: bool):
    """The engine and a seeded batch of 32 rows, as ``chip_smoke.py`` builds
    them."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    x = np.random.default_rng(chip_smoke.SEED).standard_normal(
        (32, 224, 224, 3)).astype(np.float32)
    if model_name == "resnet50":
        from deeplearning4j_tpu_torch.models import ResNet50

        model = ResNet50(num_classes=1000, height=224, width=224, fused_pallas=True,
                         compute_dtype="bfloat16", seed=chip_smoke.SEED).init()
        chip_smoke.randomize_bn(model, chip_smoke.SEED)
    else:
        from deeplearning4j_tpu_torch.models import VGG16

        model = VGG16(num_classes=1000, seed=chip_smoke.SEED).init()
        chip_smoke.spread_softmax(model, x)
    return InferenceEngine(model, buckets=[1, 8, 32], int8_serving=int8), x


def _decode_inputs(rng, S, vocab):
    """Every slot active, even slots greedy and odd slots sampled as
    ``chip_smoke.py`` samples."""
    cs = chip_smoke
    sampled = np.arange(S) % 2 == 1
    return dict(
        tokens=rng.integers(0, vocab, S).astype(np.int32),
        temperature=np.where(sampled, cs.SAMPLED["temperature"], 0.0).astype(np.float32),
        top_k=np.where(sampled, cs.SAMPLED["top_k"], 0).astype(np.int64),
        top_p=np.where(sampled, cs.SAMPLED["top_p"], 0.0).astype(np.float32),
        keys=np.stack([np.arange(S), np.zeros(S)], 1).astype(np.int64),
        active=np.ones(S, bool))


def generation_calls(model_name: str):
    """The generation engine of phase 7 (textgenlstm) or phase 8
    (transformerlm), warmed up, and the calls to profile: one decode step
    with every slot active and one prefill per bucket."""
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine

    cs = chip_smoke
    if model_name == "textgenlstm":
        from deeplearning4j_tpu_torch.models import TextGenerationLSTM

        model = TextGenerationLSTM(num_classes=cs.TEXTGEN_VOCAB, units=cs.LSTM_UNITS,
                                   seed=cs.SEED).init()
        cs.randomize_lstm(model, cs.SEED)
        rng = np.random.default_rng(cs.SEED + 21)
        cs.spread_softmax(model, np.eye(cs.TEXTGEN_VOCAB, dtype=np.float32)[
            rng.integers(0, cs.TEXTGEN_VOCAB, (16, 32))])
        vocab, slots = cs.TEXTGEN_VOCAB, cs.GEN_SLOTS
        engine = GenerationEngine(model, n_slots=slots, max_length=cs.GEN_MAX_LENGTH,
                                  prefill_buckets=cs.GEN_BUCKETS)
        pos = np.zeros(slots, np.int64)
    else:
        model, rng = transformer_model()
        vocab, slots = model.cfg.vocab_size, cs.LM_SLOTS
        engine = GenerationEngine(model, n_slots=slots, max_length=model.cfg.max_length,
                                  prefill_buckets=cs.LM_BUCKETS)
        pos = np.full(slots, 512, np.int64)
    engine.warmup()
    backend = engine.backend
    d = _decode_inputs(rng, slots, vocab)

    def decode():
        with torch.inference_mode():
            backend.decode(d["tokens"], pos, d["active"], d["temperature"], d["top_k"],
                           d["top_p"], d["keys"])

    def prefill(tb):
        prompt = rng.integers(0, vocab, tb).astype(np.int32)

        def run():
            with torch.inference_mode():
                backend.prefill(0, prompt, 0.0, 0, 0.0, np.zeros(2, np.int64))
        return run

    calls = [(f"decode step, {slots} slots", decode, 50)]
    calls += [(f"prefill bucket {tb}", prefill(tb), 5) for tb in backend.buckets]
    return engine, calls


def transformer_model():
    """Phase 8's TransformerLM (seeded, head scaled) and its rng."""
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm

    cs = chip_smoke
    model = tlm.TransformerLM(seed=cs.SEED, **cs.LM_CONF).init()
    rng = np.random.default_rng(cs.SEED + 41)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 256))).cuda()
    cs.lm_spread_softmax(tlm, model, ids)
    return model, rng


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("resnet50", "vgg16", "textgenlstm", "transformerlm"),
                    default="resnet50")
    ap.add_argument("--int8", action="store_true",
                    help="serve the dense heads through the int8 kernel (vgg16)")
    ap.add_argument("--generate", action="store_true",
                    help="profile the generation engine's decode steps and prefills "
                         "(textgenlstm, transformerlm)")
    args = ap.parse_args()
    if args.int8 and args.model != "vgg16":
        ap.error("--int8 serves a MultiLayerNetwork's heads: use --model vgg16")
    if args.generate and args.model not in ("textgenlstm", "transformerlm"):
        ap.error("--generate goes with --model textgenlstm or transformerlm")
    if args.model == "textgenlstm" and not args.generate:
        ap.error("--model textgenlstm goes with --generate")
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2

    card = chip_smoke.smi_line()
    if args.generate:
        engine, calls = generation_calls(args.model)
        tag = f"{args.model}_generate"
    elif args.model == "transformerlm":
        from deeplearning4j_tpu_torch.serving import InferenceEngine

        model, rng = transformer_model()
        engine = InferenceEngine(model, buckets=[1, 2])
        engine.warmup(example_shape=(1024,))
        ids = rng.integers(0, model.cfg.vocab_size, (2, 1024))
        tag = args.model
        calls = [("rows 2 x 1024 tokens", lambda: engine.infer(ids), 10),
                 ("rows 1 x 100 tokens", lambda: engine.infer(ids[:1, :100]), 20)]
    else:
        engine, x = build_engine(args.model, args.int8)
        engine.warmup()
        tag = args.model + ("_int8" if args.int8 else "")
        calls = [(f"rows {n}", (lambda n=n: engine.infer(x[:n])), reps)
                 for n, reps in ((32, 10), (1, 20))]
    out = {"card": card, "torch": torch.__version__, "model": tag}
    for what, fn, reps in calls:
        r = profile_calls(fn, reps)
        out[what] = r
        print(f"{tag} {what}: host {r['host_ms']:.3f} ms/call, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops']:.0f} device ops/call, on {card}",
              flush=True)
        busy_us = max(r["device_busy_ms"] * 1e3, 1e-9)
        print("  by group: " + ", ".join(
            f"{g} {us / 1e3:.3f} ms ({us / busy_us:.3f} of busy)"
            for g, us in r["groups_us"].items()), flush=True)
        for row in r["top"][:12]:
            print(f"  {row['device_us']:10.1f} us  x{row['count']:6.1f}  "
                  f"{row['name'][:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"serve_profile_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    if args.generate:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
