#!/usr/bin/env python3
"""Time the data-parallel paths of one tree on one CUDA card.

Run from the repository root::

    python3 scripts/torch_parallel_times.py --encoder --collectives
    python3 scripts/torch_parallel_times.py --phases 10,10b --root DIR --label NAME

``--encoder``: the threshold encode of ``parallel/compression.py`` at
ResNet-50's and VGG16's flat gradient sizes (capacity 16384, threshold
1e-3, seeded N(0, 1e-3) gradients), device only (``chip_smoke.graph_ms``),
beside two other selections that give the same message (each is checked
to): ``torch.topk`` of unique int64 (score bits, reversed index) keys, and
the k-th score from ``torch.topk`` with the ties filled by a cumsum and the
kept ones compacted without a host sync; and beside ``torch.topk`` of |g|
alone.

``--collectives``: on a one-rank NCCL group, the host µs a call of a bare
``all_reduce`` of a (2, 512) f32 tensor, of ``TrainingMesh.all_reduce_sum``
forward and backward against the same ops without it, and the eager
ZeRO-1 step of ``chip_smoke.py`` phase 10 (ResNet-50, batch 32) with its
batch statistics taken through that one-rank sum (``nn/batch_stats.
across_ranks``, which a one-rank wrapper leaves out) and without, in turns
(on off off on), host clock over a fit of 10 batches.

``--phases``: ``chip_smoke.py``'s phases 10 and/or 10b of the tree at
``--root`` (its ``chip_smoke.py`` and package; default this checkout), so
that a parent and a change run in turns in one call (one process a tree).

Prints the card's name and power limit and, last, one JSON line; the same
goes to ``chiprun_out/parallel_times[_NAME].json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"ResNet-50": 25_557_032, "VGG16": 138_357_544}


def key_topk_select(score, k):
    """The k largest scores by ``torch.topk`` of int64 keys (the score's f32
    bits above, the index reversed below: unique, so the order of ties is
    the index's)."""
    n = score.numel()
    rev = n - 1 - torch.arange(n, device=score.device)
    key = (score.view(torch.int32).to(torch.int64) << 32) | rev
    idx = n - 1 - (torch.topk(key, k).values & 0xFFFFFFFF)
    return score[idx], idx


def tie_fill_select(score, k):
    """The k-th score from ``torch.topk``, every element above it and the
    lowest-index ones equal to it (a cumsum), compacted into k slots by a
    scatter (the rest to a dump slot) and sorted stably by score."""
    n = score.numel()
    kth = torch.topk(score, k).values[k - 1]
    above, equal = score > kth, score == kth
    keep = above | (equal & (torch.cumsum(equal, 0) <= k - above.sum()))
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, k)
    kept = torch.empty(k + 1, dtype=torch.int64, device=score.device)
    kept.scatter_(0, slot, torch.arange(n, device=score.device))
    kept = kept[:k]
    values, order = torch.sort(score[kept], descending=True, stable=True)
    return values, kept[order]


def encoder_times(cs):
    from deeplearning4j_tpu_torch.parallel import compression as pc

    out = {}
    for name, n in SIZES.items():
        g = torch.Generator(device="cuda").manual_seed(n % 9973)
        grad = torch.randn(n, generator=g, device="cuda") * 1e-3
        thr = torch.full((), 1e-3, device="cuda")
        want, _ = pc.threshold_encode(grad, thr, 16384)
        row = {"same": {}}
        for label, select in (("key_topk", key_topk_select), ("tie_fill", tie_fill_select)):
            saved = pc._top_k
            pc._top_k = select
            try:
                got, _ = pc.threshold_encode(grad, thr, 16384)
                row["same"][label] = all(torch.equal(a, b) for a, b in zip(got, want))
                row[f"{label}_ms"] = cs.graph_ms(
                    lambda: pc.threshold_encode(grad, thr, 16384), calls=5, replays=4)
            finally:
                pc._top_k = saved
        row["port_ms"] = cs.graph_ms(lambda: pc.threshold_encode(grad, thr, 16384),
                                     calls=5, replays=4)
        row["topk_alone_ms"] = cs.graph_ms(lambda: torch.topk(grad.abs(), 16384),
                                           calls=5, replays=4)
        print(f"encoder {name} {n:,}: {row}", flush=True)
        out[name] = row
        del grad
        torch.cuda.empty_cache()
    return out


def host_us(fn, calls: int = 200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def collective_times(cs):
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn import batch_stats
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh
    from deeplearning4j_tpu_torch.updaters import Adam

    mesh = TrainingMesh(1, device="cuda")
    x = torch.randn(2, 512, device="cuda", requires_grad=True)

    def with_sum():
        (y,) = mesh.all_reduce_sum([x * 1.0])
        (y * 2.0).sum().backward()

    def without():
        (x * 1.0 * 2.0).sum().backward()

    out = {"all_reduce_us": host_us(lambda: dist.all_reduce(x.detach())),
           "all_reduce_sum_fwd_bwd_us": host_us(with_sum),
           "same_ops_without_us": host_us(without)}
    model, _ = cs.resnet50(updater=Adam(cs.ADAM_LR))
    rng = np.random.default_rng(cs.SEED)
    ds = DataSet(rng.standard_normal((cs.BATCH, 224, 224, 3)).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, cs.BATCH)])
    pw = ParallelWrapper.builder(model).workers(1).sharded_update(True).build()
    pw.fit(ExistingDataSetIterator([ds] * 3))
    steps = {"on": [], "off": []}
    for label in ("on", "off", "off", "on"):
        with (batch_stats.across_ranks(mesh.all_reduce_sum, mesh.n_data) if label == "on"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw.fit(ExistingDataSetIterator([ds] * 10))
            torch.cuda.synchronize()
        steps[label].append((time.perf_counter() - t0) * 100)
    out["zero1_step_ms_stats"] = steps
    print(f"collectives: {out}", flush=True)
    return out


def phase_times(cs, phases):
    from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu

    card = cs.smi_line()
    out = {}
    if "10" in phases:
        out["10"] = cs.zero1_phase(fc, fu, card, {"images_per_s": 0.0})
    if "10b" in phases:
        out["10b"] = cs.bundled_zero1_phase(fc, fu, card, out.get("10", {"images_per_s": 0.0}))
    return {p: {k: v for k, v in r.items() if k in ("images_per_s", "ms_per_step", "speed",
                                                      "launches_per_step")}
            for p, r in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--encoder", action="store_true")
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--phases", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parallel_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.ops import build

    build.build_all()
    card = cs.smi_line()
    out = {"card": card, "root": root}
    if args.encoder:
        out["encoder"] = encoder_times(cs)
    if args.collectives:
        out["collectives"] = collective_times(cs)
    if args.phases:
        out["phases"] = phase_times(cs, args.phases.split(","))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = f"parallel_times{'_' + args.label if args.label else ''}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(card)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
