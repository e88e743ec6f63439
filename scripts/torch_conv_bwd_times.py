#!/usr/bin/env python3
"""Time the fused-conv backward kernels of one tree: ``chip_smoke.py``'s
phase 2b alone, on the package found under ``--root``.

Run from the repository root on a CUDA card::

    python3 scripts/torch_conv_bwd_times.py                          # this checkout
    python3 scripts/torch_conv_bwd_times.py --root DIR --label NAME  # another tree

Phase 2b holds the four backward kernels (pointwise and 3x3, dx and dW)
against their plain versions at ResNet-50's 19 shapes at batch 32 and the
ragged cases, and times each kernel (CUDA events and device only, by CUDA
graph replay), its plain version and its library call, summed over a train
step's launches. The phase's code is this checkout's; only the package
``deeplearning4j_tpu_torch`` is imported from ``--root`` (its kernels are
built there), so two trees can be timed in turns in one call on one card.
Prints the card's name and power limit and, last, one JSON line of the four
kernels' totals; the per-shape rows go to
``chiprun_out/conv_bwd_times[_NAME].json``. With ``--dw-only`` it times a
dW kernel alone by device time, without the checks (for variants of the
kernel whose results are not meant to be right, such as one that skips its
reduce): ``--op pw_conv`` (the default) at the fifteen pointwise shapes,
``--op conv3x3`` at the four 3x3 shapes; with ``--splits 1,2,4`` the 3x3 dW
is timed at each given number of pixel chunks instead of its planner's
(``fused_conv.c3_dw_tiles`` overridden), to choose the planner's split::

    python3 scripts/torch_conv_bwd_times.py --dw-only --op conv3x3 --splits 1,2,4,7

With ``--dx-only`` it times the 3x3 dx kernel alone the same way, beside
``conv2d_input``'s device time, at the four 3x3 shapes; with ``--tile-n
64,128`` at each given column tile N instead of its planner's
(``fused_conv.c3_dx_tiles`` overridden), to choose the planner's N::

    python3 scripts/torch_conv_bwd_times.py --dx-only --tile-n 64,128
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dw_alone(cs, fc, op, splits=()):
    """Device ms of the ``op`` dW kernel at each of its shapes in a batch-32
    ResNet-50 step (phase 2b's inputs), and their sum over the step's
    launches; with ``splits``, the 3x3 dW at each forced number of pixel
    chunks (a row per shape and chunk count, no step sum)."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    pw = op == "pw_conv"
    cases = cs.PW_CASES if pw else [(c, c, hw, n) for c, hw, n in cs.C3_CASES]
    kern = fc.pw_conv_bwd_dw if pw else fc.conv3x3_bwd_dw
    plan = fc.c3_dw_tiles
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for cin, cout, hw, count in cases:
        (x, s, t, w), m, _ = cs.case_inputs(gen, op, cin, cout, hw, cs.BATCH)
        args = cs.bwd_case(fc, gen, op, x, s, t, w)
        for k in splits or [None]:
            chunk = None if pw else plan(m, cin, cout, sms)[1]
            if k is not None:   # k chunks of whole 32-pixel stages
                chunk = -(-(-(-m // k)) // 32) * 32
                fc.c3_dw_tiles = lambda *a, c=chunk: (plan(*a)[0], c, -(-a[0] // c))
            try:
                ms = cs.graph_ms(lambda: kern(*args, True))
            finally:
                fc.c3_dw_tiles = plan
            chunks = None if pw else -(-m // chunk)
            rows.append({"cin": cin, "cout": cout, "hw": hw, "launches_per_forward": count,
                         "chunks": chunks, "dw_kernel_device_ms": ms})
            print(f"{op}_dw {cin}->{cout} @{hw}x{hw} batch {cs.BATCH}"
                  f"{'' if pw else f', {chunks} chunks'}: device only (CUDA graph) "
                  f"{ms:.4f} ms", flush=True)
    if splits:
        return rows, {}
    total = sum(r["launches_per_forward"] * r["dw_kernel_device_ms"] for r in rows)
    launches = sum(r["launches_per_forward"] for r in rows)
    print(f"{op}_dw over a train step's {launches} launches: device only {total:.4f} ms",
          flush=True)
    return rows, {f"{op}_dw": {"kernel_device_ms": total}}


def dx_alone(cs, fc, tile_ns=()):
    """Device ms of the 3x3 dx kernel and of ``conv2d_input`` at the four
    3x3 shapes of a batch-32 ResNet-50 step (phase 2b's inputs), and their
    sums over the step's launches; with ``tile_ns``, the kernel at each
    forced column tile N (a row per shape and N, no step sum)."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    plan = fc.c3_dx_tiles
    rows = []
    for c, hw, count in cs.C3_CASES:
        (x, s, t, w), _, _ = cs.case_inputs(gen, "conv3x3", c, c, hw, cs.BATCH)
        args = cs.bwd_case(fc, gen, "conv3x3", x, s, t, w)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = cs.graph_ms(functools.partial(
            torch.nn.grad.conv2d_input, x.permute(0, 3, 1, 2).shape, wc,
            args[5].permute(0, 3, 1, 2), padding=1))
        for n in tile_ns or [plan(c)]:
            fc.c3_dx_tiles = lambda *a, n=n: n
            try:
                ms = cs.graph_ms(lambda: fc.conv3x3_bwd_dx(*args, True))
            finally:
                fc.c3_dx_tiles = plan
            rows.append({"cin": c, "cout": c, "hw": hw, "launches_per_forward": count,
                         "tile_n": n, "dx_kernel_device_ms": ms,
                         "dx_library_device_ms": lib_ms})
            print(f"conv3x3_dx {c}->{c} @{hw}x{hw} batch {cs.BATCH}, N {n}: device only "
                  f"(CUDA graph) {ms:.4f} ms; conv2d_input {lib_ms:.4f} ms", flush=True)
    if tile_ns:
        return rows, {}
    total = sum(r["launches_per_forward"] * r["dx_kernel_device_ms"] for r in rows)
    lib = sum(r["launches_per_forward"] * r["dx_library_device_ms"] for r in rows)
    launches = sum(r["launches_per_forward"] for r in rows)
    print(f"conv3x3_dx over a train step's {launches} launches: device only {total:.4f} ms; "
          f"conv2d_input {lib:.4f} ms", flush=True)
    return rows, {"conv3x3_dx": {"kernel_device_ms": total, "library_device_ms": lib}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the tree whose package is timed")
    ap.add_argument("--label", default="", help="a name for the output file")
    ap.add_argument("--dw-only", action="store_true",
                    help="time one dW kernel alone, without the checks")
    ap.add_argument("--op", choices=("pw_conv", "conv3x3"), default="pw_conv",
                    help="the dW kernel that --dw-only times")
    ap.add_argument("--splits", default="",
                    help="with --dw-only --op conv3x3: pixel chunk counts to time, "
                         "comma-separated, in place of the planner's")
    ap.add_argument("--dx-only", action="store_true",
                    help="time the 3x3 dx kernel alone, without the checks")
    ap.add_argument("--tile-n", default="",
                    help="with --dx-only: column tiles N to time, comma-separated, "
                         "in place of the planner's")
    args = ap.parse_args()
    splits = [int(k) for k in args.splits.split(",") if k]
    tile_ns = [int(k) for k in args.tile_n.split(",") if k]
    if splits and not (args.dw_only and args.op == "conv3x3"):
        ap.error("--splits takes --dw-only --op conv3x3")
    if args.dw_only and args.dx_only:
        ap.error("--dw-only and --dx-only exclude each other")
    if tile_ns and not args.dx_only:
        ap.error("--tile-n takes --dx-only")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_conv_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.ops import fused_conv as fc

    if not os.path.abspath(fc.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {fc.__file__}, not the package under {root}")
    card = cs.smi_line()
    print(f"conv backward times of {root}: {card}", flush=True)
    if args.dw_only:
        rows, summary = dw_alone(cs, fc, args.op, splits)
    elif args.dx_only:
        rows, summary = dx_alone(cs, fc, tile_ns)
    else:
        rows, summary = cs.backward_phase(fc)
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"conv_bwd_times{'_' + args.label if args.label else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump({"card": card, "root": root, "rows": rows, "summary": summary}, f, indent=1)
    print(card)
    print(json.dumps({"root": root, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
