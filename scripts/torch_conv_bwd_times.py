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
``chiprun_out/conv_bwd_times[_NAME].json``. With ``--dw-only`` it times the
pointwise dW kernel alone by device time at the fifteen pointwise shapes,
without the checks (for variants of the kernel whose results are not
meant to be right, such as one that skips its reduce).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dw_alone(cs, fc):
    """Device ms of the pointwise dW kernel at each pointwise shape of a
    batch-32 ResNet-50 step (phase 2b's inputs), and their sum over the
    step's 36 launches."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    rows = []
    for cin, cout, hw, count in cs.PW_CASES:
        (x, s, t, w), m, _ = cs.case_inputs(gen, "pw_conv", cin, cout, hw, cs.BATCH)
        args = cs.bwd_case(fc, gen, "pw_conv", x, s, t, w)
        ms = cs.graph_ms(lambda: fc.pw_conv_bwd_dw(*args, True))
        rows.append({"cin": cin, "cout": cout, "hw": hw, "launches_per_forward": count,
                     "dw_kernel_device_ms": ms})
        print(f"pw_conv_dw {cin}->{cout} @{hw}x{hw} batch {cs.BATCH}: device only (CUDA "
              f"graph) {ms:.4f} ms", flush=True)
    total = sum(r["launches_per_forward"] * r["dw_kernel_device_ms"] for r in rows)
    print(f"pw_conv_dw over a train step's 36 launches: device only {total:.4f} ms", flush=True)
    return rows, {"pw_conv_dw": {"kernel_device_ms": total}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the tree whose package is timed")
    ap.add_argument("--label", default="", help="a name for the output file")
    ap.add_argument("--dw-only", action="store_true",
                    help="time the pointwise dW kernel alone, without the checks")
    args = ap.parse_args()
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
    rows, summary = dw_alone(cs, fc) if args.dw_only else cs.backward_phase(fc)
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"conv_bwd_times{'_' + args.label if args.label else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump({"card": card, "root": root, "rows": rows, "summary": summary}, f, indent=1)
    print(card)
    print(json.dumps({"root": root, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
