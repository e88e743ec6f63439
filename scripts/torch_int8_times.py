#!/usr/bin/env python3
"""Time the int8 weight-only matmul of one tree at VGG16's three heads.

Run from the repository root on a CUDA card::

    python3 scripts/torch_int8_times.py                          # this checkout
    python3 scripts/torch_int8_times.py --root DIR --label NAME  # another tree

At buckets 1 and 32 (f32 x, the VGG16 path; ``--dtype bfloat16`` for bf16
x) it times ``int8_matmul`` on each head, device only (``chip_smoke.graph_ms``,
CUDA-graph replay) and by CUDA events (``chip_smoke.time_ms``), beside the
library's ``torch.matmul`` on the dequantized weight (in x's type), and
prints each head and the three heads' sums with the bound of phase 2c
(``chip_smoke.int8_bound``). Each head's result is also held to the plain
version (``chip_smoke.check_int8``: the tolerance of phase 2c, not the f64
gate), and the run fails on a miss unless ``--times-only`` is given (for
variants of the kernel whose results are not meant to be right). With
``--profile`` it also prints each head's device time by kernel (the x
planes, the main kernel, the reduce) from ``torch.profiler``. The timing
code is this checkout's; only the package ``deeplearning4j_tpu_torch`` is
imported from ``--root`` (its kernels are built there), so two trees can be
timed in turns in one call on one card. Prints the card's name and power limit and, last,
one JSON line of the sums; the rows go to
``chiprun_out/int8_times[_NAME].json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


KERNEL_PARTS = ("int8_planes_kernel", "int8_matmul_kernel_sm90", "int8_reduce_kernel")


def by_kernel(fn, calls: int = 20):
    """Device µs a call of ``fn`` by kernel name part (``torch.profiler``
    over ``calls`` calls after a warm-up); kernels of no part go to
    "other"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNEL_PARTS + ("other",), 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if not us:
            continue
        part = next((p for p in KERNEL_PARTS if p in evt.key), "other")
        out[part] += us / calls
    return out


def head_times(cs, im, dtype=torch.float32, profile=False):
    """Rows of (B, K, N) with the kernel's and the library's device and
    event ms, the bound, the kernel's err/tol against the plain version
    and, with ``profile``, its device µs by kernel; and their sums by
    bucket."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    rows, sums = [], {}
    for b in (1, 32):
        for k, n in cs.VGG_HEADS:
            x = torch.randn(b, k, generator=gen, device="cuda").to(dtype)
            w = torch.randn(k, n, generator=gen, device="cuda") * math.sqrt(2.0 / k)
            q, s = im.quantize_int8(w)
            q, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
            _, ratio, _ = cs.check_int8(im, x, q, s)
            wf = (q.float() * s).to(dtype)
            row = {"b": b, "k": k, "n": n, "err_over_tol": ratio,
                   "kernel_device_ms": cs.graph_ms(lambda: im.int8_matmul(x, q, s)),
                   "kernel_ms": cs.time_ms(lambda: im.int8_matmul(x, q, s)),
                   "library_device_ms": cs.graph_ms(lambda: torch.matmul(x, wf)),
                   "library_ms": cs.time_ms(lambda: torch.matmul(x, wf))}
            row["bound_ms"], row["bound_by"], _, _ = cs.int8_bound(b, k, n, x.dtype)
            if profile:
                row["by_kernel_us"] = by_kernel(lambda: im.int8_matmul(x, q, s))
                print(f"int8_matmul B {b} K {k} N {n}: device µs by kernel "
                      f"{ {p: round(v, 2) for p, v in row['by_kernel_us'].items()} }", flush=True)
            rows.append(row)
            acc = sums.setdefault(b, {})
            for key in ("kernel_device_ms", "kernel_ms", "library_device_ms", "library_ms",
                        "bound_ms"):
                acc[key] = acc.get(key, 0.0) + row[key]
            print(f"int8_matmul B {b} K {k} N {n} {str(dtype)[6:]}: device only (CUDA graph) "
                  f"{row['kernel_device_ms']:.4f} ms (events {row['kernel_ms']:.4f}); library "
                  f"{row['library_device_ms']:.4f} ({row['library_ms']:.4f}); bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']}); err/tol {ratio:.3g}", flush=True)
    for b, acc in sums.items():
        print(f"int8_matmul VGG16 heads B {b}: device only {acc['kernel_device_ms']:.4f} ms "
              f"(events {acc['kernel_ms']:.4f}); library {acc['library_device_ms']:.4f} "
              f"({acc['library_ms']:.4f}); bound {acc['bound_ms']:.4f}", flush=True)
    return rows, sums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the tree whose package is timed")
    ap.add_argument("--label", default="", help="a name for the output file")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="x's type (float32: the VGG16 path)")
    ap.add_argument("--times-only", action="store_true",
                    help="do not fail when the kernel misses the plain version")
    ap.add_argument("--profile", action="store_true",
                    help="also print each head's device time by kernel")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_int8_times: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.ops import int8_matmul as im

    if not os.path.abspath(im.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {im.__file__}, not the package under {root}")
    card = cs.smi_line()
    print(f"int8 matmul times of {root}: {card}", flush=True)
    rows, sums = head_times(cs, im, getattr(torch, args.dtype), args.profile)
    if not args.times_only and any(r["err_over_tol"] > 1 for r in rows):
        raise AssertionError(f"int8_matmul disagrees with its plain version: {rows}")
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"int8_times{'_' + args.label if args.label else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump({"card": card, "root": root, "rows": rows, "summary": sums}, f, indent=1)
    print(card)
    print(json.dumps({"root": root, "summary": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
