#!/usr/bin/env python3
"""Time the fused LSTM cell of one tree at TextGenerationLSTM's two cells.

Run from the repository root on a CUDA card::

    python3 scripts/torch_lstm_times.py                          # this checkout
    python3 scripts/torch_lstm_times.py --root DIR --label NAME  # another tree
    python3 scripts/torch_lstm_times.py --root DIR --generate    # and phase 7

At phase 2d's timed cases (f32, n_in 77 and 256, n 256, B 1, 8, 32 and 64,
GravesLSTM and without peepholes) it times ``fused_lstm_cell`` device only
(``chip_smoke.graph_ms``, CUDA-graph replay) and by CUDA events
(``chip_smoke.time_ms``), with the wrapper's host microseconds a call
(the least of five ``chip_smoke.host_us``), beside ``torch.lstm_cell`` on the same weights
(``chip_smoke.library_cell``, the cells without peepholes), and prints each
case and each step's sum over the two cells with the bound of phase 2d
(``chip_smoke.lstm_cost``). Each case is also held to the plain version in
f32 (``chip_smoke.lstm_tolerance``), and the run fails on a miss unless
``--times-only`` is given (for variants whose results are not meant to be
right). ``--generate`` then runs phase 7 (``chip_smoke.generation_phase``:
the 32-slot TextGenerationLSTM engine) and prints its tokens/s and median
decode-step ms. The timing code is this checkout's; only the package
``deeplearning4j_tpu_torch`` is imported from ``--root`` (its kernels are
built there), so two trees can be timed in turns in one call on one card.
Prints the card's name and power limit and, last, one JSON line of the step
sums; the rows go to ``chiprun_out/lstm_times[_NAME].json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell_times(cs, fl):
    """Rows of (B, n_in, peephole) with the kernel's and the library's
    device and event ms, the bound and the kernel's err/tol against the
    plain version in f32; and their sums over the two cells by (B,
    peephole)."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    rows, sums = [], {}
    for b in (1, 8, 32, 64):
        for pe in (False, True):
            for n_in in (cs.TEXTGEN_VOCAB, cs.LSTM_UNITS):
                args = cs.lstm_args(gen, b, n_in, cs.LSTM_UNITS, pe, cs.LSTM_DTYPES["f32"])
                with torch.inference_mode():
                    hk, ck = fl.fused_lstm_cell(*args)
                    (ho, co), (h32, c32) = cs.lstm_oracle(fl, args, hk.dtype)
                    ratio = max(float(((k_ - o_).abs() / cs.lstm_tolerance(r_, hk.dtype)).max())
                                for k_, o_, r_ in ((hk, ho, h32), (ck, co, c32)))
                    fns = {"kernel": lambda: fl.fused_lstm_cell(*args)}
                    if not pe:
                        fns["library"] = cs.library_cell(args)
                    row = {"b": b, "n_in": n_in, "peephole": pe, "err_over_tol": ratio}
                    for name, fn in fns.items():
                        row[f"{name}_device_ms"] = cs.graph_ms(fn)
                        row[f"{name}_ms"] = cs.time_ms(fn)
                    # the least of five: the card machine's host clock is noisy
                    row["kernel_host_us"] = min(cs.host_us(fns["kernel"]) for _ in range(5))
                row["bound_ms"], row["bound_by"] = cs.lstm_cost(args, hk.dtype)
                rows.append(row)
                acc = sums.setdefault(f"b{b}_{'peephole' if pe else 'plain'}", {})
                for key, v in row.items():
                    if key.endswith(("_ms", "_us")):
                        acc[key] = acc.get(key, 0.0) + v
                lib = (f"; torch.lstm_cell {row['library_device_ms']:.4f} "
                       f"({row['library_ms']:.4f})" if not pe else "")
                print(f"fused_lstm_cell B {b} n_in {n_in} {'peephole' if pe else 'plain'}: "
                      f"device only (CUDA graph) {row['kernel_device_ms']:.4f} ms (events "
                      f"{row['kernel_ms']:.4f}, host {row['kernel_host_us']:.1f} us a call){lib}; "
                      f"bound {row['bound_ms']:.5f} "
                      f"({row['bound_by']}); err/tol {ratio:.3g}", flush=True)
    for key, acc in sums.items():
        lib = (f"; torch.lstm_cell {acc['library_device_ms']:.4f} ({acc['library_ms']:.4f})"
               if "library_ms" in acc else "")
        print(f"fused_lstm_cell step {key} (2 cells): device only {acc['kernel_device_ms']:.4f} "
              f"ms (events {acc['kernel_ms']:.4f}, host {acc['kernel_host_us']:.1f} us){lib}; "
              f"bound {acc['bound_ms']:.5f}", flush=True)
    return rows, sums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the tree whose package is timed")
    ap.add_argument("--label", default="", help="a name for the output file")
    ap.add_argument("--times-only", action="store_true",
                    help="do not fail when the kernel misses the plain version")
    ap.add_argument("--generate", action="store_true",
                    help="also run phase 7 and print its tokens/s")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_lstm_times: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.nn.ops import fused_lstm as fl

    if not os.path.abspath(fl.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {fl.__file__}, not the package under {root}")
    card = cs.smi_line()
    print(f"fused LSTM cell times of {root}: {card}", flush=True)
    rows, sums = cell_times(cs, fl)
    if not args.times_only and any(r["err_over_tol"] > 1 for r in rows):
        raise AssertionError(f"fused_lstm_cell disagrees with its plain version: {rows}")
    out = {"card": card, "root": root, "rows": rows, "summary": sums}
    if args.generate:
        engine, _, _, _, gen = cs.generation_phase(fl, card)
        engine.shutdown()
        out["generation"] = {k: gen[k] for k in ("tokens_per_s", "median_decode_step_ms")
                             if k in gen}
        print(f"phase 7 of {root}: {out['generation']}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"lstm_times{'_' + args.label if args.label else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(card)
    print(json.dumps({"root": root, "summary": sums, "generation": out.get("generation")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
