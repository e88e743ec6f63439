#!/usr/bin/env python3
"""Where the training time goes: profile one of the PyTorch port's train steps.

Run from the repository root on a CUDA card::

    python3 scripts/torch_train_profile.py                        # ResNet-50
    python3 scripts/torch_train_profile.py --model transformerlm  # TransformerLM
    python3 scripts/torch_train_profile.py --model resnet50_zero1 # ParallelWrapper, ZeRO-1
    python3 scripts/torch_train_profile.py --steps-per-call 4     # + bundled steps

``resnet50`` builds the model of ``chip_smoke.py``'s phase 4 (full-width bf16
ResNet-50, 1000 classes, 224x224, fused bottlenecks, seeded random weights
with randomized BN, ``Nesterovs(chip_smoke.TRAIN_LR, 0.9)``), takes two
warm-up ``fit`` steps on one seeded batch of 32, then profiles five more.
``transformerlm`` builds phase 9's (``chip_smoke.LM_TRAIN_CONF``: GPT-2
small's shape, 32,000 tokens, bf16, ``Adam(3e-4)``; a seeded batch of 16 x
512) and profiles five calls of ``TransformerLM._make_step`` after a warm-up
call, and beside it, apart, the step's two halves (the loss and its
gradients; the Adam updates of the 16 param tensors) and its loss head (the
head's bf16 GEMM and ``token_nll``, forward and backward, on a seeded
activation of the same shape). ``resnet50_zero1`` builds phase 10's model
(the same ResNet-50 with ``Adam(chip_smoke.ADAM_LR)``) on a one-rank NCCL
``TrainingMesh`` and profiles the wrapper's ZeRO-1 step, and apart its parts:
the loss and gradients, the sharded update (flatten, ``reduce_scatter``,
the fused Adam, ``all_gather``, scatter back), of it the flatten of params
and gradients and the kernel alone; beside them the replicated step
(``all_reduce``, per-tensor eager Adam) and one ``ParallelWrapper.fit`` call
of one batch (the step plus the re-shard and gather of the updater state).
``--steps-per-call K`` (ResNet-50 and its ZeRO-1 step) adds, beside those,
a fit of K batches at ``steps_per_call`` K through the same entry point
(``ComputationGraph.fit``, or the ZeRO-1 ``ParallelWrapper``): one replay of
the bundle's captured CUDA graph (captured before the profile), its copies
of the stacked batch and the K steps' updater scalars, and the copies that
end a fit; its rows also give host and device ms per step. Each profile
uses ``torch.profiler`` (CPU +
CUDA activities) and prints host milliseconds per call, device busy
milliseconds, the device's idle share, device ops per call, the device time
by group of kernel names and the top entries; the full tables go to
``chiprun_out/train_profile[_transformerlm].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import chip_smoke  # noqa: E402  (the train phases' models, SEED, smi_line)
from torch_serve_profile import profile_calls  # noqa: E402


def resnet50_calls(k: int):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.updaters import Nesterovs

    model, _ = chip_smoke.resnet50(updater=Nesterovs(chip_smoke.TRAIN_LR, 0.9))
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    x = rng.standard_normal((chip_smoke.BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, chip_smoke.BATCH)]
    ds = DataSet(x, y)
    model.fit(ds)
    calls = {f"train step, batch {chip_smoke.BATCH}": lambda: model.fit(ds)}
    if k > 1:
        bundled, _ = chip_smoke.resnet50(updater=Nesterovs(chip_smoke.TRAIN_LR, 0.9))
        bundled.conf.global_conf.steps_per_call = k
        bundled.fit(ExistingDataSetIterator([ds] * k))  # captures the graph
        calls[f"bundled fit of {k} batches (one replay), batch {chip_smoke.BATCH}"] = \
            lambda: bundled.fit(ExistingDataSetIterator([ds] * k))
    return calls


def resnet50_zero1_calls(k: int):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import _as_multi
    from deeplearning4j_tpu_torch.nn.multilayer import apply_layer_updates
    from deeplearning4j_tpu_torch.nn.ops import fused_update as fu
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMesh, zero
    from deeplearning4j_tpu_torch.parallel.wrapper import _mean_over_ranks
    from deeplearning4j_tpu_torch.updaters import Adam

    mesh = TrainingMesh(workers=1, device="cuda")
    model, _ = chip_smoke.resnet50(updater=Adam(chip_smoke.ADAM_LR))
    rng = np.random.default_rng(chip_smoke.SEED + 10)
    x = rng.standard_normal((chip_smoke.BATCH, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, chip_smoke.BATCH)]
    ds = DataSet(x, y)
    pw = ParallelWrapper(model, mesh=mesh, sharded_update=True)
    pw.fit(ExistingDataSetIterator([ds]))
    step, layout = zero.make_sharded_train_step(model, mesh)
    impls = fu.resolve_group_impls(layout)
    names = model.layer_names
    layers = [model._layer(n) for n in names]
    batch = model._batch(_as_multi(ds))
    state = {"zopt": zero.shard_model_opt_state(model, layout, mesh)}

    def sharded_step():
        model.params_, state["zopt"], model.state_, model.score_ = step(state["zopt"], batch)
        model.iteration += 1

    _, _, grads = model._value_and_grad(*batch)
    p_list, g_list = [model.params_[n] for n in names], [grads[n] for n in names]
    o_list = [model.opt_state_[n] for n in names]
    (grp,) = layout.groups
    flat = [layout._flatten_group(grp, t) for t in (p_list, g_list)]
    m, v = (layout._flatten_group(grp, [{k: o[k][s] for k in o} for o in o_list])
            for s in ("m", "v"))
    alpha = grp.updater.alpha(2, 1, 0)

    def sharded_update():
        zero.apply_sharded_updates(layout, p_list, g_list, state["zopt"], 2, 1, 0,
                                   mesh=mesh, fused_impls=impls)

    def replicated_step():
        loss, new_state, g = _mean_over_ranks(mesh, *model._value_and_grad(*batch))
        apply_layer_updates(layers, p_list, [g[n] for n in names], o_list, 2, 1, 0)

    calls = {}
    if k > 1:
        bundled, _ = chip_smoke.resnet50(updater=Adam(chip_smoke.ADAM_LR))
        pk = ParallelWrapper(bundled, mesh=mesh, sharded_update=True, steps_per_call=k)
        pk.fit(ExistingDataSetIterator([ds] * k))  # captures the graph
        calls[f"bundled ParallelWrapper.fit of {k} batches (one replay), batch "
              f"{chip_smoke.BATCH}"] = lambda: pk.fit(ExistingDataSetIterator([ds] * k))
    return {**calls,
            f"ZeRO-1 step (the wrapper's sharded step), batch {chip_smoke.BATCH}": sharded_step,
            "  of it: loss and gradients": lambda: model._value_and_grad(*batch),
            "  of it: sharded update (flatten, reduce_scatter, fused Adam, all_gather, "
            "scatter)": sharded_update,
            "    of it: flatten of params and gradients (torch.cat)":
                lambda: [layout._flatten_group(grp, t) for t in (p_list, g_list)],
            "    of it: the fused Adam kernel": lambda: fu.fused_adam_apply(
                *flat, m, v, alpha, b1=0.9, b2=0.999, eps=1e-8),
            "replicated step (all_reduce, per-tensor eager Adam)": replicated_step,
            "ParallelWrapper.fit of one batch (step + re-shard + gather)":
                lambda: pw.fit(ExistingDataSetIterator([ds]))}


def transformer_calls(k: int):
    from deeplearning4j_tpu_torch.models import transformer_lm as tlm
    from deeplearning4j_tpu_torch.updaters import Adam

    model = tlm.TransformerLM(seed=chip_smoke.SEED, updater=Adam(chip_smoke.LM_TRAIN_LR),
                              **chip_smoke.LM_TRAIN_CONF).init()
    cfg = model.cfg
    b, t_len = chip_smoke.LM_TRAIN_BATCH
    rng = np.random.default_rng(chip_smoke.SEED + 71)
    ids, tgt = chip_smoke.lm_batch(rng, b, t_len, cfg.vocab_size)
    step = model._make_step()
    state = {"params": model.params_, "opt": model.opt_state_, "t": 0}

    def one_step():
        state["t"] += 1
        state["params"], state["opt"], _ = step(state["params"], state["opt"], ids, tgt,
                                                 state["t"])

    def loss_and_grads():
        return tlm.value_and_grad(lambda p: tlm.lm_loss(cfg, p, ids, tgt), state["params"])

    grads = loss_and_grads()[1]
    leaves = list(chip_smoke._flat(state["params"]))
    flat_g, flat_o = dict(chip_smoke._flat(grads)), dict(chip_smoke._flat(state["opt"]))
    slots = {name: {k: flat_o[f"{name}/{k}"] for k in ("m", "v")} for name, _ in leaves}

    def adam():
        with torch.no_grad():
            for name, p in leaves:
                update, _ = model.updater.apply(flat_g[name], slots[name], 1, 1, 0)
                p - update

    x = torch.randn(b, t_len, cfg.d_model, generator=torch.Generator().manual_seed(7)
                    ).to(device=ids.device, dtype=torch.bfloat16).requires_grad_()
    head = state["params"]["head"].detach().requires_grad_()

    def loss_head():
        loss = tlm.token_nll(x @ head.to(torch.bfloat16), tgt)[0]
        torch.autograd.grad(loss, (x, head))

    return {f"train step (_make_step), batch {b} x {t_len}": one_step,
            "  of it: loss and gradients (value_and_grad of lm_loss)": loss_and_grads,
            "  of it: Adam updates (16 param tensors)": adam,
            "  of it: loss head (bf16 logits GEMM + token_nll, fwd and bwd)": loss_head}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("resnet50", "transformerlm", "resnet50_zero1"),
                    default="resnet50")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="also profile a bundled fit of this many batches (ResNet-50)")
    args = ap.parse_args()
    if args.steps_per_call > 1 and args.model == "transformerlm":
        ap.error("--steps-per-call: TransformerLM.fit_batch does not bundle")
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.smi_line()
    calls = {"resnet50": resnet50_calls, "transformerlm": transformer_calls,
             "resnet50_zero1": resnet50_zero1_calls}[args.model](args.steps_per_call)
    out = {"card": card, "torch": torch.__version__}
    for label, fn in calls.items():
        r = profile_calls(fn, 5)
        out[label.strip()] = r
        print(f"{label}: host {r['host_ms']:.3f} ms/call, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_ops']:.0f} device ops/call; device ms by group "
              f"{ {g: round(us / 1e3, 3) for g, us in r['groups_us'].items() if us} }; "
              f"on {card}", flush=True)
        for row in r["top"][:15]:
            print(f"  {row['device_us']:10.1f} us  x{row['count']:6.1f}  "
                  f"{row['name'][:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "train_profile.json" if args.model == "resnet50" else \
        f"train_profile_{args.model}.json"
    if args.steps_per_call > 1:
        name = name.replace(".json", f"_k{args.steps_per_call}.json")
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
