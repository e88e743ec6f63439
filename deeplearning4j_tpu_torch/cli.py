"""Command-line entry point of the port: ``serve``.

Counterpart of the ``serve`` subcommand of ``deeplearning4j_tpu/cli.py``
(``serve_main``)::

    python -m deeplearning4j_tpu_torch.cli serve --model <zoo name | ckpt.zip | ckpt dir> \\
        --port 8080 --batch-limit 32 --max-wait-ms 5 [--int8-serving] [--device cpu] \\
        [--seq-buckets 8,16,32,64] [--gen-slots N --gen-max-length L \\
         --gen-prefill-buckets ... --gen-queue-limit Q]

A zoo name serves fresh seeded weights; a checkpoint zip or directory (its
newest valid zip, also the ``/reload`` source) serves the checkpoint. A zoo
model's ``serving_seq_buckets`` hint pads rank-3 requests along time unless
``--seq-buckets`` is given. ``--gen-slots N`` adds ``POST /generate`` with N
continuous-batching decode slots (a recurrent network). ``--smoke`` sends
one request through the HTTP stack (and one greedy ``/generate`` with
``--gen-slots``), prints ``smoke: HTTP 200 ok`` and exits 0 (1 on failure).
The model runs on the CUDA card unless ``--device cpu`` is given. The
reference's other subcommands (training, data, chaos, ...) and the serve
flags for the mesh, workers, speculative decoding, the prefix cache, the
registry and the controllers come with later slices (ROADMAP § A) and are
refused.
"""

from __future__ import annotations

import argparse
import sys

#: serve flags of the reference that later slices bring
_NOT_PORTED_FLAGS = {
    "--mesh": "the serving mesh (ROADMAP § A, slice 7)",
    "--mesh-policy": "the serving mesh (ROADMAP § A, slice 7)",
    "--cpu-mesh": "the serving mesh (ROADMAP § A, slice 7)",
    "--workers": "data-parallel serving (ROADMAP § A, slice 4)",
    "--spec-decode-k": "speculative decoding (ROADMAP § A, slice 6)",
    "--spec-draft-mode": "speculative decoding (ROADMAP § A, slice 6)",
    "--prefix-cache-mb": "the shared-prefix cache (ROADMAP § A, slice 6)",
    "--registry-dir": "the model registry (ROADMAP § A, slice 8)",
    "--canary-fraction": "the model registry (ROADMAP § A, slice 8)",
    "--canary-window": "the model registry (ROADMAP § A, slice 8)",
    "--tenant-quota": "the model registry (ROADMAP § A, slice 8)",
    "--max-live-models": "the model registry (ROADMAP § A, slice 8)",
    "--cluster": "the replica cluster (ROADMAP § A, slice 8)",
    "--replica-id": "the replica cluster (ROADMAP § A, slice 8)",
    "--heartbeat-s": "the replica cluster (ROADMAP § A, slice 8)",
    "--lease-ttl-s": "the replica cluster (ROADMAP § A, slice 8)",
    "--global-tenant-quota": "the replica cluster (ROADMAP § A, slice 8)",
    "--controllers": "the adaptive-capacity controllers (ROADMAP § A, slice 8)",
}


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch serve",
        description="Serve a model over HTTP: bucketed dynamic batching, "
                    "warmup, backpressure, hot reload")
    ap.add_argument("--model", required=True,
                    help="zoo model name (fresh seeded weights), checkpoint "
                         "zip, or checkpoint DIRECTORY (newest valid; also the "
                         "/reload source)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default the CUDA card; 'cpu' "
                         "for the CPU)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port (printed at startup)")
    ap.add_argument("--batch-limit", type=int, default=32,
                    help="max examples per device dispatch")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="dispatch deadline: a non-full batch waits at most "
                         "this long for co-travelers")
    ap.add_argument("--queue-limit", type=int, default=256,
                    help="bounded request queue; beyond it requests are "
                         "rejected 503 (backpressure)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated batch-size buckets (default: "
                         "powers of two up to --batch-limit)")
    ap.add_argument("--seq-buckets", default=None,
                    help="comma-separated sequence-length buckets for rank-3 "
                         "inputs (default: the zoo model's serving_seq_buckets "
                         "hint, if any)")
    ap.add_argument("--gen-slots", type=int, default=0,
                    help="enable POST /generate with this many continuous-"
                         "batching decode slots (0 = off); the model must be "
                         "a recurrent network")
    ap.add_argument("--gen-max-length", type=int, default=None,
                    help="generation window per request (default 256): "
                         "prompt + max_new must fit it")
    ap.add_argument("--gen-prefill-buckets", default=None,
                    help="comma-separated prompt-length buckets for prefill "
                         "padding (default: powers of two from 8)")
    ap.add_argument("--gen-queue-limit", type=int, default=64,
                    help="bounded generation queue; beyond it requests are "
                         "rejected 503 (backpressure)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="explicit /reload source (default: --model when it "
                         "is a directory)")
    ap.add_argument("--num-classes", type=int, default=10,
                    help="zoo-name models only: output classes")
    ap.add_argument("--int8-serving", action="store_true",
                    help="serve int8 weight-quantized dense/output heads "
                         "(per-channel scales; the model's f32 weights are "
                         "untouched; refused when the zoo model's "
                         "serving_int8 hint is False)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running every bucket shape at startup")
    ap.add_argument("--smoke", action="store_true",
                    help="serve ONE local request through the HTTP stack, "
                         "print the result, shut down")
    return ap


def _refuse_not_ported(ap: argparse.ArgumentParser, argv) -> None:
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED_FLAGS:
            ap.error(f"{flag}: {_NOT_PORTED_FLAGS[flag]} is not ported yet")


def serve_main(argv) -> int:
    """``serve``: zoo model or checkpoint -> warmed bucketed engine -> HTTP."""
    ap = _serve_parser()
    _refuse_not_ported(ap, argv)
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.models.selector import ZOO, ModelSelector
    from deeplearning4j_tpu_torch.obs.metrics import default_registry
    from deeplearning4j_tpu_torch.serving import (
        BucketPolicy,
        InferenceEngine,
        InferenceServer,
        ServingMetrics,
    )

    batch_buckets = (None if args.buckets is None
                     else [int(b) for b in args.buckets.split(",")])
    seq_buckets = (None if args.seq_buckets is None
                   else [int(t) for t in args.seq_buckets.split(",")])
    key = args.model.lower()
    if key in ZOO and seq_buckets is None:
        seq_buckets = ZOO[key].serving_seq_buckets
    buckets = BucketPolicy(batch_buckets=batch_buckets, max_batch=args.batch_limit,
                           seq_buckets=seq_buckets)
    eng_kwargs = dict(buckets=buckets, device=args.device,
                      metrics=ServingMetrics(registry=default_registry()))
    if args.int8_serving:
        if key in ZOO and not getattr(ZOO[key], "serving_int8", True):
            ap.error(f"--int8-serving: zoo model {key!r} declares "
                     "serving_int8=False (its heads do not tolerate weight "
                     "quantization)")
        eng_kwargs["int8_serving"] = True
    if args.checkpoint_dir:
        eng_kwargs["checkpoint_dir"] = args.checkpoint_dir
    if key in ZOO:
        model, origin = ModelSelector.load_or_init(
            args.model, device=args.device, num_classes=args.num_classes)
        engine = InferenceEngine(model, **eng_kwargs)
    else:
        engine = InferenceEngine.from_checkpoint(args.model, **eng_kwargs)
        origin = engine.describe()["source"]
    print(f"serving {type(engine.model).__name__} from {origin} on {engine.device} "
          f"({engine.buckets!r}"
          + (f", int8 heads {engine.int8_report}" if engine.int8_serving else "")
          + ")", flush=True)
    if not args.no_warmup:
        rep = engine.warmup()
        print(f"warmup: {rep['shapes']} shapes, {rep['seconds']}s", flush=True)

    generation = None
    if args.gen_slots > 0:
        generation = _generation_engine(args, engine.model, default_registry())
    server = InferenceServer(engine, host=args.host, port=args.port,
                             batch_limit=args.batch_limit,
                             max_wait_ms=args.max_wait_ms,
                             queue_limit=args.queue_limit, generation=generation)
    print(f"listening on http://{args.host}:{server.port} "
          "(POST /predict, /predict_npy"
          + (", /generate" if generation is not None else "")
          + ", /reload; GET /healthz, /metrics)", flush=True)
    if args.smoke:
        return _smoke(args, server, engine)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (draining queue)", flush=True)
    finally:
        server.shutdown()
    return 0


def _generation_engine(args, model, registry):
    """The ``--gen-slots`` engine, warmed unless ``--no-warmup``; None (and
    a printed reason) for a model without an incremental-decode path."""
    from deeplearning4j_tpu_torch.serving.generate import GenerationEngine
    from deeplearning4j_tpu_torch.serving.metrics import GenerationMetrics

    gen_buckets = (None if args.gen_prefill_buckets is None
                   else [int(t) for t in args.gen_prefill_buckets.split(",")])
    try:
        generation = GenerationEngine(
            model, n_slots=args.gen_slots, max_length=args.gen_max_length,
            prefill_buckets=gen_buckets, queue_limit=args.gen_queue_limit,
            metrics=GenerationMetrics(registry=registry))
    except TypeError as e:  # no incremental-decode path: /predict still serves
        print(f"generation disabled: {e}", flush=True)
        return None
    if not args.no_warmup:
        rep = generation.warmup()
        print(f"generation warmup: buckets {rep['buckets']}, {rep['seconds']}s",
              flush=True)
    print(f"generation: {generation.n_slots} slots x max_length "
          f"{generation.max_length} ({generation.backend.kind} backend, "
          f"{generation.memory_report['cache_bytes']:,} cache bytes)", flush=True)
    return generation


def _post(args, server, path, payload):
    import http.client
    import json

    conn = http.client.HTTPConnection(args.host, server.port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(payload))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _smoke(args, server, engine) -> int:
    import numpy as np

    shape = engine.example_shape() or (1,)
    server.start()
    try:
        code, body = _post(args, server, "/predict",
                           {"inputs": np.zeros((1,) + tuple(shape), np.float32).tolist()})
        ok = code == 200 and "outputs" in body
        print(f"smoke: HTTP {code} {'ok' if ok else body}", flush=True)
        if ok and server.generation is not None:
            code, body = _post(args, server, "/generate",
                               {"prompt": [0, 1, 2], "max_new": 4, "stream": False})
            ok = code == 200 and len(body.get("tokens", ())) == 4
            print(f"smoke: generate HTTP {code} {'ok' if ok else body}"
                  + (f" tokens {body['tokens']}" if ok else ""), flush=True)
    finally:
        server.shutdown()
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve"]:
        return serve_main(argv[1:])
    print("usage: python -m deeplearning4j_tpu_torch.cli serve --model ... "
          "(the reference's other subcommands are not ported yet: ROADMAP § A)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
