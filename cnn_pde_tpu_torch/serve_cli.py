"""Serving CLI of the port — counterpart of ``cnn_pde_tpu/serve_cli.py``.

    python -m cnn_pde_tpu_torch.serve --preset cifar10_noconv \
        [--torch-checkpoint model.pth | --checkpoint-dir DIR [--tag best]] \
        [--input batch.npy] [--amp] [--linearize [f32|bf16|int8|auto]] \
        [--export model.pt2] [--http PORT [--microbatch N] [--buckets ...]] \
        [--dp] [--device cuda]

Runs on the card unless ``--device cpu`` is given; without CUDA it exits
non-zero rather than carry on on the CPU.  With no ``--input`` it predicts on
the JAX CLI's smoke batch and prints the same summary line.

* ``--checkpoint-dir`` serves the model weights of a checkpoint that the
  train CLI wrote there (``--tag best`` or ``last``).
* ``--amp`` serves the bf16 AMP grade (``pde.enable_amp``) with every
  hoisted layer's sweep operators built once and pinned
  (``serve.cache_hoisted_operators``); ``amp_cached_layers`` counts them,
  and a line on stderr says how the device applies them
  (``ops/tridiag.py::gemm_route``).
* ``--linearize`` composes each linear PDE layer's whole evolution into one
  matrix (``serve.linearize_pde_layers``) at a grade: f32 (the bare
  flag), bf16, int8 or auto (``serve.select_linearize_grade`` for the
  largest bucket, or the batch).
* ``--export PATH`` writes the eval forward as a ``torch.export`` program
  (``serve.export_model``; reload it with ``serve.load_exported``).
* ``--http PORT`` serves POST /predict, GET /healthz and /metrics, and
  POST /reload (``serve_http.py``) until interrupted, every bucket of
  every output warmed first (``warmed_predict_fns``; on the card each
  bucket's CUDA graph is captured once and the three outputs share it);
  ``--microbatch N`` coalesces concurrent requests (``serve_batch.py``).
  A reload, and ``--reload-watch SECS`` on a changed checkpoint, builds a
  fresh model from the weight source, pins its caches again and warms its
  predicts before they are swapped in.

* ``--dp`` serves data-parallel in this process: one replica of the
  model a visible card (or the CPU with ``--device cpu``), each request's
  rows split into equal blocks over them (``make_predict_fn(mesh=)``); the
  one-shot request and the HTTP server both go through it, and every
  bucket must divide by the replicas.

The JAX ``--platform`` is ``--device`` here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def warmed_predict_fns(model, buckets, images, mesh=None):
    """The HTTP server's predict fns of ``model``, one an output, with every
    bucket (or ``images``' batch) run once before they take traffic: on the
    card that captures the model's graph of each, which the three outputs
    share.  The server's start and every reload call this.  ``mesh``: the
    fns serve over its replicas (``make_predict_fn(mesh=)``)."""
    import numpy as np

    from .serve import make_predict_fn

    fns = {o: make_predict_fn(model, output=o, buckets=buckets, mesh=mesh)
           for o in ("labels", "probs", "logits")}
    for fn in fns.values():
        for b in (buckets or (images.shape[0],)):
            reps = -(-b // images.shape[0])
            fn(np.concatenate([images] * reps)[:b])
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser(description="cnn_pde_tpu_torch serving")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--torch-checkpoint", default=None, metavar="PTH",
                    help="serve weights from a reference model.state_dict() "
                         "checkpoint; omit for a random-init smoke run")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve the weights of a checkpoint the train CLI "
                         "wrote in this directory")
    ap.add_argument("--tag", default="best", choices=["best", "last"],
                    help="which checkpoint of --checkpoint-dir")
    ap.add_argument("--input", default=None,
                    help=".npy batch (NCHW float32) to predict on")
    ap.add_argument("--output", default="labels",
                    choices=["labels", "probs", "logits"])
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write the eval forward as a torch.export program "
                         "to PATH")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="smoke/export batch size when no --input is given")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 sweep operators (pde.enable_amp), built "
                         "once and pinned for frozen-weights serving")
    ap.add_argument("--linearize", nargs="?", const="f32", default=None,
                    choices=["f32", "bf16", "int8", "auto"],
                    help="compose each linear PDE layer's whole evolution "
                         "into one matrix (serve.linearize_pde_layers) "
                         "stored at this grade: 'f32' (the bare flag) "
                         "exact, 'bf16' bf16 operands with a float32 "
                         "result, 'int8' W8A8, 'auto' "
                         "serve.select_linearize_grade for the largest "
                         "bucket (or the batch)")
    ap.add_argument("--linearize-bf16", action="store_true",
                    help="alias for --linearize bf16")
    ap.add_argument("--linearize-int8", action="store_true",
                    help="alias for --linearize int8")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP: POST /predict (.npy or JSON "
                         "batch), GET /healthz — blocks until Ctrl-C")
    ap.add_argument("--microbatch", type=int, default=0, metavar="N",
                    help="with --http: coalesce concurrent requests into "
                         "one predict call of up to N rows "
                         "(serve_batch.MicroBatcher)")
    ap.add_argument("--microbatch-wait-ms", type=float, default=2.0,
                    help="max added latency while waiting to coalesce")
    ap.add_argument("--microbatch-pipeline", type=int, default=2,
                    help="coalesced batches allowed in flight at once "
                         "(1 = serial)")
    ap.add_argument("--buckets", default=None, metavar="B1,B2,...",
                    help="pad request batches to these sizes (padded rows "
                         "sliced off; sizes above the largest run "
                         "unpadded), so a handful of CUDA graphs serves "
                         "every size; e.g. --buckets 1,8,32,64")
    ap.add_argument("--reload-watch", type=float, default=0.0,
                    metavar="SECS",
                    help="with --http: poll the weight source every SECS "
                         "and hot-swap on change; 0 = off, reload stays "
                         "available via POST /reload")
    ap.add_argument("--dp", action="store_true",
                    help="shard each request's rows over one replica a "
                         "visible device, in this process")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .compat import load_torch_checkpoint
    from .models import build_model
    from .ops.tridiag import gemm_route
    from .pde import enable_amp
    from .presets import SYNTHETIC_SPECS, get_preset
    from .serve import (cache_hoisted_operators, export_model,
                        linearize_pde_layers, make_eager_predict_fn,
                        make_predict_fn)
    from .train.checkpoint import model_state_dict

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("cnn_pde_tpu_torch.serve: no CUDA device is available; "
                 "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"cnn_pde_tpu_torch.serve: unsupported device {device}")
    if args.torch_checkpoint and args.checkpoint_dir:
        sys.exit("cnn_pde_tpu_torch.serve: pass --torch-checkpoint or "
                 "--checkpoint-dir, not both")

    preset = get_preset(args.preset)
    channels, size, _ = SYNTHETIC_SPECS[preset["dataset"]]
    if args.input:
        images = np.load(args.input).astype(np.float32)
    else:
        images = np.random.default_rng(0).random(
            (args.batch_size, channels, size, size)).astype(np.float32)
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    grade = args.linearize
    if args.linearize_int8:  # the aliases imply --linearize
        grade = "int8"
    elif args.linearize_bf16:
        grade = "bf16"
    lin_dtype = {"f32": None, "bf16": torch.bfloat16, "int8": "int8",
                 "auto": "auto", None: None}[grade]
    # 'auto' grades for the largest batch the server will run
    serve_batch = max(buckets) if buckets else int(images.shape[0])

    def load_model():
        """A fresh model on ``device`` with the weight source's weights,
        its frozen-weights caches pinned: (model, restored, operator
        caches, linearized layers)."""
        model = build_model(preset["model"], device=device,
                            generator=torch.Generator().manual_seed(0),
                            **preset["model_kwargs"])
        restored = False
        if args.torch_checkpoint:
            model.load_state_dict(
                load_torch_checkpoint(args.torch_checkpoint), strict=True)
            restored = True
        if args.checkpoint_dir:
            model.load_state_dict(model_state_dict(args.checkpoint_dir,
                                                   args.tag), strict=True)
            restored = True
        n_cached = n_linearized = 0
        if args.amp:
            enable_amp(model)
            n_cached = cache_hoisted_operators(model)
        if grade is not None:
            n_linearized = linearize_pde_layers(
                model, images, dtype=lin_dtype,
                serve_batch_size=serve_batch)
        return model, restored, n_cached, n_linearized

    mesh = None
    if args.dp:
        from .parallel import make_mesh

        mesh = make_mesh(device=device.type)
        data = mesh.shape["data"]
        bad = [b for b in (buckets or (images.shape[0],)) if b % data]
        if bad:
            sys.exit(f"--buckets {bad} not divisible by the 'data' axis "
                     f"size {data} (required for --dp batch sharding)")

    model, restored, n_cached, n_linearized = load_model()
    if args.amp:
        # the summary's keys are the JAX CLI's; the route goes to stderr
        print(f"amp: {n_cached} layers, bf16 GEMM route "
              f"{gemm_route(torch.bfloat16, device)}", file=sys.stderr)
    if args.export:
        export_model(model, images, args.export)

    if args.http is not None:
        from .serve_http import serve_http

        watch_paths = []
        if args.torch_checkpoint:
            watch_paths = [args.torch_checkpoint]
        elif args.checkpoint_dir:
            watch_paths = [os.path.join(args.checkpoint_dir,
                                        f"{args.tag}.ckpt")]
        serve_http(warmed_predict_fns(model, buckets, images, mesh),
                   port=args.http,
                   default_output=args.output,
                   microbatch=args.microbatch,
                   microbatch_wait_ms=args.microbatch_wait_ms,
                   microbatch_pipeline=args.microbatch_pipeline,
                   reload_fn=lambda: warmed_predict_fns(
                       load_model()[0], buckets, images, mesh),
                   reload_watch_paths=(watch_paths if args.reload_watch > 0
                                       else None),
                   reload_watch_interval=args.reload_watch)
        return

    # one request: eager (a captured predict would warm and capture a
    # graph to answer it), or through the replicas with --dp
    predict = (make_predict_fn(model, output=args.output, mesh=mesh)
               if mesh is not None else
               make_eager_predict_fn(model, output=args.output))
    out = predict(images).cpu().numpy()

    summary = {
        "preset": preset["name"],
        "restored": restored,
        "batch": int(images.shape[0]),
        "output": args.output,
        "amp_cached_layers": n_cached,
        "linearized_layers": n_linearized,
        "linearize_grade": grade,
        "devices": mesh.size if mesh is not None else 1,
    }
    if args.export:
        summary["exported"] = args.export
    if args.output == "labels":
        summary["predictions"] = out.tolist()
    else:
        summary["shape"] = list(out.shape)
        summary["argmax"] = out.argmax(-1).tolist()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
