"""Serving CLI of the port — counterpart of ``cnn_pde_tpu/serve_cli.py``.

    python -m cnn_pde_tpu_torch.serve --preset cifar10_noconv \
        [--torch-checkpoint model.pth | --checkpoint-dir DIR [--tag best]] \
        [--input batch.npy] [--amp] [--device cuda]

Runs on the card unless ``--device cpu`` is given; without CUDA it exits
non-zero rather than carry on on the CPU.  With no ``--input`` it predicts on
the JAX CLI's smoke batch and prints the same summary line.
``--checkpoint-dir`` serves the model weights of a checkpoint that the
train CLI wrote there (``--tag best`` or ``last``).  ``--amp``
serves the bf16 AMP grade (``pde.enable_amp``) with every hoisted layer's
sweep operators built once and pinned (``serve.cache_hoisted_operators``);
``amp_cached_layers`` counts them, and a line on stderr says how the
device applies them (``ops/tridiag.py::gemm_route``).
"""

from __future__ import annotations

import argparse
import json
import sys


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
    ap.add_argument("--batch-size", type=int, default=8,
                    help="smoke batch size when no --input is given")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 sweep operators (pde.enable_amp), built "
                         "once and pinned for frozen-weights serving")
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
    from .serve import cache_hoisted_operators, make_predict_fn
    from .train.checkpoint import model_state_dict

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("cnn_pde_tpu_torch.serve: no CUDA device is available; "
                 "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"cnn_pde_tpu_torch.serve: unsupported device {device}")

    preset = get_preset(args.preset)
    channels, size, _ = SYNTHETIC_SPECS[preset["dataset"]]
    model = build_model(preset["model"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        **preset["model_kwargs"])
    restored = False
    if args.torch_checkpoint and args.checkpoint_dir:
        sys.exit("cnn_pde_tpu_torch.serve: pass --torch-checkpoint or "
                 "--checkpoint-dir, not both")
    if args.torch_checkpoint:
        model.load_state_dict(load_torch_checkpoint(args.torch_checkpoint),
                              strict=True)
        restored = True
    if args.checkpoint_dir:
        model.load_state_dict(model_state_dict(args.checkpoint_dir,
                                               args.tag), strict=True)
        restored = True

    if args.input:
        images = np.load(args.input).astype(np.float32)
    else:
        images = np.random.default_rng(0).random(
            (args.batch_size, channels, size, size)).astype(np.float32)

    n_cached = 0
    if args.amp:
        enable_amp(model)
        n_cached = cache_hoisted_operators(model)
        # the summary's keys are the JAX CLI's; the route goes to stderr
        print(f"amp: {n_cached} layers, bf16 GEMM route "
              f"{gemm_route(torch.bfloat16, device)}", file=sys.stderr)

    predict = make_predict_fn(model, output=args.output)
    out = predict(images).cpu().numpy()

    summary = {
        "preset": preset["name"],
        "restored": restored,
        "batch": int(images.shape[0]),
        "output": args.output,
        "amp_cached_layers": n_cached,
        "linearized_layers": 0,
        "linearize_grade": None,
        "devices": 1,
    }
    if args.output == "labels":
        summary["predictions"] = out.tolist()
    else:
        summary["shape"] = list(out.shape)
        summary["argmax"] = out.argmax(-1).tolist()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
