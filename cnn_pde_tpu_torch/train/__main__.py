"""Training CLI of the port — counterpart of ``cnn_pde_tpu/train/__main__.py``
for the ported presets.

    python -m cnn_pde_tpu_torch.train --preset cifar10_noconv --synthetic \\
        [--steps 20] [--batch-size 64] [--seed 0] [--amp] [--bf16-moments] \\
        [--init-from-torch model.pth] [--device cuda]

Runs on the card unless ``--device cpu`` is given; without CUDA it exits
non-zero rather than carry on on the CPU.  ``--synthetic`` is required: no
dataset loader is ported yet (ROADMAP.md A12).  ``--amp`` trains the bf16
AMP grade (``pde.enable_amp``: hoisted bf16 sweep operators); with
``--bf16-moments`` AdamW keeps its moments in bf16.  Prints one summary
JSON line: preset, steps, first and last loss, images/s, the ADI layers
``--amp`` switched and the GEMM route of their operators.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="cnn_pde_tpu_torch trainer")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic fixture dataset (required: "
                         "no real-data loader is ported yet)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default: the preset's")
    ap.add_argument("--steps", type=int, default=20,
                    help="train steps to run (a smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-from-torch", default=None, metavar="PTH",
                    help="warm-start from a reference model.state_dict() "
                         "checkpoint; the optimizer starts fresh")
    ap.add_argument("--amp", action="store_true",
                    help="pde.enable_amp: hoisted sweep operators in bf16, "
                         "applied with float32 accumulation")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="store AdamW's m and v in bf16 (float32 "
                         "arithmetic)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from ..compat import load_torch_checkpoint
    from ..data import make_synthetic
    from ..models import build_model
    from ..ops.tridiag import gemm_route
    from ..pde import enable_amp
    from ..presets import get_preset
    from .step import make_train_step, train_steps

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("cnn_pde_tpu_torch.train: no CUDA device is available; "
                 "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"cnn_pde_tpu_torch.train: unsupported device {device}")
    if not args.synthetic:
        sys.exit("cnn_pde_tpu_torch.train: pass --synthetic (no dataset "
                 "loader is ported yet: ROADMAP.md A12)")

    preset = get_preset(args.preset)
    values = preset["train"]
    batch_size = args.batch_size or values["batch_size"]
    images, labels, _, _ = make_synthetic(preset["dataset"])
    steps_per_epoch = max(images.shape[0] // batch_size, 1)
    model = build_model(preset["model"], device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        **preset["model_kwargs"])
    restored = False
    if args.init_from_torch:
        model.load_state_dict(load_torch_checkpoint(args.init_from_torch),
                              strict=True)
        restored = True
    amp_layers = enable_amp(model) if args.amp else 0
    generator = torch.Generator(device).manual_seed(args.seed)
    step = make_train_step(
        model, values, steps_per_epoch, generator,
        moment_dtype=torch.bfloat16 if args.bf16_moments else None)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    t0 = time.perf_counter()
    losses = train_steps(step, data, args.steps, batch_size, seed=args.seed)
    seconds = time.perf_counter() - t0  # train_steps ends in a host sync
    print(json.dumps({
        "preset": preset["name"],
        "device": str(device),
        "restored": restored,
        "batch_size": batch_size,
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "images_per_s": batch_size * args.steps / seconds,
        "amp_layers": amp_layers,
        "gemm_route": (gemm_route(torch.bfloat16, device) if args.amp
                       else None),
        "bf16_moments": args.bf16_moments,
    }))


if __name__ == "__main__":
    main()
