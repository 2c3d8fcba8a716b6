"""Training CLI of the port — counterpart of ``cnn_pde_tpu/train/__main__.py``.

    python -m cnn_pde_tpu_torch.train --preset cifar10_hybrid \\
        [--data-dir ./data | --synthetic] [--device-epoch] \\
        [--epochs N] [--steps N] [--batch-size B] [--grad-accum K] \\
        [--checkpoint-dir DIR [--checkpoint-every N] [--async-checkpoint] \\
         [--resume]] [--metrics-out run/metrics.jsonl] [--bn-refresh K] \\
        [--amp] [--bf16-moments] [--init-from-torch model.pth] [--seed 0] \\
        [--summary] [--debug-nans] [--native-loader] [--quiet] \\
        [--no-preemption-handler] [--dp] [--tp N] [--spatial N] \\
        [--device cuda]

Runs ``Trainer.fit`` on the card unless ``--device cpu`` is given; without
CUDA it exits non-zero rather than carry on on the CPU.  The dataset is
read from ``--data-dir`` in torchvision's layouts (``data/real.py``), or
is the synthetic fixture when its files are absent or with
``--synthetic``.  ``--device-epoch`` keeps the train split on the device
and replays a CUDA graph of the train step (``TrainConfig.device_epoch``;
on the CPU the same loop without a graph).  ``--steps`` caps the train
steps of each epoch, as in the JAX CLI.  SIGTERM or SIGINT stops the run
at the next eval boundary with a 'last' checkpoint (unless
``--no-preemption-handler``); ``--resume`` continues from it.  ``--amp``
trains the bf16 AMP grade (``pde.enable_amp``); ``--bf16-moments`` keeps
AdamW's moments in bf16.  ``--summary`` prints the per-subtree parameter
table; ``--debug-nans`` stops at the first step whose loss or gradients
are not finite, naming it (``utils/debug.py``).  ``--native-loader``
feeds the host loop from the C++ prefetching batcher (``native/``).
``--dp`` trains data-parallel over a process group, one process a device:
under torchrun (``torchrun --nproc_per_node=N -m cnn_pde_tpu_torch.train
--dp ...``), or, started alone, as a world of one over a local port
(NCCL on the card, gloo with ``--device cpu``); ``--batch-size`` is the
global batch, and only rank 0 prints.  ``--tp N`` shards the FC stacks
and the Ruthotto K over N devices (the mesh's 'model' axis,
``parallel/tensor_parallel.py``); ``--spatial N`` runs the emotion or
Tiny-ImageNet model's PDE evolution on H blocks over N devices
(``parallel/spatial_model.py``); either brings up the process group as
``--dp`` does, and the rest of the world is the 'data' axis.  Prints the
JAX CLI's
summary JSON line (preset, best_acc, wall_s, epochs, and bn_refresh_acc
or preempted when they apply) with the port's own keys beside: the
device, the dataset's source, the batch, the steps run, the first and
last epoch's mean loss, images/s, the ADI layers ``--amp`` switched and
their GEMM route.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="cnn_pde_tpu_torch trainer")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--synthetic", action="store_true",
                    help="force the synthetic fixture dataset")
    ap.add_argument("--data-dir", default="./data",
                    help="the dataset's files in torchvision's layout "
                         "(the synthetic fixture where they are absent)")
    ap.add_argument("--device-epoch", action="store_true",
                    help="keep the train split on the device and replay a "
                         "CUDA graph of the train step, one fetch of the "
                         "losses a chunk of epochs")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the preset's")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default: the preset's")
    ap.add_argument("--grad-accum", type=int, default=1, metavar="K",
                    help="average the gradients of K micro-batches into "
                         "each optimizer update (optax.MultiSteps)")
    ap.add_argument("--steps", type=int, default=None,
                    help="cap the train steps of each epoch (smoke runs)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-backend", default="pickle",
                    choices=["pickle", "orbax"],
                    help="'pickle' (torch.save); 'orbax' has no PyTorch "
                         "counterpart and is refused")
    ap.add_argument("--init-from-torch", default=None, metavar="PTH",
                    help="warm-start from a reference model.state_dict() "
                         "checkpoint; the optimizer starts fresh")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint-dir ('last' if present, "
                         "else 'best') and continue from the first "
                         "uncompleted epoch")
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="write checkpoints off the training thread")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="also save a rolling 'last' checkpoint every N "
                         "epochs")
    ap.add_argument("--no-preemption-handler", action="store_true",
                    help="do not catch SIGTERM/SIGINT for a checkpointed "
                         "stop at the next eval boundary")
    ap.add_argument("--metrics-out", default=None,
                    help="stream the epoch records to this path (.jsonl, "
                         ".csv; a directory means TensorBoard)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bn-refresh", type=int, default=0, metavar="K",
                    help="after training, recompute the BatchNorm statistics "
                         "with K precise-BN passes under the best "
                         "checkpoint's weights (or the final ones) and "
                         "evaluate again")
    ap.add_argument("--amp", action="store_true",
                    help="pde.enable_amp: hoisted sweep operators in bf16, "
                         "bf16 convolutions and Ruthotto products")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="store AdamW's m and v in bf16 (float32 "
                         "arithmetic)")
    ap.add_argument("--summary", action="store_true",
                    help="print the per-subtree parameter table before "
                         "training")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise at the first step whose loss or gradients "
                         "are not finite, naming it (one host sync a step; "
                         "a chunk with --device-epoch)")
    ap.add_argument("--native-loader", action="store_true",
                    help="use the C++ prefetching batcher")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over a process group, one process "
                         "a device (torchrun, or a world of one)")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel the FC stacks and the Ruthotto K "
                         "over N devices (Megatron column/row over the "
                         "mesh's 'model' axis); the remaining devices form "
                         "the 'data' axis, so --tp composes with --dp")
    ap.add_argument("--spatial", type=int, default=1, metavar="N",
                    help="shard the PDE feature map's H axis over N "
                         "devices (halo exchange a stencil step); for the "
                         "presets with large maps: emotion (48x48 FTCS) "
                         "and tiny_imagenet (64x64 Laplacian); the "
                         "remaining devices form the 'data' axis; "
                         "weights and checkpoints interchange with the "
                         "unsharded model")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from ..compat import load_torch_checkpoint
    from ..data import load_dataset, synthetic_dataset
    from ..models import build_model
    from ..ops.tridiag import gemm_route
    from ..pde import enable_amp
    from ..presets import SYNTHETIC_SPECS, get_preset
    from ..utils.summary import format_summary, model_summary
    from .checkpoint import restore_state, save_checkpoint
    from .loop import (GracefulPreemption, TrainConfig, Trainer,
                       pde_param_stats)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("cnn_pde_tpu_torch.train: no CUDA device is available; "
                 "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"cnn_pde_tpu_torch.train: unsupported device {device}")
    if args.checkpoint_backend != "pickle":
        sys.exit(f"cnn_pde_tpu_torch.train: checkpoint backend "
                 f"{args.checkpoint_backend!r} has no PyTorch counterpart; "
                 "use 'pickle' (torch.save)")
    verbose = not args.quiet
    mesh = None
    if args.dp or args.tp > 1 or args.spatial > 1:
        mesh = _dp_mesh(device, args.tp, args.spatial)
        device = mesh.device
        verbose = verbose and mesh.rank == 0
        if verbose:
            print(f"Mesh: data={mesh.shape['data']}"
                  f" x spatial={mesh.shape['spatial']}"
                  f" x model={mesh.shape['model']} ({mesh.size} devices)")
    leader = mesh is None or mesh.rank == 0

    preset = get_preset(args.preset)
    values = preset["train"]
    dataset = (synthetic_dataset(preset["dataset"]) if args.synthetic else
               load_dataset(preset["dataset"], args.data_dir,
                            synthetic_ok=True))
    epochs = args.epochs or values["epochs"]
    batch_size = args.batch_size or values["batch_size"]
    steps_per_epoch = dataset.steps_for_batch(batch_size)
    if args.steps:
        steps_per_epoch = min(steps_per_epoch, args.steps)
    if verbose:
        print(f"Preset: {preset['name']}  device: {device}")
        print(f"Dataset: {preset['dataset']} ({dataset.source}), train "
              f"{dataset.train_images.shape}, test "
              f"{dataset.test_images.shape}")

    generator = torch.Generator().manual_seed(args.seed)
    image_spec = None
    if args.spatial > 1:
        model = _spatial_model(preset, mesh, device, generator)
        image_spec = ("data", None, "spatial", None)
    else:
        model = build_model(preset["model"], device=device,
                            generator=generator, **preset["model_kwargs"])
    if verbose or args.summary:
        # the reference prints the parameter totals and the PDE groups'
        # share at the start (cifar10.py:413-420, SVHN.py:310); a spatial
        # model's are its unsharded counterpart's
        channels, size, _ = SYNTHETIC_SPECS[preset["dataset"]]
        summ = model_summary(
            model if image_spec is None else build_model(
                preset["model"], device="cpu", **preset["model_kwargs"]),
            (batch_size, channels, size, size))
        pct = 100.0 * summ["pde_params"] / max(summ["total_params"], 1)
        print(f"Model: {summ['total_params']:,} parameters (PDE groups "
              f"{summ['pde_params']:,} = {pct:.1f}%)")
        if args.summary:
            print(format_summary(summ))
    restored = False
    if args.init_from_torch:
        model.load_state_dict(load_torch_checkpoint(args.init_from_torch),
                              strict=True)
        restored = True
    amp_layers = enable_amp(model) if args.amp else 0
    config = TrainConfig.from_preset(
        values, epochs=epochs, batch_size=batch_size, seed=args.seed,
        grad_accum=args.grad_accum, max_steps_per_epoch=args.steps,
        moment_dtype=torch.bfloat16 if args.bf16_moments else None,
        device_epoch=args.device_epoch, debug_nans=args.debug_nans,
        native_loader=args.native_loader)
    trainer = Trainer(model, config, values, mesh=mesh, tp=args.tp > 1,
                      image_spec=image_spec)
    state = trainer.init_state(steps_per_epoch)
    if args.resume and args.checkpoint_dir:
        tag = ("last" if os.path.exists(
            os.path.join(args.checkpoint_dir, "last.ckpt")) else "best")
        restore_state(state, args.checkpoint_dir, tag=tag)
        restored = True
        if verbose:
            print(f"Resumed from step {state.step} ({tag} checkpoint)")
    start_step = state.step

    def stats_fn(model, epoch):
        for name, s in list(pde_param_stats(model).items())[:4]:
            print(f"  {name}: mean={s['mean']:.3f} std={s['std']:.3f} "
                  f"range=[{s['min']:.3f}, {s['max']:.3f}]")

    sink = None
    if args.metrics_out:
        from .sinks import sink_from_path

        sink = sink_from_path(args.metrics_out)
    t0 = time.time()
    preemption = (None if args.no_preemption_handler
                  else GracefulPreemption(verbose=verbose))
    try:
        if preemption is not None:
            preemption.__enter__()
        result = trainer.fit(state, dataset, verbose=verbose,
                             checkpoint_dir=args.checkpoint_dir,
                             checkpoint_async=args.async_checkpoint,
                             checkpoint_every=args.checkpoint_every,
                             param_stats_fn=stats_fn, metrics_sink=sink,
                             preemption=preemption)
    finally:
        if preemption is not None:
            preemption.__exit__()
        if sink is not None:
            sink.close()
    wall = time.time() - t0
    history = result["history"]
    train_s = sum(rec["time"] for rec in history)
    steps = state.step - start_step
    out = {
        "preset": preset["name"],
        "best_acc": result["best_acc"],
        "wall_s": round(wall, 2),
        "epochs": len(history),
        "device": str(device),
        "data": dataset.source,
        "device_epoch": args.device_epoch,
        "restored": restored,
        "batch_size": batch_size,
        "steps": steps,
        "first_loss": history[0]["loss"] if history else None,
        "last_loss": history[-1]["loss"] if history else None,
        "images_per_s": batch_size * steps / train_s if train_s else None,
        "amp_layers": amp_layers,
        "gemm_route": (gemm_route(torch.bfloat16, device) if args.amp
                       else None),
        "bf16_moments": args.bf16_moments,
        "native_loader": args.native_loader,
        "devices": mesh.size if mesh is not None else 1,
    }
    if args.bn_refresh and not result["preempted"]:
        # refresh the best model, which fit's best_acc describes; without a
        # checkpoint directory (or a 'best' in it), the final weights
        which = "final-epoch weights"
        if args.checkpoint_dir and os.path.exists(
                os.path.join(args.checkpoint_dir, "best.ckpt")):
            restore_state(state, args.checkpoint_dir, tag="best")
            which = "best checkpoint"
        trainer.refresh_bn_stats(state, dataset, batches=args.bn_refresh)
        refreshed = trainer.evaluate(state, dataset)["acc"]
        if verbose:
            print(f"BN refresh ({args.bn_refresh} passes, {which}): test "
                  f"acc {refreshed:.2f}%")
        out["bn_refresh_acc"] = round(refreshed, 2)
        # a sharded model's checkpoint is gathered by every rank
        if args.checkpoint_dir and (leader or args.tp > 1):
            save_checkpoint(args.checkpoint_dir, state, tag="bn_refreshed")
    if result["preempted"]:
        out["preempted"] = True
    if leader:
        print(json.dumps(out))
    if mesh is not None:
        torch.distributed.destroy_process_group()


def _spatial_model(preset, mesh, device, generator):
    """The preset's spatially sharded model (``--spatial``), initialised
    as ``build_model`` initialises the unsharded one."""
    from ..parallel import SpatialFTCSClassifier, SpatialTinyImageNetClassifier

    kwargs = preset["model_kwargs"]
    if preset["model"] == "emotion":
        model = SpatialFTCSClassifier(mesh, **kwargs)
    elif preset["model"] == "tiny_imagenet":
        model = SpatialTinyImageNetClassifier(mesh, **kwargs)
    else:
        sys.exit("--spatial supports the large-map presets only "
                 "(emotion, tiny_imagenet); the 28-32 px families have "
                 "nothing to shard")
    model.reset_parameters(generator)
    return model.to(device).eval()


def _dp_mesh(device, tp=1, spatial=1):
    """The mesh of ``--dp``/``--tp``/``--spatial``: the process group
    torchrun configured, or a world of this process alone over a free
    local port (NCCL on the card, gloo on the CPU); 'spatial' and 'model'
    of the given sizes, the rest of the world 'data'."""
    import socket

    import torch.distributed as dist

    from ..parallel import initialize, make_mesh

    backend = "nccl" if device.type == "cuda" else "gloo"
    if initialize(backend=backend) == "single_process":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                   backend=backend)
    world = dist.get_world_size()
    if tp < 1 or spatial < 1 or world % (tp * spatial):
        sys.exit(f"--tp {tp} x --spatial {spatial} must be >=1 and divide "
                 f"the number of processes ({world})")
    return make_mesh(spatial=spatial, model=tp, device=device.type)


if __name__ == "__main__":
    main()
