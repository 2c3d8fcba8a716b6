"""Serving walk-through of the PyTorch port: predict, linearize, quantize,
export.

The serving ladder: a predict (one CUDA graph a batch size on the card) →
frozen-weights linearization (each PDE branch's whole evolution as ONE
matrix) → int8 W8A8 matrices → ``torch.export`` for deployment without
the model-building code (K1, K2 and K6 stay in the program as registered
ops).  It runs on the card unless given ``--device cpu``.

Usage: python examples/torch_03_serving.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.serve import (clear_linear_cache, export_model,
                                     linearize_pde_layers, load_exported,
                                     make_predict_fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # seeded weights; or load a checkpoint's state_dict
    model = build_model("cifar10_noconv", device=args.device,
                        generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).random((8, 3, 32, 32), np.float32)

    # 1. the predict (exact float32, the sequential PDE evolution)
    predict = make_predict_fn(model, output="labels")
    ref = predict(x).cpu().numpy()
    print("sequential predictions:", ref)

    # 2. linearized, int8-quantized serving (W8A8: about 1% logit error,
    #    the labels agree).  dtype=None for exact float32, torch.bfloat16
    #    for the AMP grade, "auto" to choose by the serving batch.  A
    #    predict made before a cache is pinned must be made again.
    n = linearize_pde_layers(model, x, dtype="int8")
    fast = make_predict_fn(model, output="labels")
    out = fast(x).cpu().numpy()
    print(f"linearized {n} PDE branches; int8 predictions:", out)
    assert (out == ref).all()

    # 3. export the (still linearized) forward and reload it without any
    #    model-building code in the loop
    blob = export_model(model, x)
    reloaded = load_exported(blob)
    print("exported", len(blob) // 1024, "KiB; reloaded logits shape",
          tuple(reloaded(x).shape))

    clear_linear_cache(model)  # unpin before any further training


if __name__ == "__main__":
    main()
