"""Model summary — port of ``cnn_pde_tpu/utils/summary.py``: parameter
counts, the PDE groups' share, a per-subtree table and the output shape.

Shape-only, as the JAX ``jax.eval_shape`` summary is: the output shape
comes from a forward of a copy of the model on the meta device, through
the plain versions (``ops/kernels.py::plain_versions``), which computes
no value and launches nothing.  The port's parameter names are the
reference's ``state_dict`` names, and the PDE groups are chosen by the
same substrings, so the counts equal the JAX package's.
"""

from __future__ import annotations

import copy

import torch

from ..ops import kernels

__all__ = ["model_summary", "param_group_counts", "format_summary",
           "PDE_GROUP_SUBSTRINGS"]

# the substrings the grouped optimizer and the regulariser select by
PDE_GROUP_SUBSTRINGS = ("alpha", "beta", "channel_mixing",
                        "combination_weights", ".K.", "fourier")


def _in_group(name, s):
    return s in name or (s == ".K." and name.endswith(".K"))


def param_group_counts(model):
    """(total, pde_total, {substring: count}): the parameters of
    ``model``, those of the PDE groups, and each group's (groups with no
    parameter left out)."""
    total = pde_total = 0
    by_group = dict.fromkeys(PDE_GROUP_SUBSTRINGS, 0)
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        hit = [s for s in PDE_GROUP_SUBSTRINGS if _in_group(name, s)]
        if hit:
            pde_total += n
            for s in hit:
                by_group[s] += n
    return total, pde_total, {k: v for k, v in by_group.items() if v}


def model_summary(model, input_shape, *, train=False, depth=2):
    """Summary dict of ``model`` on NCHW ``input_shape`` (batch included):
    the shapes in and out, the parameter counts by PDE group, the
    BatchNorm statistics' entries (the JAX model state) and a table of the
    parameters under each dotted name prefix of ``depth`` parts."""
    meta = copy.deepcopy(model).to("meta").train(train)
    with torch.no_grad(), kernels.plain_versions():
        out = meta(torch.empty(tuple(input_shape), device="meta"))
    subtrees = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:depth])
        subtrees[key] = subtrees.get(key, 0) + p.numel()
    total, pde_total, groups = param_group_counts(model)
    state = sum(b.numel() for name, b in model.named_buffers()
                if name.endswith(("running_mean", "running_var")))
    return {
        "input_shape": tuple(input_shape),
        "output_shape": tuple(out.shape),
        "total_params": total,
        "pde_params": pde_total,
        "pde_groups": groups,
        "state_entries": state,
        "subtrees": list(subtrees.items()),
    }


def format_summary(s):
    """A ``model_summary`` dict as the printable table."""
    lines = [f"{'subtree':<40} {'params':>12}", "-" * 53]
    for name, n in s["subtrees"]:
        lines.append(f"{name:<40} {n:>12,}")
    lines.append("-" * 53)
    lines.append(f"{'total':<40} {s['total_params']:>12,}")
    pct = (100.0 * s["pde_params"] / s["total_params"]
           if s["total_params"] else 0.0)
    lines.append(f"{'PDE (grouped) params':<40} {s['pde_params']:>12,}"
                 f"  ({pct:.1f}% of total)")
    for g, n in s["pde_groups"].items():
        lines.append(f"  {g:<38} {n:>12,}")
    lines.append(f"input {s['input_shape']} -> output {s['output_shape']}; "
                 f"state entries {s['state_entries']:,}")
    return "\n".join(lines)
