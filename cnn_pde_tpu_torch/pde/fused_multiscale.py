"""Lockstep-merged multi-branch ADI evolution — port of
``cnn_pde_tpu/pde/fused_multiscale.py``.

The flagship's ``MultiScaleExtractor`` runs three Strang diffusion
branches one after the other: 17 step-triples, 51 sweeps a forward.  The
branches differ only in (dt, num_steps, dx, dy) and their fields, so here
all K branches evolve in lockstep over max(num_steps) steps of a stacked
state: 8 step-triples, 24 sweeps.  A branch whose steps have run out takes
exact identity steps (r = 0, so a = c = 0 and b = 1; no eps; an identity
mixing matrix), which leave its state as it was.  The parameters keep
their per-branch layout (``pde1``-``pde3``); this is an execution
strategy, chosen on the extractor (``models/cifar10_noconv.py``).

``fused_multiscale_evolve`` is the per-sweep lockstep: each sweep is one
``tridiag_solve`` over the stacked state, so one K1 launch on the card
(24 a forward) and one K3 launch in the backward.  The JAX function
stacks the state as (K, B, C, H, W) with coefficients (K, 1, C, H, W) and
transposes H and W around each y-sweep; K1 takes batch-free bands of
shape S and a right-hand side (*batch, *S), so here the state is
(B, K, C, H, W) with bands S = (K, C, H, W), and the y-sweeps solve along
H (``dim=-2``) in place.  The result is handed back in the JAX function's
(K, B, C, H, W) order.

``hoisted_lockstep_evolve`` is the lockstep on precomputed operators: the
identity padding goes into the operator stacks themselves (inactive steps
have X = I, exact in bf16), every sweep operator of the evolution is
built by one K1 launch for the x stack and one for the y stack from the
detached bands (``ops/tridiag.py::tridiag_inverse_operator``), and each of
the 24 sweeps is one GEMM (``ops/adi.py::apply_sweep``; the bands carry
the gradient, the operators none).  ``branch_mesh`` splits the branch
axis over a mesh axis (``parallel/branch_parallel.py``): each rank of the
axis evolves its own block of branches, with no collective inside the
evolution, and one all-gather hands every rank all of them.

The time tables (``lockstep_tables``) are tensors on the model's device,
built once by the extractor: a captured predict or train step reads no
host value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.adi import _neumann_b, apply_sweep, apply_sweep_y
from ..ops.tridiag import tridiag_inverse_operator, tridiag_solve

__all__ = ["fused_multiscale_evolve", "hoisted_lockstep_evolve",
           "lockstep_tables", "branch_block"]

_PARAMS = ("alpha_base", "alpha_time_coeff", "beta_base",
           "beta_time_coeff", "channel_mixing")


def _branch_time_tables(dts, steps_list, max_steps):
    """(K, max_steps, 3) substep times accumulated in float64 and the
    (K, max_steps) active mask, both float32, as the JAX function makes
    them; an exhausted branch's entries are 0."""
    K = len(dts)
    ts = np.zeros((K, max_steps, 3), np.float64)
    active = np.zeros((K, max_steps), np.float32)
    for k, (dt, S) in enumerate(zip(dts, steps_list)):
        t = 0.0
        for s in range(S):
            ts[k, s, 0] = t
            t += dt / 2
            ts[k, s, 1] = t
            t += dt / 2
            ts[k, s, 2] = t
            active[k, s] = 1.0
    return ts.astype(np.float32), active


def lockstep_tables(dts, steps_list, dxs, dys, device=None):
    """{'ts': (K, S, 3), 'active': (K, S), 'dtfac': (2, K)} as float32
    tensors on ``device``: the substep times, the active mask, and each
    branch's dt/2/dx² (x-sweeps) and dt/dy² (y-sweeps), each a Python
    float rounded once to float32, as the JAX function forms them."""
    ts, active = _branch_time_tables(dts, steps_list, max(steps_list))
    dtfac = [[dt / 2 / dx ** 2 for dt, dx in zip(dts, dxs)],
             [dt / dy ** 2 for dt, dy in zip(dts, dys)]]
    return {"ts": torch.tensor(ts, device=device),
            "active": torch.tensor(active, device=device),
            "dtfac": torch.tensor(dtfac, dtype=torch.float32,
                                  device=device)}


def _stack(branch_params, name):
    return torch.stack([p[name] for p in branch_params])


def _tables(tables, dts, steps_list, dxs, dys, device):
    if tables is None:
        tables = lockstep_tables(dts, steps_list, dxs, dys, device)
    return tables["ts"], tables["active"], tables["dtfac"]


def _mixed(mix_eff, U):
    """Each branch's channel mixing of the stacked state U (B, K, C, H, W)
    by ``mix_eff`` (K, C, C), as an f32 broadcast multiply-reduce (the
    JAX function's form)."""
    return (mix_eff[None, :, :, :, None, None] * U[:, :, None]).sum(dim=3)


def _coeff(base, time_coeff, t, eps, clamp_max):
    """clamp(base + time_coeff·t, eps, clamp_max): the fields (…, C, H, W)
    at the times t, each time broadcast over a (C, H, W) field."""
    t = t.reshape(t.shape + (1, 1, 1))
    return (base + time_coeff * t).clamp(eps, clamp_max)


def _masked_sweep(U, coeff, dtfac, active, eps, dim, impl):
    """One implicit sweep of the stacked state U (B, K, C, H, W) along
    ``dim`` with per-branch fields (K, C, H, W): r = coeff·dtfac·active, so
    an inactive branch solves the identity system (a = c = 0, b = 1)."""
    scale = active.reshape(-1, 1, 1, 1)
    r = coeff * dtfac.reshape(-1, 1, 1, 1) * scale
    b = _neumann_b(r, dim) + eps * scale  # eps only on live systems
    return tridiag_solve(-r, b, -r, U, dim, impl=impl)


def fused_multiscale_evolve(u, branch_params, *, dts, steps_list, dxs, dys,
                            eps=1e-6, clamp_max=10.0, tables=None,
                            impl=None):
    """u: (B, C, H, W); ``branch_params``: K mappings with alpha_base,
    beta_base, alpha_time_coeff, beta_time_coeff (C, H, W) and
    channel_mixing (C, C).  Returns (K, B, C, H, W), each branch's
    evolution.  ``tables``: ``lockstep_tables`` on u's device (made here
    when None).  ``impl``: ``tridiag_solve``'s solver for every sweep
    (None: the global default)."""
    K = len(branch_params)
    B, C, H, W = u.shape
    ts, active, dtfac = _tables(tables, dts, steps_list, dxs, dys, u.device)
    ab, at, bb, bt, mix = (_stack(branch_params, n) for n in _PARAMS)
    eye = torch.eye(C, dtype=mix.dtype, device=mix.device)
    U = u[:, None].expand(B, K, C, H, W)
    for s in range(ts.shape[1]):
        t3, act = ts[:, s], active[:, s]
        a3 = act.reshape(K, 1, 1)
        U = _mixed(a3 * mix + (1 - a3) * eye, U)
        U = _masked_sweep(U, _coeff(ab, at, t3[:, 0], eps, clamp_max),
                          dtfac[0], act, eps, -1, impl)
        U = _masked_sweep(U, _coeff(bb, bt, t3[:, 1], eps, clamp_max),
                          dtfac[1], act, eps, -2, impl)
        U = _masked_sweep(U, _coeff(ab, at, t3[:, 2], eps, clamp_max),
                          dtfac[0], act, eps, -1, impl)
    return U.transpose(0, 1)


def branch_block(K, index, size):
    """[lo, hi) of the branches that rank ``index`` of an axis of ``size``
    evolves: blocks of ceil(K / size), the last ones short or empty."""
    per = -(-K // size)
    return min(index * per, K), min((index + 1) * per, K)


def _hoisted_bands(r, active, eps, dtype):
    """(a, b + eps·active, c, X) of stacked sweeps along the last axis; X
    from the detached bands at ``dtype``."""
    b = _neumann_b(r) + eps * active
    return -r, b, -r, tridiag_inverse_operator(-r, b, -r, dtype)


def _hoisted_local(u, ab, at, bb, bt, mix, ts, active, dtfac, eps,
                   clamp_max, operator_dtype):
    """The hoisted lockstep of the branches whose stacked parameters are
    given ((K, ...), K ≥ 1): (B, K, C, H, W)."""
    K = ab.shape[0]
    B, C, H, W = u.shape
    ts_s, act = ts.transpose(0, 1), active.transpose(0, 1)  # (S, K, .)
    eye = torch.eye(C, dtype=mix.dtype, device=mix.device)
    a4 = act[:, :, None, None]
    mix_eff = a4 * mix + (1.0 - a4) * eye                    # (S, K, C, C)

    def coeff(base, tc, t):
        # fields (K, C, H, W) at times t (S, K, n) -> (S, K, n, C, H, W)
        return _coeff(base[None, :, None], tc[None, :, None], t, eps,
                      clamp_max)

    # x-sweeps (solve axis W) at each step's t and t + dt; r = 0 on
    # inactive steps, where the gradients die at the mask
    act_x = act[:, :, None, None, None, None]
    alpha = coeff(ab, at, ts_s[:, :, 0::2])                  # (S,K,2,C,H,W)
    ox = _hoisted_bands(alpha * dtfac[0].reshape(1, K, 1, 1, 1, 1) * act_x,
                        act_x, eps, operator_dtype)
    # y-sweeps on the transposed fields (solve axis H)
    act_y = act[:, :, None, None, None]
    beta_t = coeff(bb, bt, ts_s[:, :, 1:2])[:, :, 0].transpose(-1, -2)
    oy = _hoisted_bands(beta_t * dtfac[1].reshape(1, K, 1, 1, 1) * act_y,
                        act_y, eps, operator_dtype)
    U = u[:, None].expand(B, K, C, H, W)
    for s in range(ts_s.shape[0]):
        U = _mixed(mix_eff[s], U)
        U = apply_sweep(tuple(t[s, :, 0] for t in ox), U)
        U = apply_sweep_y(tuple(t[s] for t in oy), U)
        U = apply_sweep(tuple(t[s, :, 1] for t in ox), U)
    return U


def hoisted_lockstep_evolve(u, branch_params, *, dts, steps_list, dxs, dys,
                            eps=1e-6, clamp_max=10.0,
                            operator_dtype=torch.float32, tables=None,
                            branch_mesh=None, branch_axis="model"):
    """All K branches' Strang evolutions in lockstep on precomputed sweep
    operators: 3·max(steps) stacked sweeps of the state (B, K, C, H, W).
    Returns (B, K, C, H, W).  ``tables``: ``lockstep_tables`` on u's
    device (made here when None).

    ``branch_mesh``: a mesh whose ``branch_axis`` splits the branch axis
    (``parallel/branch_parallel.py``): this rank evolves its block of
    ``branch_block`` branches (possibly none) and one all-gather over the
    axis hands it the others.  The gather's backward keeps this rank's
    block: every rank of the axis computes the same loss.  The branch
    parameters enter through one all-reduce of their gradient over the
    axis (``collectives.copy_to``), so each rank ends its backward with
    every branch's gradient, each counted once."""
    K = len(branch_params)
    ts, active, dtfac = _tables(tables, dts, steps_list, dxs, dys, u.device)
    stacks = [_stack(branch_params, n) for n in _PARAMS]
    if branch_mesh is None or branch_mesh.shape[branch_axis] == 1:
        return _hoisted_local(u, *stacks, ts, active, dtfac, eps, clamp_max,
                              operator_dtype)
    from ..parallel.branch_parallel import gather_branches, shared_branches

    _, index, size = branch_mesh.axis(branch_axis)
    lo, hi = branch_block(K, index, size)
    flat, shared = shared_branches(stacks, branch_mesh, branch_axis)
    B, C, H, W = u.shape
    per = -(-K // size)
    if hi > lo:
        block = [t[lo:hi] for t in shared]
        local = _hoisted_local(u, *block, ts[lo:hi], active[lo:hi],
                               dtfac[:, lo:hi], eps, clamp_max,
                               operator_dtype)
    else:
        local = u.new_zeros((B, 0, C, H, W))
    if hi - lo < per:  # equal blocks for the gather
        local = torch.cat([local, local.new_zeros(
            (B, per - (hi - lo), C, H, W))], dim=1)
    return gather_branches(local, flat, branch_mesh, branch_axis)[:, :K]
