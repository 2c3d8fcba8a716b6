"""L1 ops: tridiagonal solves and their adjoint, the inverse-operator
solves of the AMP grade, coefficient smoothing, ADI sweeps (per-sweep and
hoisted), the explicit stencil steps (FTCS, the 5-point Laplacian), the
JAX package's plain tridiagonal oracles, and the eight CUDA kernels'
wrappers (K1, K3 in ``tridiag``; K2
in ``fused_channel``; K4, K5 in ``fused_channel_vjp``; K6 in
``fused_grayscale``; K7, K8 in ``fused_grayscale_vjp``)."""

from .adi import (apply_sweep, apply_sweep_y, sweep_last_axis, sweep_operator,
                  sweep_x, sweep_y)
from .fused_channel import (fused_channel_diffusion_fwd,
                            fused_channel_diffusion_plain)
from .fused_channel_vjp import fused_channel_diffusion
from .fused_grayscale import (fused_grayscale_diffusion_fwd,
                              fused_grayscale_diffusion_plain)
from .fused_grayscale_vjp import fused_grayscale_diffusion
from .kernels import plain_versions
from .smoothing import smooth3
from .stencil import ftcs_evolve, laplacian, laplacian_step
from .tridiag import (set_default_impl, thomas_solve_reference,
                      tridiag_adjoint, tridiag_inverse_operator,
                      tridiag_solve, tridiag_solve_pcr, tridiag_solve_plain,
                      tridiag_solve_precomputed, tridiag_solve_scan,
                      tridiag_solve_unrolled, tridiag_solve_with_operator)

__all__ = ["sweep_last_axis", "sweep_x", "sweep_y", "sweep_operator",
           "apply_sweep", "apply_sweep_y", "set_default_impl",
           "tridiag_inverse_operator", "tridiag_solve_precomputed",
           "tridiag_solve_with_operator",
           "fused_channel_diffusion", "fused_channel_diffusion_fwd",
           "fused_channel_diffusion_plain", "fused_grayscale_diffusion",
           "fused_grayscale_diffusion_fwd", "fused_grayscale_diffusion_plain",
           "plain_versions", "smooth3", "ftcs_evolve", "laplacian",
           "laplacian_step", "thomas_solve_reference", "tridiag_adjoint",
           "tridiag_solve", "tridiag_solve_pcr", "tridiag_solve_plain",
           "tridiag_solve_scan", "tridiag_solve_unrolled"]
