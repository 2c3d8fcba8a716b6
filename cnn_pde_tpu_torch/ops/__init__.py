"""L1 ops: tridiagonal solves and their adjoint, ADI sweeps, and the five
CUDA kernels' wrappers (K1, K3 in ``tridiag``; K2 in ``fused_channel``; K4,
K5 in ``fused_channel_vjp``)."""

from .adi import sweep_last_axis, sweep_x, sweep_y
from .fused_channel import (fused_channel_diffusion_fwd,
                            fused_channel_diffusion_plain)
from .fused_channel_vjp import fused_channel_diffusion
from .kernels import plain_versions
from .tridiag import (tridiag_adjoint, tridiag_solve, tridiag_solve_pcr,
                      tridiag_solve_plain)

__all__ = ["sweep_last_axis", "sweep_x", "sweep_y",
           "fused_channel_diffusion", "fused_channel_diffusion_fwd",
           "fused_channel_diffusion_plain", "plain_versions",
           "tridiag_adjoint", "tridiag_solve", "tridiag_solve_pcr",
           "tridiag_solve_plain"]
