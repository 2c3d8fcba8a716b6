"""L1 ops: tridiagonal solves, ADI sweeps and the two CUDA kernels (K1, K2)."""

from .adi import sweep_last_axis, sweep_x, sweep_y
from .fused_channel import (fused_channel_diffusion_fwd,
                            fused_channel_diffusion_plain)
from .kernels import plain_versions
from .tridiag import tridiag_solve, tridiag_solve_pcr, tridiag_solve_plain

__all__ = ["sweep_last_axis", "sweep_x", "sweep_y",
           "fused_channel_diffusion_fwd", "fused_channel_diffusion_plain",
           "plain_versions", "tridiag_solve", "tridiag_solve_pcr",
           "tridiag_solve_plain"]
