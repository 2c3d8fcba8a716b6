"""Debugging and summary utilities of the port (``utils/debug.py`` and
``utils/summary.py`` of the JAX package)."""

from .debug import (annotate, check_chunk, check_step, nan_guard,
                    profile_trace, step_timer)
from .summary import format_summary, model_summary, param_group_counts

__all__ = ["annotate", "check_chunk", "check_step", "nan_guard",
           "profile_trace", "step_timer", "format_summary", "model_summary",
           "param_group_counts"]
