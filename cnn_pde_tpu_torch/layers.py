"""The convolution of the port — counterpart of
``cnn_pde_tpu/nn/layers.py::Conv2d`` — in its two grades.

``Conv2d`` is a ``torch.nn.Conv2d`` (its state_dict key stays ``weight``)
with the JAX layer's ``compute_dtype``, in the form the ResNet uses: no
bias, groups 1, the kaiming_normal fan_out init:

* **None, the exact grade**: a float32 convolution that never takes TF32,
  in the forward or the backward, whatever the process's flags say.
  torch's default ``torch.backends.cudnn.allow_tf32 = True`` runs float32
  cuDNN convolutions on TF32 (a 10-bit mantissa, about 1e-3 relative),
  and a flag set around the forward alone would not reach the backward,
  which runs later inside ``loss.backward()``.  So the convolution is an
  autograd Function (``conv2d_exact``) whose forward runs
  ``aten.convolution`` and whose backward runs ``aten.convolution_backward``,
  each inside ``no_tf32()``, which clears cuDNN's TF32 flag for that call
  and restores the caller's value after it.
* **torch.bfloat16, the AMP grade** (set by ``pde.enable_amp``): the JAX
  semantics, ``conv2d(x.bfloat16(), w.bfloat16())`` with a bf16 output
  then cast to float32 (autocast's conv, not a product with a float32
  output).  Its plain version (``conv2d_bf16_plain``) is the exact float32
  convolution of the bf16-rounded operands with its output rounded to
  bf16: every product of two bf16 values is exact in float32, so it
  computes the same sums.  It runs on a CPU tensor and inside
  ``kernels.plain_versions()``; a CUDA tensor otherwise takes cuDNN's bf16
  convolution.

BatchNorm2d, max and average pooling are torch's own modules: cuDNN serves
them, as XLA computes them outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from .ops import kernels

__all__ = ["Conv2d", "conv2d_exact", "conv2d_bf16", "conv2d_bf16_plain",
           "no_tf32"]


@contextmanager
def no_tf32():
    """cuDNN's and cuBLAS's TF32 flags cleared for the block, the caller's
    values restored after it.  The flags are the process's: another
    thread's convolution or matmul inside the block runs without TF32 too.
    Both are the ``allow_tf32`` flags: torch refuses to read one API's
    setting after the other API has set it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class _ExactConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.conf = (stride, padding)
        ctx.save_for_backward(x, w)
        with no_tf32():
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, [1, 1], False, [0, 0], 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, [1, 1], False, [0, 0], 1,
                mask)
        return gx, gw, None, None


def conv2d_exact(x, w, stride=(1, 1), padding=(0, 0)):
    """NCHW convolution at the inputs' precision with TF32 off in the
    forward and the backward."""
    return _ExactConv.apply(x, w, list(stride), list(padding))


def conv2d_bf16_plain(x, w, stride=(1, 1), padding=(0, 0)):
    """The bf16 grade's plain version: the exact convolution of the
    bf16-rounded operands, its output rounded to bf16 and returned in
    float32."""
    bf16 = torch.bfloat16
    return conv2d_exact(x.to(bf16).float(), w.to(bf16).float(), stride,
                        padding).to(bf16).float()


def conv2d_bf16(x, w, stride=(1, 1), padding=(0, 0)):
    """The bf16 grade: cuDNN's bf16 convolution on a CUDA tensor (bf16
    operands and output), cast to float32; the plain version on a CPU
    tensor or inside ``kernels.plain_versions()``."""
    if not kernels.use_kernel(x):
        return conv2d_bf16_plain(x, w, stride, padding)
    bf16 = torch.bfloat16
    return F.conv2d(x.to(bf16), w.to(bf16), None, stride, padding).float()


class Conv2d(nn.Conv2d):
    """``torch.nn.Conv2d`` with no bias, groups 1 and zero padding (the
    ResNet's convolutions) in the port's grades: ``compute_dtype`` None
    (exact) or ``torch.bfloat16`` (the AMP grade).  Its init is the
    ResNet's, N(0, 2/fan_out), drawn by ``reset_parameters(generator)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, compute_dtype=None, device=None):
        # set before nn.Conv2d's __init__, which calls reset_parameters
        self.compute_dtype = compute_dtype
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=False,
                         device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """kaiming_normal fan_out, drawn from ``generator`` (a CPU
        ``torch.Generator``; None uses torch's global one)."""
        kh, kw = self.kernel_size
        std = math.sqrt(2.0) / math.sqrt(self.out_channels * kh * kw)
        self.weight.copy_(torch.randn(self.weight.shape,
                                      generator=generator) * std)

    def forward(self, x):
        if self.compute_dtype is None:
            return conv2d_exact(x, self.weight, self.stride, self.padding)
        if self.compute_dtype != torch.bfloat16:
            raise ValueError(f"compute_dtype {self.compute_dtype} is not "
                             "a grade of the port (None or torch.bfloat16)")
        return conv2d_bf16(x, self.weight, self.stride, self.padding)
