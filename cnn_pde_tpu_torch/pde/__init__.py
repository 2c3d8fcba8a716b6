"""PDE layers of the port: MixedChannelDiffusion (the CIFAR-10 flagship's),
GrayscaleDiffusion (the MNIST and Fashion-MNIST front end) and
ChannelCoupledDiffusion (SVHN's), and the one-switch AMP grade."""

from .amp import enable_amp, iter_adi_layers, iter_modules
from .diffusion import (ChannelCoupledDiffusion, GrayscaleDiffusion,
                        MixedChannelDiffusion)

__all__ = ["ChannelCoupledDiffusion", "GrayscaleDiffusion",
           "MixedChannelDiffusion", "enable_amp", "iter_adi_layers",
           "iter_modules"]
