"""PDE layers of the port: MixedChannelDiffusion (the CIFAR-10 flagship's),
GrayscaleDiffusion (the MNIST and Fashion-MNIST front end),
ChannelCoupledDiffusion (SVHN's), FourierFTCSLayer (emotion's),
ResidualDiffusion (Tiny-ImageNet's), the Ruthotto–Haber blocks
(SymmetricLayer, ParabolicBlock, HamiltonianBlock: the hybrid's), and the
one-switch AMP grade."""

from .amp import enable_amp, iter_adi_layers, iter_modules
from .diffusion import (ChannelCoupledDiffusion, GrayscaleDiffusion,
                        MixedChannelDiffusion)
from .residual import ResidualDiffusion
from .ruthotto import HamiltonianBlock, ParabolicBlock, SymmetricLayer
from .spectral import FourierFTCSLayer

__all__ = ["ChannelCoupledDiffusion", "GrayscaleDiffusion",
           "MixedChannelDiffusion", "FourierFTCSLayer", "ResidualDiffusion",
           "SymmetricLayer", "ParabolicBlock", "HamiltonianBlock",
           "enable_amp", "iter_adi_layers", "iter_modules"]
