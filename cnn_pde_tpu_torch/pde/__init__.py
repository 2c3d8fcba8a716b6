"""PDE layers of the port: MixedChannelDiffusion (the CIFAR-10 flagship's)
and GrayscaleDiffusion (the MNIST and Fashion-MNIST front end)."""

from .diffusion import GrayscaleDiffusion, MixedChannelDiffusion

__all__ = ["GrayscaleDiffusion", "MixedChannelDiffusion"]
