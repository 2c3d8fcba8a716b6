"""PDE layers of the port: MixedChannelDiffusion (the CIFAR-10 flagship's)."""

from .diffusion import MixedChannelDiffusion

__all__ = ["MixedChannelDiffusion"]
