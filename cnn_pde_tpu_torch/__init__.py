"""PyTorch/CUDA port of cnn_pde_tpu for an NVIDIA H100 (Hopper, sm_90a).

Slice 1: the CIFAR-10 no-conv flagship's eval forward and serving, with two
hand-written CUDA kernels (``csrc/``): K1, the batched Thomas solve under
every ADI sweep, and K2, a whole MixedChannelDiffusion layer in one launch.
The port imports torch and numpy, never jax and nothing of cnn_pde_tpu.
"""

__version__ = "0.1.0"
