"""PyTorch/CUDA port of cnn_pde_tpu for an NVIDIA H100 (Hopper, sm_90a).

Slices 1-3: serving and training of the CIFAR-10 no-conv flagship and of the
grayscale family (MNIST, Fashion-MNIST), with eight hand-written CUDA kernels
(``csrc/``): K1, the batched Thomas solve under every ADI sweep, and K3, its
adjoint; K2, a whole MixedChannelDiffusion layer in one launch (eval), and
K4 and K5, the trainable whole layer forward and backward; K6, a whole
GrayscaleDiffusion layer in one launch (eval), and K7 and K8, its trainable
forward and backward.  Slice 7 adds SVHN (ChannelCoupledDiffusion, on K1
and K3) and the AMP grade (``pde.enable_amp``): every sweep's operator of an
evolution built by K1 once a forward and applied as a bf16 GEMM with float32
accumulation.  Slice 8 adds emotion (the FTCS layer) and Tiny-ImageNet
(ResidualDiffusion, on K1 and K3 when implicit, and a ResNet-18 whose
convolutions never take TF32 in the exact grade and are bf16 in the AMP
grade).  The port imports torch and numpy, never jax and nothing of
cnn_pde_tpu.
"""

__version__ = "0.3.0"
