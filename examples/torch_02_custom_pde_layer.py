"""Build a NEW PDE layer from the port's kernels and train through it.

The extension points of the PyTorch port: a ``torch.nn.Module`` and the L1
ops (``ops.adi.sweep_x``/``sweep_y``: K1 on the card, its adjoint K3 in the
backward; ``ops.stencil.ftcs_evolve``, ``ops.smoothing.smooth3``).
Everything differentiates: the learnable anisotropy here gets real
gradients through the implicit ADI solves.  It runs on the card unless
given ``--device cpu``.

Usage: python examples/torch_02_custom_pde_layer.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch
import torch.nn.functional as F
from torch import nn

from cnn_pde_tpu_torch.ops.adi import sweep_x, sweep_y


class AnisotropicDiffusion(nn.Module):
    """One learnable scalar per axis: u evolves under alpha in x, beta in y.

    A minimal custom layer; ``pde/diffusion.py``'s GrayscaleDiffusion (per
    pixel coefficient fields, time dependence, clamping) is the production
    version of the same structure."""

    def __init__(self, size=16, dt=0.05, num_steps=4):
        super().__init__()
        self.size, self.dt, self.num_steps = size, dt, num_steps
        # softplus-parameterised so that the diffusivities stay positive
        self.raw_alpha = nn.Parameter(torch.zeros(()))
        self.raw_beta = nn.Parameter(torch.zeros(()))

    def coefficients(self):
        return (F.softplus(self.raw_alpha) + 1e-3,
                F.softplus(self.raw_beta) + 1e-3)

    def forward(self, x):
        alpha, beta = self.coefficients()
        shape = (self.size, self.size)
        # batch-free coefficient fields, shared by every image
        a = alpha.expand(shape).contiguous()
        b = beta.expand(shape).contiguous()
        u = x[:, 0]
        for _ in range(self.num_steps):  # Strang: x(dt/2) y(dt) x(dt/2)
            u = sweep_x(u, a, self.dt / 2, 1.0, smooth=False, eps=1e-6)
            u = sweep_y(u, b, self.dt, 1.0, smooth=False, eps=1e-6)
            u = sweep_x(u, a, self.dt / 2, 1.0, smooth=False, eps=1e-6)
        return u[:, None]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    torch.manual_seed(0)
    layer = AnisotropicDiffusion()
    model = nn.Sequential(layer, nn.Flatten(), nn.Linear(256, 4)).to(device)

    # synthetic task: classify which quadrant a hot spot sits in
    x = torch.zeros(4, 1, 16, 16)
    for q in range(4):
        x[q, 0, 4 + 8 * (q % 2), 4 + 8 * (q // 2)] = 50.0
    x, y = x.to(device), torch.arange(4, device=device)

    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    for i in range(30):
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        if i % 10 == 0:
            print(f"step {i}: loss {loss.item():.4f}")
    alpha, beta = (c.item() for c in layer.coefficients())
    print(f"final loss {loss.item():.4f}; learned alpha={alpha:.3f} "
          f"beta={beta:.3f}")
    assert loss.item() < 1.0


if __name__ == "__main__":
    main()
