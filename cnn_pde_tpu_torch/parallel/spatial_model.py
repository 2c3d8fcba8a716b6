"""The spatially sharded classifiers — port of
``cnn_pde_tpu/parallel/spatial_model.py``: the emotion and Tiny-ImageNet
models with their PDE evolution run on H blocks over the mesh's 'spatial'
axis (``parallel/spatial.py``), then gathered to the whole map for the
replicated head or backbone.

Each is its unsharded port model with another forward, so the
``state_dict`` names are that model's (``EmotionClassifier``'s ``pde.*`` /
``classifier.*``, ``TinyImageNetClassifier``'s), and the weights of
``compat`` and the checkpoints of either interchange.

The forward takes this rank's H block of the images (B, C, H/S, W), as
``Trainer(image_spec=("data", None, "spatial", None))`` lays batches out,
or whole images (B, C, H, W), of which it keeps its block.  The gather
over 'spatial' (``collectives.gather_dim``) sums the gradient over the
axis in its backward: each spatial rank computes the head alike, and the
train step divides each rank's loss by the axis size
(``data_parallel.StepReducer``), so the head's gradients sum to the
single-device ones and the PDE parameters' blocks add up.
"""

from __future__ import annotations

from ..models.mlp_models import EmotionClassifier
from ..models.tiny_imagenet import TinyImageNetClassifier
from ..pde.spectral import FourierFTCSLayer
from .collectives import gather_dim
from .spatial import (AXIS, block, ftcs_evolve_spatial,
                      laplacian_step_spatial)

__all__ = ["SpatialFTCSClassifier", "SpatialTinyImageNetClassifier"]


def _h_block(mesh, x, full):
    """This rank's rows of ``x`` along H (dim 2): x itself when it is a
    block already."""
    lo, hi = block(mesh, full)
    return x if x.shape[2] != full or hi - lo == full else x[:, :, lo:hi]


class SpatialFTCSClassifier(EmotionClassifier):
    """EmotionClassifier with its FTCS evolution H-sharded over 'spatial':
    one halo row each way a step (``ftcs_evolve_spatial``), the grids'
    rows of this rank's block, then the map gathered for the head.  ``T``
    and ``dt`` are its ``FourierFTCSLayer``'s horizon and step (``pde.Nt``
    = int(T / dt) steps), as in the JAX class; the unsharded model keeps
    the layer's defaults."""

    def __init__(self, mesh, img_size=48, num_classes=7, dropout_rate=0.3,
                 T=0.01, dt=0.001, device=None):
        super().__init__(img_size=img_size, num_classes=num_classes,
                         dropout_rate=dropout_rate, device=device)
        # the same name, so the state_dict is EmotionClassifier's
        self.pde = FourierFTCSLayer(Nx=img_size, Ny=img_size, T=T, dt=dt,
                                    device=device)
        self.mesh = mesh

    def forward(self, x):
        pde = self.pde
        x = _h_block(self.mesh, x, pde.Ny)
        lo, hi = block(self.mesh, pde.Ny)
        alpha, beta = pde.coefficient_grids()
        u = ftcs_evolve_spatial(self.mesh, x[:, 0], alpha[lo:hi],
                                beta[lo:hi], pde.Nt)
        u = gather_dim(u, self.mesh, AXIS, 1)
        return self.classifier(u[:, None])


class SpatialTinyImageNetClassifier(TinyImageNetClassifier):
    """TinyImageNetClassifier (the explicit ResidualDiffusion front end)
    with the Laplacian steps H-sharded over 'spatial': ResidualDiffusion's
    clamp, channel scaling and damped 0.1 residual, the step by
    ``laplacian_step_spatial``, then the map gathered for the ResNet."""

    def __init__(self, mesh, num_classes=200, dropout_rate=0.3, device=None):
        super().__init__(num_classes=num_classes, use_pde=True,
                         dropout_rate=dropout_rate, device=device)
        self.mesh = mesh

    def forward(self, x):
        d = self.diff
        u = _h_block(self.mesh, x, d.size)
        for _ in range(d.num_steps):
            alpha_eff = d.alpha_base.clamp(d.eps, d.max_coeff)
            u_scaled = u * d.channel_scaling[None, :, None, None]
            u_new = laplacian_step_spatial(self.mesh, u_scaled, alpha_eff,
                                           dt=d.dt)
            u = u + 0.1 * (u_new - u)
        x = gather_dim(u, self.mesh, AXIS, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(self.dropout(x))
