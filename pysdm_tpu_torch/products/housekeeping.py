"""Housekeeping products (port of ``SuperDropletCountPerGridbox`` of
``pysdm_tpu/products/housekeeping.py``; reference
``PySDM/products/housekeeping/``)."""

import torch

from .impl import Product


class SuperDropletCountPerGridbox(Product):
    """live super-droplets per cell, an integer count (a sum of integers
    is exact in any order, so no float atomics are involved)"""

    def __init__(self, name=None):
        super().__init__(name=name or "super droplet count per gridbox")

    def _impl(self, **kwargs):
        p = self.particulator
        particles = p.particles
        counts = torch.zeros(
            p.mesh.n_cell, dtype=torch.int64, device=particles.cell_id.device
        ).index_add_(0, particles.cell_id.long(), particles.alive.long())
        return counts.cpu().numpy()
