"""Spatial sampling of super-droplet positions (a NumPy copy of
``pysdm_tpu/initialisation/sampling/spatial_sampling.py``; reference
``PySDM/initialisation/sampling/spatial_sampling.py``): pseudo-random
uniform positions in grid coordinates, with optional confinement of the
vertical coordinate to a sub-range (``z_part``). The same seed gives the
same positions in both packages."""

import numpy as np


class Pseudorandom:
    @staticmethod
    def sample(*, grid, n_sd, z_part=None, x_part=None, seed=44):
        rng = np.random.default_rng(seed)
        n_dims = len(grid)
        u01 = rng.uniform(0.0, 1.0, (n_dims, n_sd))
        positions = np.empty((n_dims, n_sd))
        for d in range(n_dims):
            lo, hi = 0.0, float(grid[d])
            if d == n_dims - 1 and z_part is not None:
                lo, hi = z_part[0] * grid[d], z_part[1] * grid[d]
            if d == 0 and n_dims > 1 and x_part is not None:
                lo, hi = x_part[0] * grid[d], x_part[1] * grid[d]
            positions[d] = lo + u01[d] * (hi - lo)
        return positions
