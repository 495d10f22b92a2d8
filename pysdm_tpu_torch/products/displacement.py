"""Displacement products (port of ``SurfacePrecipitation`` of
``pysdm_tpu/products/displacement.py``; reference
``PySDM/products/displacement/``)."""

import numpy as np

from .impl import Product


class SurfacePrecipitation(Product):
    """precipitation rate through the counting level in water-depth units
    (reference ``surface_precipitation.py``: mass / rho_w / area / time),
    reset on read; the bottom area is the domain's width in 2D and 1 m^2
    in 1D"""

    def __init__(self, name=None, unit="m/s"):
        super().__init__(name=name or "surface precipitation", unit=unit)
        self._last_steps = 0
        self.domain_bottom_surface_area = 1.0

    def register(self, builder):
        super().register(builder)
        self.shape = ()
        mesh = self.particulator.mesh
        if mesh.dimension == 2:
            self.domain_bottom_surface_area = mesh.size[0] * 1.0
        self._last_steps = 0

    def _impl(self, **kwargs):
        p = self.particulator
        elapsed = (p.n_steps - self._last_steps) * p.dt
        self._last_steps = p.n_steps
        mass = float(np.sum(p.get_counter("precipitated_mass")))
        p.reset_counter("precipitated_mass")
        if elapsed == 0:
            return np.asarray(0.0)
        rho_w = p.formulae.constants.rho_w
        return np.asarray(mass / rho_w / self.domain_bottom_surface_area / elapsed)

    def shape_for_output(self, result):
        return ()
