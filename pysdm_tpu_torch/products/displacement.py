"""Displacement products (port of ``pysdm_tpu/products/displacement.py``;
reference ``PySDM/products/displacement/``): the surface precipitation
rate, the largest Courant number, the mean terminal velocity and the flow
velocity."""

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


class MaxCourantNumber(Product):
    """the largest |courant| over the flow field (reference
    ``max_courant_number.py``)"""

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "max courant number", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        out = 0.0
        for d in range(p.mesh.dimension):
            out = max(out, float(np.abs(p.get_env(f"courant_{d}")).max()))
        return np.asarray(out)

    def shape_for_output(self, result):
        return ()


class AveragedTerminalVelocity(Product):
    """multiplicity-weighted mean terminal velocity per cell of the
    particles whose radius lies in ``radius_range``, 0 where none does
    (reference ``averaged_terminal_velocity.py``)"""

    def __init__(self, name=None, unit="m/s", radius_range=(0, np.inf)):
        super().__init__(name=name or "averaged terminal velocity", unit=unit)
        self.radius_range = radius_range

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("terminal velocity")

    def _impl(self, **kwargs):
        m0, mk = self.particulator.moments(
            attr_name="terminal velocity", ranks=(1,), filter_attr="radius",
            filter_range=self.radius_range,
        )
        return np.where(m0 > 0, mk[0], 0.0)


class FlowVelocityComponent(Product):
    """a flow velocity component on cell centres: the mean of the two
    faces' Courant numbers times grid step over dt (reference
    ``flow_velocity_component.py``)"""

    def __init__(self, component: int, name=None, unit="m/s"):
        super().__init__(
            name=name or f"flow velocity component {component}", unit=unit
        )
        assert component in (0, 1)
        self.component = component
        self.grid_step = np.nan
        self.time_step = np.nan

    def register(self, builder):
        super().register(builder)
        mesh = self.particulator.mesh
        self.time_step = self.particulator.dt
        self.grid_step = mesh.size[self.component] / mesh.grid[self.component]

    def _impl(self, **kwargs):
        c = np.asarray(self.particulator.get_env(f"courant_{self.component}"))
        if c.ndim == 1:
            centred = 0.5 * (c[:-1] + c[1:])
        elif self.component == 0:
            centred = 0.5 * (c[:-1, :] + c[1:, :])
        else:
            centred = 0.5 * (c[:, :-1] + c[:, 1:])
        return centred * self.grid_step / self.time_step
