"""Freezing and ice products (port of ``pysdm_tpu/products/freezing.py``;
reference ``PySDM/products/freezing/``): ice water content, frozen particle
concentrations and fraction, ice-nuclei concentrations, the unfrozen
immersed surface area, the freezable spectrum and the cooling rate. Frozen
particles are those with a negative signed water mass. Each reads per-cell
or per-(bin, cell) moments (``Particulator.moments``/``spectrum_moments``,
sums in a fixed order) and finishes on the host in NumPy, as the JAX
package does."""

import numpy as np

from .impl import MomentProduct, Product


class IceWaterContent(MomentProduct):
    """total ice mass per volume (kg/m^3)"""

    def __init__(self, name=None, unit="kg/m^3"):
        super().__init__(name=name or "ice water content", unit=unit)

    def _impl(self, **kwargs):
        m0, mass = self._download_moment(
            attr="water mass",
            rank=1,
            filter_attr="signed water mass",
            filter_range=(-np.inf, 0),
            skip_division_by_m0=True,
        )
        return mass / self.particulator.mesh.dv


class SpecificIceWaterContent(IceWaterContent):
    """ice mass per dry-air mass (kg/kg)"""

    def __init__(self, name=None, unit="kg/kg"):
        super().__init__(name=name or "specific ice water content", unit=unit)

    def _impl(self, **kwargs):
        iwc = super()._impl(**kwargs)
        rhod = self.particulator.get_env("rhod")
        return iwc / rhod


class FrozenParticleConcentration(MomentProduct):
    """number of frozen particles per volume (1/m^3)"""

    def __init__(self, name=None, unit="m^-3"):
        super().__init__(name=name or "frozen particle concentration", unit=unit)

    def _impl(self, **kwargs):
        m0, _ = self._download_moment(
            attr="water mass",
            rank=0,
            filter_attr="signed water mass",
            filter_range=(-np.inf, 0),
        )
        return m0 / self.particulator.mesh.dv


class FrozenFraction(MomentProduct):
    """fraction of the super-droplet-represented population that is frozen"""

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "frozen fraction", unit=unit)

    def _impl(self, **kwargs):
        frozen, _ = self._download_moment(
            attr="water mass",
            rank=0,
            filter_attr="signed water mass",
            filter_range=(-np.inf, 0),
        )
        total, _ = self._download_moment(attr="water mass", rank=0)
        return np.where(total > 0, frozen / np.maximum(total, 1), 0.0)


class FrozenParticleSpecificConcentration(FrozenParticleConcentration):
    """number of frozen particles per dry-air mass (reference
    ``frozen_particle_concentration.py``)"""

    def __init__(self, name=None, unit="kg^-1"):
        super().__init__(
            name=name or "frozen particle specific concentration", unit=unit
        )

    def _impl(self, **kwargs):
        conc = super()._impl(**kwargs)
        return conc / self.particulator.get_env("rhod")


class IceNucleiConcentration(MomentProduct):
    """immersed ice-nucleus concentration, frozen or not (reference
    ``ice_nuclei_concentration.py``): counts particles with a nonzero
    freezing temperature (singular mode) or immersed surface area
    (time-dependent mode)"""

    def __init__(self, name=None, unit="m^-3", specific=False):
        super().__init__(name=name or "ice nuclei concentration", unit=unit)
        self.specific = specific
        self._filter_attr = None

    def register(self, builder):
        super().register(builder)
        freezing = builder.particulator.dynamics.get("Freezing")
        singular = freezing.singular if freezing is not None else True
        self._filter_attr = (
            "freezing temperature" if singular else "immersed surface area"
        )

    def _impl(self, **kwargs):
        m0, _ = self._download_moment(
            attr="volume",
            rank=0,
            filter_attr=self._filter_attr,
            filter_range=(np.finfo(float).tiny, np.inf),
        )
        result = m0 / self.particulator.mesh.dv
        if self.specific:
            result = result / self.particulator.get_env("rhod")
        return result


class SpecificIceNucleiConcentration(IceNucleiConcentration):
    def __init__(self, name=None, unit="kg^-1"):
        super().__init__(
            name=name or "specific ice nuclei concentration",
            unit=unit,
            specific=True,
        )


class TotalUnfrozenImmersedSurfaceArea(MomentProduct):
    """total immersed surface area within unfrozen (positive-mass) particles
    (reference ``total_unfrozen_immersed_surface_area.py``)"""

    def __init__(self, name=None, unit="m^2"):
        super().__init__(
            name=name or "total unfrozen immersed surface area", unit=unit
        )

    def _impl(self, **kwargs):
        m0, m1 = self._download_moment(
            attr="immersed surface area",
            rank=1,
            filter_attr="signed water mass",
            filter_range=(0, np.inf),
        )
        return m1 * m0


class FreezableSpecificConcentration(Product):
    """freezing-temperature-binned specific number concentration
    (reference ``freezable_specific_concentration.py``)"""

    def __init__(self, temperature_bins_edges, name=None, unit="kg^-1 K^-1"):
        super().__init__(
            name=name or "freezable specific concentration", unit=unit
        )
        self.temperature_bins_edges = np.asarray(temperature_bins_edges)

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("freezing temperature")
        self.shape = (
            *self.particulator.mesh.grid,
            len(self.temperature_bins_edges) - 1,
        )

    def _impl(self, **kwargs):
        m0, _ = self.particulator.spectrum_moments(
            attr_name="volume",
            rank=0,
            attr_bins=self.temperature_bins_edges,
            filter_attr="freezing temperature",
        )
        vals = m0.T  # (n_cell, n_bins)
        rhod = np.asarray(self.particulator.get_env("rhod")).reshape(-1, 1)
        dT = np.abs(np.diff(self.temperature_bins_edges)).reshape(1, -1)
        return vals / (rhod * dT * self.particulator.mesh.dv)

    def shape_for_output(self, result):
        return self.shape


class CoolingRate(MomentProduct):
    """number-averaged per-particle cooling rate per cell (reference
    ``products/freezing/cooling_rate.py`` — rank-1 moment of the
    "cooling rate" attribute, which compares each particle's current cell T
    against the cell T it saw on the previous step)."""

    def __init__(self, name=None, unit="K/s"):
        super().__init__(name=name or "cooling rate", unit=unit)

    def register(self, builder):
        builder.request_attribute("cooling rate")
        super().register(builder)

    def _impl(self, **kwargs):
        m0, mean = self._download_moment(attr="cooling rate", rank=1)
        return mean
