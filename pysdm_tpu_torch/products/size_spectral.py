"""Size-spectral products (port of the ones of
``pysdm_tpu/products/size_spectral.py`` that the breakup box and the 1D
column read; reference ``PySDM/products/size_spectral/``)."""

import numpy as np

from .impl import MomentProduct, Product


class _VolumeBinned(Product):
    """a spectrum over radius bins, binned by volume"""

    def __init__(self, radius_bins_edges, name=None, unit="dimensionless"):
        super().__init__(name=name, unit=unit)
        self.radius_bins_edges = np.asarray(radius_bins_edges)
        self.volume_bins_edges = None

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("volume")
        self.volume_bins_edges = np.asarray(
            builder.formulae.trivia.volume(self.radius_bins_edges)
        )
        self.shape = (*self.particulator.mesh.grid, len(self.volume_bins_edges) - 1)

    def _volume_moments(self):
        return self.particulator.spectrum_moments(
            attr_name="volume", rank=1, attr_bins=self.volume_bins_edges,
            filter_attr="volume",
        )

    def shape_for_output(self, result):
        return self.shape


class ParticleVolumeVersusRadiusLogarithmSpectrum(_VolumeBinned):
    """dv/dlnr per radius bin (reference
    ``particle_volume_versus_radius_logarithm_spectrum.py``): total particle
    volume per cell volume per unit ln(r), per bin"""

    def _impl(self, **kwargs):
        m0, mom = self._volume_moments()
        vals = (mom * m0).T  # (n_cell, n_bins): total volume per bin per cell
        vals *= 1 / np.diff(np.log(self.radius_bins_edges)) / self.particulator.mesh.dv
        return vals


class NumberSizeSpectrum(_VolumeBinned):
    """particle number per volume of air per size bin (reference
    ``number_size_spectrum.py``; NOT divided by bin width)"""

    def __init__(self, radius_bins_edges, name=None, unit="m^-3"):
        super().__init__(
            radius_bins_edges, name=name or "number size spectrum", unit=unit
        )

    def _impl(self, **kwargs):
        m0, _ = self._volume_moments()
        return m0.T / self.particulator.mesh.dv


class _RadiusRanged(MomentProduct):
    """a moment product over the particles whose radius lies in
    ``radius_range``, filtered by volume"""

    def __init__(self, radius_range, name, unit):
        super().__init__(name=name, unit=unit)
        self.radius_range = radius_range
        self.volume_range = None

    def register(self, builder):
        super().register(builder)
        self.volume_range = tuple(
            np.asarray(builder.formulae.trivia.volume(np.asarray(self.radius_range)))
        )


class WaterMixingRatio(_RadiusRanged):
    """liquid water mass per mass of dry air within a radius range
    (reference ``water_mixing_ratio.py``)"""

    def __init__(self, radius_range=None, name=None, unit="dimensionless"):
        super().__init__(
            radius_range or (0, np.inf), name or "water mixing ratio", unit
        )

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("water mass")

    def _impl(self, **kwargs):
        _, mass = self._download_moment(
            attr="water mass", rank=1, filter_range=self.volume_range,
            skip_division_by_m0=True,
        )
        p = self.particulator
        return mass / p.mesh.dv / p.get_env("rhod")


class EffectiveRadius(_RadiusRanged):
    """the ratio of the third to the second radius moment (reference
    ``effective_radius.py``), 0 where no particle is in range"""

    def __init__(self, radius_range=(0, np.inf), name=None, unit="m"):
        super().__init__(radius_range, name or "effective radius", unit)

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("radius")

    def _impl(self, **kwargs):
        _, (m3, m2) = self.particulator.moments(
            attr_name="radius", ranks=(3, 2), filter_range=self.volume_range,
            skip_division_by_m0=True,
        )
        return np.where(m2 > 0, m3 / np.where(m2 > 0, m2, 1), 0.0)


class CloudWaterContent(MomentProduct):
    """liquid and/or ice water mass per volume (or, ``specific``, per mass
    of dry air) of air (reference ``cloud_water_content.py``); ice is the
    particles of negative signed water mass"""

    def __init__(self, unit="kg/m^3", name=None, specific=False, liquid=True,
                 ice=True):
        super().__init__(name=name or "cloud water content", unit=unit)
        self.specific = specific
        self.liquid = liquid
        self.ice = ice

    def _impl(self, **kwargs):
        dv = self.particulator.mesh.dv
        cwc = 0.0
        for phase, signed_range in (
            (self.liquid, (0, np.inf)), (self.ice, (-np.inf, 0)),
        ):
            if phase:
                _, mass = self._download_moment(
                    attr="water mass", rank=1,
                    filter_attr="signed water mass", filter_range=signed_range,
                    skip_division_by_m0=True,
                )
                cwc = cwc + mass / dv
        if self.specific:
            cwc = cwc / self.particulator.get_env("rhod")
        return cwc
