"""Size-spectral products (port of the two of
``pysdm_tpu/products/size_spectral.py`` the breakup box reads; reference
``PySDM/products/size_spectral/``)."""

import numpy as np

from .impl import Product


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
