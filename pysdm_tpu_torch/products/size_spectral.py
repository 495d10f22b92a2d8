"""Size-spectral products (port of ``pysdm_tpu/products/size_spectral.py``;
reference ``PySDM/products/size_spectral/``): spectra over radius bins,
concentrations, mean radii, standard deviations, water contents, their
activation-filtered forms and arbitrary moments. Each reads per-cell or
per-(bin, cell) moments (``Particulator.moments``/``spectrum_moments``,
sums in a fixed order) and finishes on the host in NumPy, as the JAX
package does."""

import numpy as np

from .impl import MomentProduct, Product


def _ratio_or_zero(num, den):
    """num / den where den > 0, else 0"""
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


class _RadiusBinned(Product):
    """a spectrum over radius bins, binned by ``attr`` (the volumes of the
    bin edges)"""

    attr = "volume"

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

    def _moments(self, attr_name="volume", rank=1):
        return self.particulator.spectrum_moments(
            attr_name=attr_name, rank=rank, attr_bins=self.volume_bins_edges,
            filter_attr=self.attr,
        )

    def shape_for_output(self, result):
        return self.shape


class ParticleVolumeVersusRadiusLogarithmSpectrum(_RadiusBinned):
    """dv/dlnr per radius bin (reference
    ``particle_volume_versus_radius_logarithm_spectrum.py``): total particle
    volume per cell volume per unit ln(r), per bin"""

    def _impl(self, **kwargs):
        m0, mom = self._moments()
        vals = (mom * m0).T  # (n_cell, n_bins): total volume per bin per cell
        vals *= 1 / np.diff(np.log(self.radius_bins_edges)) / self.particulator.mesh.dv
        return vals


class NumberSizeSpectrum(_RadiusBinned):
    """particle number per volume of air per size bin (reference
    ``number_size_spectrum.py``; NOT divided by bin width)"""

    def __init__(self, radius_bins_edges, name=None, unit="m^-3"):
        super().__init__(
            radius_bins_edges, name=name or "number size spectrum", unit=unit
        )

    def _impl(self, **kwargs):
        m0, _ = self._moments()
        return m0.T / self.particulator.mesh.dv


class ParticleSizeSpectrumPerVolume(_RadiusBinned):
    """number per radius-bin width per volume of air, dN/dr (reference
    ``particle_size_spectrum.py``), of the wet or (``dry``) dry radius"""

    def __init__(self, radius_bins_edges, name=None, unit="m^-3 m^-1",
                 dry=False):
        super().__init__(radius_bins_edges, name=name, unit=unit)
        self.attr = ("dry " if dry else "") + "volume"

    def _impl(self, **kwargs):
        m0, _ = self._moments(self.attr, rank=0)
        return m0.T / np.diff(self.radius_bins_edges) / self.particulator.mesh.dv


class ParticleSizeSpectrumPerMassOfDryAir(ParticleSizeSpectrumPerVolume):
    """dN/dr per mass of dry air (reference ``particle_size_spectrum.py``)"""

    def __init__(self, radius_bins_edges, name=None, unit="kg^-1 m^-1",
                 dry=False):
        super().__init__(
            radius_bins_edges,
            name=name or "particle size spectrum per mass of dry air",
            unit=unit, dry=dry,
        )

    def _impl(self, **kwargs):
        per_volume = super()._impl(**kwargs)
        rhod = np.asarray(self.particulator.get_env("rhod"))
        return per_volume / rhod.reshape(-1, *([1] * (per_volume.ndim - 1)))


class RadiusBinnedNumberAveragedTerminalVelocity(_RadiusBinned):
    """number-averaged terminal velocity per radius bin (reference
    ``radius_binned_number_averaged_terminal_velocity.py``)"""

    def __init__(self, radius_bin_edges, name=None, unit="m/s"):
        super().__init__(
            radius_bin_edges,
            name=name or "radius binned number averaged terminal velocity",
            unit=unit,
        )

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("terminal velocity")

    def _impl(self, **kwargs):
        _, mom = self._moments("terminal velocity")
        return mom.T


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
        return _ratio_or_zero(m3, m2)


class TotalParticleConcentration(MomentProduct):
    def __init__(self, name=None, unit="m^-3"):
        super().__init__(name=name or "total particle concentration", unit=unit)

    def _impl(self, **kwargs):
        m0, _ = self._download_moment(attr="volume", rank=0)
        return m0 / self.particulator.mesh.dv


class TotalParticleSpecificConcentration(TotalParticleConcentration):
    def __init__(self, name=None, unit="kg^-1"):
        super().__init__(
            name=name or "total particle specific concentration", unit=unit
        )

    def _impl(self, **kwargs):
        return super()._impl(**kwargs) / self.particulator.get_env("rhod")


class ParticleConcentration(_RadiusRanged):
    def __init__(self, radius_range=(0, np.inf), name=None, unit="m^-3"):
        super().__init__(radius_range, name or "particle concentration", unit)

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("radius")

    def _impl(self, **kwargs):
        m0, _ = self._download_moment(
            attr="volume", rank=0, filter_range=self.volume_range
        )
        return m0 / self.particulator.mesh.dv


class ParticleSpecificConcentration(ParticleConcentration):
    """number per mass of dry air (reference ``particle_concentration.py``)"""

    def __init__(self, radius_range=(0, np.inf), name=None, unit="kg^-1"):
        super().__init__(
            radius_range=radius_range,
            name=name or "particle specific concentration", unit=unit,
        )

    def _impl(self, **kwargs):
        return super()._impl(**kwargs) / self.particulator.get_env("rhod")


class MeanRadius(_RadiusRanged):
    def __init__(self, name=None, unit="m", radius_range=(0, np.inf)):
        super().__init__(radius_range, name or "mean radius", unit)

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("radius")

    def _impl(self, **kwargs):
        _, m1 = self._download_moment(
            attr="radius", rank=1, filter_range=self.volume_range
        )
        return m1


class MeanVolumeRadius(_RadiusRanged):
    """radius of the mean-volume sphere (reference ``mean_volume_radius.py``)"""

    def __init__(self, radius_range=(0, np.inf), name=None, unit="m"):
        super().__init__(radius_range, name or "mean volume radius", unit)

    def register(self, builder):
        super().register(builder)
        builder.request_attribute("volume")

    def _impl(self, **kwargs):
        _, v_mean = self._download_moment(
            attr="volume", rank=1, filter_range=self.volume_range
        )
        return np.asarray(
            self.particulator.formulae.trivia.radius(np.maximum(v_mean, 0.0))
        )


class _ActivationFiltered:
    """mixin: moments filtered on activation by the 'wet to critical volume
    ratio' attribute (reference ``impl/activation_filtered_product.py``):
    activated above 1, unactivated below"""

    def _init_activation_filter(self, *, count_activated, count_unactivated):
        self.act_filter_range = [0.0, np.inf]
        if not count_activated:
            self.act_filter_range[1] = 1.0
        if not count_unactivated:
            self.act_filter_range[0] = 1.0

    def _activation_filtered_moment(self, *, attr, rank,
                                    skip_division_by_m0=False):
        return self._download_moment(
            attr=attr, rank=rank,
            filter_attr="wet to critical volume ratio",
            filter_range=tuple(self.act_filter_range),
            skip_division_by_m0=skip_division_by_m0,
        )


class ActivatedParticleConcentration(MomentProduct, _ActivationFiltered):
    """per-volume (or per-mass, or STP-normalized) concentration of
    (un)activated particles (reference ``particle_concentration_activated.py``)"""

    def __init__(self, *, count_unactivated, count_activated, specific=False,
                 stp=False, name=None, unit="m^-3"):
        if stp and specific:
            raise ValueError(
                "std-temperature-and-pressure precludes specific conc. option"
            )
        super().__init__(
            name=name or "activated particle concentration", unit=unit
        )
        self._init_activation_filter(
            count_activated=count_activated, count_unactivated=count_unactivated
        )
        self.specific = specific
        self.stp = stp

    def _impl(self, **kwargs):
        m0, _ = self._activation_filtered_moment(attr="volume", rank=0)
        result = m0 / self.particulator.mesh.dv
        if self.specific or self.stp:
            result = result / self.particulator.get_env("rhod")
            if self.stp:
                result = result * self.particulator.formulae.constants.rho_STP
        return result


class ActivatedParticleSpecificConcentration(ActivatedParticleConcentration):
    def __init__(self, count_unactivated, count_activated, name=None,
                 unit="kg^-1"):
        super().__init__(
            count_unactivated=count_unactivated,
            count_activated=count_activated, specific=True,
            name=name or "activated particle specific concentration", unit=unit,
        )


class ActivatedMeanRadius(MomentProduct, _ActivationFiltered):
    """mean radius of (un)activated particles (reference
    ``mean_radius_activated.py``)"""

    def __init__(self, *, count_unactivated, count_activated, name=None,
                 unit="m"):
        super().__init__(name=name or "activated mean radius", unit=unit)
        self._init_activation_filter(
            count_activated=count_activated, count_unactivated=count_unactivated
        )

    def _impl(self, **kwargs):
        _, m1 = self._activation_filtered_moment(attr="radius", rank=1)
        return m1


class ActivatedEffectiveRadius(MomentProduct, _ActivationFiltered):
    """ratio of the 3rd to the 2nd radius moment over (un)activated
    particles (reference ``effective_radius_activated.py``), 0 where none"""

    def __init__(self, *, count_unactivated, count_activated, name=None,
                 unit="m"):
        super().__init__(name=name or "activated effective radius", unit=unit)
        self._init_activation_filter(
            count_activated=count_activated, count_unactivated=count_unactivated
        )

    def _impl(self, **kwargs):
        _, m3 = self._activation_filtered_moment(
            attr="radius", rank=3, skip_division_by_m0=True
        )
        _, m2 = self._activation_filtered_moment(
            attr="radius", rank=2, skip_division_by_m0=True
        )
        return _ratio_or_zero(m3, m2)


class _SizeStandardDeviation(_RadiusRanged, _ActivationFiltered):
    """multiplicity-weighted standard deviation of an attribute within a
    radius range, or of the (un)activated particles (reference
    ``size_standard_deviation.py``)"""

    attr = None

    def __init__(self, radius_range=(0, np.inf), name=None, unit=None,
                 count_activated=None, count_unactivated=None):
        super().__init__(radius_range, name, unit)
        self.activation_filtered = count_activated is not None
        if self.activation_filtered:
            self._init_activation_filter(
                count_activated=count_activated,
                count_unactivated=bool(count_unactivated),
            )

    def register(self, builder):
        super().register(builder)
        builder.request_attribute(self.attr)

    def _impl(self, **kwargs):
        if self.activation_filtered:
            _, m1 = self._activation_filtered_moment(attr=self.attr, rank=1)
            _, m2 = self._activation_filtered_moment(attr=self.attr, rank=2)
        else:
            _, m1 = self._download_moment(
                attr=self.attr, rank=1, filter_range=self.volume_range
            )
            _, m2 = self._download_moment(
                attr=self.attr, rank=2, filter_range=self.volume_range
            )
        return np.sqrt(np.maximum(m2 - m1**2, 0.0))


class RadiusStandardDeviation(_SizeStandardDeviation):
    attr = "radius"

    def __init__(self, radius_range=(0, np.inf), name=None, unit="m",
                 **kwargs):
        super().__init__(radius_range=radius_range, **kwargs,
                         name=name or "radius standard deviation", unit=unit)


class AreaStandardDeviation(_SizeStandardDeviation):
    attr = "area"

    def __init__(self, radius_range=(0, np.inf), name=None, unit="m^2",
                 **kwargs):
        super().__init__(radius_range=radius_range, **kwargs,
                         name=name or "area standard deviation", unit=unit)


class VolumeStandardDeviation(_SizeStandardDeviation):
    attr = "volume"

    def __init__(self, radius_range=(0, np.inf), name=None, unit="m^3",
                 **kwargs):
        super().__init__(radius_range=radius_range, **kwargs,
                         name=name or "volume standard deviation", unit=unit)


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


class SpecificCloudWaterContent(CloudWaterContent):
    def __init__(self, unit="kg/kg", name=None):
        super().__init__(unit=unit, name=name or "specific cloud water content",
                         specific=True, liquid=True, ice=True)


class LiquidWaterContent(CloudWaterContent):
    def __init__(self, unit="kg/m^3", name=None):
        super().__init__(unit=unit, name=name or "liquid water content",
                         specific=False, liquid=True, ice=False)


class SpecificLiquidWaterContent(CloudWaterContent):
    def __init__(self, unit="kg/kg", name=None):
        super().__init__(unit=unit, name=name or "specific liquid water content",
                         specific=True, liquid=True, ice=False)


def make_arbitrary_moment_product(*, rank, attr, attr_unit,
                                  skip_division_by_m0=False,
                                  skip_division_by_dv=False):
    """a product class of the per-cell moment ``rank`` of ``attr``
    (reference ``arbitrary_moment.py``)"""

    class ArbitraryMoment(MomentProduct):
        def __init__(self, name=None,
                     unit=f"({attr_unit})**{rank}"
                          + ("" if skip_division_by_dv else " / m**3")):
            super().__init__(name=name or f"{attr} moment {rank}", unit=unit)

        def register(self, builder):
            super().register(builder)
            builder.request_attribute(attr)

        def _impl(self, **kwargs):
            _, mk = self._download_moment(
                attr=attr, rank=rank, skip_division_by_m0=skip_division_by_m0
            )
            if not skip_division_by_dv:
                mk = mk / self.particulator.mesh.dv
            return mk

    return ArbitraryMoment


ZerothMoment = make_arbitrary_moment_product(
    rank=0, attr="volume", attr_unit="m^3", skip_division_by_m0=True
)
VolumeFirstMoment = make_arbitrary_moment_product(
    rank=1, attr="volume", attr_unit="m^3", skip_division_by_m0=True
)
VolumeSecondMoment = make_arbitrary_moment_product(
    rank=2, attr="volume", attr_unit="m^3", skip_division_by_m0=True
)
RadiusFirstMoment = make_arbitrary_moment_product(
    rank=1, attr="radius", attr_unit="m", skip_division_by_m0=False
)
RadiusSixthMoment = make_arbitrary_moment_product(
    rank=6, attr="radius", attr_unit="m", skip_division_by_m0=False
)
