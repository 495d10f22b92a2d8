"""Lowe et al. 2019 (Nature Comms 10): organic-film surface tension in a
parcel (port of ``pysdm_tpu/models/lowe_et_al_2019.py``; reference
``examples/PySDM_examples/Lowe_et_al_2019/settings.py`` + ``simulation.py``
+ ``aerosol.py`` + ``constants_def.py``): marine and boreal aerosol mixtures
with an organic fraction, a 200 m ascent comparing the ``Constant`` and
``CompressedFilmOvadnevaite`` surface tensions, droplet number, effective
radius and albedo products. The Lowe variant set (``Lowe1977``,
``Lowe2019``, ``LoweEtAl2019`` kinetics and thermics) runs through K3.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..environments import Parcel
from ..initialisation import spectra
from ..initialisation.aerosol_composition import DryAerosolMixture
from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
from ..initialisation.sampling import spectral_sampling
from ..physics import Formulae, si
from ..products import (
    ActivatedParticleConcentration,
    ActivatedEffectiveRadius,
    ParcelDisplacement,
    PeakSupersaturation,
    WaterMixingRatio,
)

_R_STR = 8.31446261815324  # J/mol/K (CODATA; physics/constants.py)
LOWE_CONSTS = {
    "sgm_org": 40 * si.mN / si.m,
    # 0.2 nm in the paper; 0.1 matches the paper's fig 1c/1d plots
    "delta_min": 0.1 * si.nm,
    "MAC": 1,
    "HAC": 1,
    "c_pd": 1006 * si.joule / si.kilogram / si.kelvin,
    "g_std": 9.81 * si.metre / si.second**2,
    "Md": _R_STR / 287.058 * si.kg / si.mole,
    "Mv": _R_STR / 461.0 * si.kg / si.mole,
}

M_PALMITIC = 256.4 * si.g / si.mole
M_NH4_SO4 = 132.14 * si.g / si.mole
M_NACL = 58.44 * si.g / si.mole


class AerosolMarine(DryAerosolMixture):
    """Aitken (palmitic + ammonium sulfate) + accumulation (palmitic + NaCl)
    (reference ``Lowe_et_al_2019/aerosol.py:10-75``)"""

    def __init__(self, water_molar_volume, Forg=0.2, Acc_N2=137):
        super().__init__(
            compounds=("palmitic", "(NH4)2SO4", "NaCl"),
            molar_masses={
                "palmitic": M_PALMITIC,
                "(NH4)2SO4": M_NH4_SO4,
                "NaCl": M_NACL,
            },
            densities={
                "palmitic": 0.852 * si.g / si.cm**3,
                "(NH4)2SO4": 1.78 * si.g / si.cm**3,
                "NaCl": 2.165 * si.g / si.cm**3,
            },
            is_soluble={
                "palmitic": False,
                "(NH4)2SO4": True,
                "NaCl": True,
            },
            ionic_dissociation_phi={
                "palmitic": 1,
                "(NH4)2SO4": 3,
                "NaCl": 2,
            },
        )
        aitken = {"palmitic": Forg, "(NH4)2SO4": 1 - Forg, "NaCl": 0.0}
        accum = {"palmitic": Forg, "(NH4)2SO4": 0.0, "NaCl": 1 - Forg}
        self.modes = (
            {
                "kappa": self.kappa(aitken, water_molar_volume),
                "f_org": 1 - self.f_soluble_volume(aitken),
                "spectrum": spectra.Lognormal(
                    norm_factor=223 / si.cm**3,
                    m_mode=0.039 * si.um / 2,
                    s_geom=1.68,
                ),
            },
            {
                "kappa": self.kappa(accum, water_molar_volume),
                "f_org": 1 - self.f_soluble_volume(accum),
                "spectrum": spectra.Lognormal(
                    norm_factor=Acc_N2 / si.cm**3,
                    m_mode=0.139 * si.um / 2,
                    s_geom=1.68,
                ),
            },
        )
        self.color = "dodgerblue"


class AerosolBoreal(DryAerosolMixture):
    """boreal-forest mixture with higher organic fraction
    (reference ``Lowe_et_al_2019/aerosol.py:78-140``)"""

    def __init__(self, water_molar_volume, Forg=0.668, Acc_N2=540):
        super().__init__(
            compounds=("palmitic", "(NH4)2SO4", "NaCl"),
            molar_masses={
                "palmitic": M_PALMITIC,
                "(NH4)2SO4": M_NH4_SO4,
                "NaCl": M_NACL,
            },
            densities={
                "palmitic": 0.852 * si.g / si.cm**3,
                "(NH4)2SO4": 1.78 * si.g / si.cm**3,
                "NaCl": 2.165 * si.g / si.cm**3,
            },
            is_soluble={
                "palmitic": False,
                "(NH4)2SO4": True,
                "NaCl": True,
            },
            ionic_dissociation_phi={
                "palmitic": 1,
                "(NH4)2SO4": 3,
                "NaCl": 2,
            },
        )
        aitken = {"palmitic": Forg, "(NH4)2SO4": 1 - Forg, "NaCl": 0.0}
        accum = {"palmitic": Forg, "(NH4)2SO4": 1 - Forg, "NaCl": 0.0}
        self.modes = (
            {
                "kappa": self.kappa(aitken, water_molar_volume),
                "f_org": 1 - self.f_soluble_volume(aitken),
                "spectrum": spectra.Lognormal(
                    norm_factor=1110 / si.cm**3,
                    m_mode=0.0488 * si.um / 2,
                    s_geom=1.7,
                ),
            },
            {
                "kappa": self.kappa(accum, water_molar_volume),
                "f_org": 1 - self.f_soluble_volume(accum),
                "spectrum": spectra.Lognormal(
                    norm_factor=Acc_N2 / si.cm**3,
                    m_mode=0.168 * si.um / 2,
                    s_geom=1.7,
                ),
            },
        )
        self.color = "forestgreen"


def make_formulae(model):
    assert model in ("Constant", "CompressedFilmOvadnevaite")
    return Formulae(
        surface_tension=model,
        constants=LOWE_CONSTS,
        diffusion_kinetics="LoweEtAl2019",
        diffusion_thermics="LoweEtAl2019",
        latent_heat_vapourisation="Lowe2019",
        saturation_vapour_pressure="Lowe1977",
        optical_albedo="Bohren1987",
        optical_depth="Stephens1978",
    )


class Settings:
    def __init__(
        self,
        *,
        dz,
        n_sd_per_mode,
        aerosol,
        model,
        spectral_sampling_class=spectral_sampling.ConstantMultiplicity,
        w=0.32 * si.m / si.s,
    ):
        self.model = model
        self.n_sd_per_mode = n_sd_per_mode
        self.formulae = make_formulae(model)
        const = self.formulae.constants
        self.aerosol = aerosol
        self.spectral_sampling_class = spectral_sampling_class

        max_altitude = 200 * si.m
        self.w = w
        self.t_max = max_altitude / self.w
        self.dt = dz / self.w
        self.output_interval = self.dt

        self.p0 = 980 * si.mbar
        self.T0 = 280 * si.K
        pv0 = 0.999 * float(
            self.formulae.saturation_vapour_pressure.pvs_water(self.T0)
        )
        self.initial_water_vapour_mixing_ratio = (
            const.eps * pv0 / (self.p0 - pv0)
        )
        self.cloud_radius_range = (0.5 * si.micrometre, np.inf)
        self.mass_of_dry_air = 44
        self.wet_radius_bins_edges = np.logspace(
            np.log10(4 * si.um), np.log10(12 * si.um), 128 + 1, endpoint=True
        )

    @property
    def rho0(self):
        const = self.formulae.constants
        rhod0 = (
            float(
                self.formulae.trivia.p_d(
                    self.p0, self.initial_water_vapour_mixing_ratio
                )
            )
            / self.T0
            / const.Rd
        )
        return rhod0 * (1 + self.initial_water_vapour_mixing_ratio)

    @property
    def nt(self):
        nt = self.t_max / self.dt
        assert nt == int(nt)
        return int(nt)


class Simulation:
    def __init__(self, settings: Settings, products=None, backend_class=GPU):
        self.settings = settings
        env = Parcel(
            dt=settings.dt,
            mass_of_dry_air=settings.mass_of_dry_air,
            p0=settings.p0,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            T0=settings.T0,
            w=settings.w,
        )
        n_sd = settings.n_sd_per_mode * len(settings.aerosol.modes)
        builder = Builder(
            n_sd=n_sd,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())

        attributes = {
            k: np.empty(0)
            for k in (
                "dry volume",
                "dry volume organic",
                "kappa times dry volume",
                "multiplicity",
            )
        }
        for mode in settings.aerosol.modes:
            kappa = mode["kappa"][settings.model]
            r_dry, n_in_dv = settings.spectral_sampling_class(
                mode["spectrum"]
            ).sample(settings.n_sd_per_mode)
            v_dry = np.asarray(settings.formulae.trivia.volume(radius=r_dry))
            specific_concentration = (
                n_in_dv / settings.formulae.constants.rho_STP
            )
            attributes["multiplicity"] = np.append(
                attributes["multiplicity"],
                specific_concentration * env.mass_of_dry_air,
            )
            attributes["dry volume"] = np.append(
                attributes["dry volume"], v_dry
            )
            attributes["dry volume organic"] = np.append(
                attributes["dry volume organic"], mode["f_org"] * v_dry
            )
            attributes["kappa times dry volume"] = np.append(
                attributes["kappa times dry volume"], v_dry * kappa
            )
        if settings.model == "Constant":
            del attributes["dry volume organic"]
        r_wet = equilibrate_wet_radii(
            r_dry=np.asarray(
                settings.formulae.trivia.radius(
                    volume=attributes["dry volume"]
                )
            ),
            environment=env,
            kappa_times_dry_volume=attributes["kappa times dry volume"],
            f_org=(
                attributes["dry volume organic"] / attributes["dry volume"]
                if settings.model != "Constant"
                else None
            ),
        )
        attributes["volume"] = np.asarray(
            settings.formulae.trivia.volume(radius=r_wet)
        )
        products = products or (
            PeakSupersaturation(name="S_max"),
            WaterMixingRatio(
                name="liquid water mixing ratio",
                radius_range=settings.cloud_radius_range,
            ),
            ParcelDisplacement(name="z"),
            ActivatedParticleConcentration(
                name="CDNC", count_activated=True, count_unactivated=False
            ),
            ActivatedEffectiveRadius(
                name="r_eff", count_activated=True, count_unactivated=False
            ),
        )
        self.particulator = builder.build(attributes, products=products)

    def run(self):
        output = {name: [] for name in self.particulator.products}
        for _ in range(self.settings.nt):
            self.particulator.run(1)
            for name, product in self.particulator.products.items():
                output[name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
        return output
