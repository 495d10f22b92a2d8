"""Kreidenweis et al. 2003 (JGR 108) aqueous-chemistry parcel (port of
``pysdm_tpu/models/kreidenweis_et_al_2003.py``; reference
``examples/PySDM_examples/Kreidenweis_et_al_2003/settings.py`` +
``simulation.py``): ammonium-bisulfate aerosol, a parcel ascent with
condensation (K3, ``AugustRocheMagnus``), Henry-law dissolution and
S(IV) -> S(VI) oxidation in a closed system, pH and gas and aqueous
mole-fraction products.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, AqueousChemistry, Condensation
from ..dynamics.impl.chemistry_utils import AQUEOUS_COMPOUNDS
from ..environments import Parcel
from ..initialisation import spectra
from ..initialisation.sampling import spectral_sampling as spec_sampling
from ..physics import Formulae, si
from ..physics.si import PPB, PPM
from ..products import (
    Acidity,
    AmbientRelativeHumidity,
    AqueousMoleFraction,
    GaseousMoleFraction,
    ParcelDisplacement,
    TotalDryMassMixingRatio,
    WaterMixingRatio,
)

M_NH4HSO4 = 115.11 * si.g / si.mole  # ammonium bisulfate


class Settings:
    def __init__(
        self,
        *,
        dt,
        n_sd,
        n_substep,
        spectral_sampling_class=spec_sampling.Logarithmic,
    ):
        self.formulae = Formulae(
            seed=44,
            saturation_vapour_pressure="AugustRocheMagnus",
            constants={"g_std": 10 * si.m / si.s**2},
        )
        const = self.formulae.constants
        self.DRY_RHO = 1800 * si.kg / (si.m**3)
        self.dry_molar_mass = M_NH4HSO4
        self.system_type = "closed"
        self.t_max = (2400 + 196) * si.s
        self.output_interval = 10 * si.s
        self.dt = dt
        self.w = 0.5 * si.m / si.s
        self.n_sd = n_sd
        self.n_substep = n_substep
        self.p0 = 950 * si.mbar
        self.T0 = 285.2 * si.K
        pv0 = 0.95 * float(
            self.formulae.saturation_vapour_pressure.pvs_water(self.T0)
        )
        self.initial_water_vapour_mixing_ratio = (
            const.eps * pv0 / (self.p0 - pv0)
        )
        self.kappa = 0.61
        self.cloud_radius_range = (0.5 * si.micrometre, 25 * si.micrometre)
        self.mass_of_dry_air = 44
        rho0 = 1
        self.r_dry, self.n_in_dv = spectral_sampling_class(
            spectrum=spectra.Lognormal(
                norm_factor=566 / si.cm**3 / rho0 * self.mass_of_dry_air,
                m_mode=0.08 * si.um / 2,
                s_geom=2,
            )
        ).sample(n_sd)
        self.ENVIRONMENT_MOLE_FRACTIONS = {
            "SO2": 0.2 * PPB,
            "O3": 50 * PPB,
            "H2O2": 0.5 * PPB,
            "CO2": 360 * PPM,
            "HNO3": 0.1 * PPB,
            "NH3": 0.1 * PPB,
        }
        dry_moles = (
            np.asarray(self.formulae.trivia.volume(radius=self.r_dry))
            * self.DRY_RHO
            / self.dry_molar_mass
        )
        self.starting_amounts = {
            "moles_" + k: (
                dry_moles.copy()
                if k in ("N_mIII", "S_VI")
                else np.zeros(self.n_sd)
            )
            for k in AQUEOUS_COMPOUNDS
        }
        self.dry_radius_bins_edges = (
            np.logspace(
                np.log10(0.01 * si.um), np.log10(1 * si.um), 51, endpoint=True
            )
            / 2
        )

    @property
    def nt(self):
        nt = self.t_max / self.dt
        assert nt == int(nt)
        return int(nt)

    @property
    def steps_per_output_interval(self):
        return int(self.output_interval / self.dt)


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
        builder = Builder(
            n_sd=settings.n_sd,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        attributes = env.init_attributes(
            n_in_dv=settings.n_in_dv,
            kappa=settings.kappa,
            r_dry=settings.r_dry,
            include_dry_volume_in_attribute=False,
        )
        attributes = {**attributes, **settings.starting_amounts}
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        builder.add_dynamic(
            AqueousChemistry(
                environment_mole_fractions=settings.ENVIRONMENT_MOLE_FRACTIONS,
                system_type=settings.system_type,
                n_substep=settings.n_substep,
                dry_rho=settings.DRY_RHO,
                dry_molar_mass=settings.dry_molar_mass,
            )
        )
        products = products or (
            AmbientRelativeHumidity(name="RH"),
            WaterMixingRatio(
                name="liquid water mixing ratio",
                radius_range=list(settings.cloud_radius_range),
            ),
            ParcelDisplacement(name="z"),
            Acidity(
                name="pH",
                radius_range=settings.cloud_radius_range,
                weighting="volume",
            ),
            GaseousMoleFraction(key="S_IV", name="gas_S_IV"),
            AqueousMoleFraction(key="S_VI", name="aq_S_VI"),
            TotalDryMassMixingRatio(
                settings.DRY_RHO, name="total dry mass mixing ratio"
            ),
        )
        self.particulator = builder.build(attributes, products=products)

    def run(self):
        settings = self.settings
        output = {name: [] for name in self.particulator.products}
        output["t"] = []
        for step in range(
            0, settings.nt + 1, settings.steps_per_output_interval
        ):
            self.particulator.run(step - self.particulator.n_steps)
            output["t"].append(step * settings.dt)
            for name, product in self.particulator.products.items():
                output[name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
        return output
