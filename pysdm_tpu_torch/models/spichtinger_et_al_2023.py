"""Spichtinger et al. 2023 (ACP 23) — cirrus formation by homogeneous
freezing of solution droplets in a fast-ascending cold parcel (port of
``pysdm_tpu/models/spichtinger_et_al_2023.py``; reference
``examples/PySDM_examples/Spichtinger_et_al_2023/settings.py`` +
``simulation.py`` + ``fig_B1.ipynb``): lognormal solution-droplet spectrum
(2500/cm^3, r=0.055 um, sigma=1.6), Koop-rate homogeneous nucleation
(``Koop_Correction`` variant), mixed-phase spheres, vapour deposition on
the nucleated ice.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``). Its step:
AmbientThermodynamics, Condensation (K3, which leaves the ice alone),
VapourDepositionOnIce, Freezing."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import (
    AmbientThermodynamics,
    Condensation,
    Freezing,
    VapourDepositionOnIce,
)
from ..environments import Parcel
from ..initialisation.sampling.spectral_sampling import Linear
from ..initialisation.spectra import Lognormal
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    AmbientRelativeHumidityWrtIce,
    AmbientTemperature,
    ParcelDisplacement,
    ParticleConcentration,
    SpecificIceWaterContent,
    Time,
)


class Settings:
    def __init__(self, *, n_sd: int, w_updraft: float, T0: float, seed: int,
                 dt: float):
        self.n_sd = n_sd
        self.w_updraft = w_updraft

        self.N_dv_solution_droplet = 2500 / si.cm**3
        self.r_mean_solution_droplet = 0.055 * si.um
        self.sigma_solution_droplet = 1.6

        self.mass_of_dry_air = 1000 * si.kg
        self.initial_pressure = 200 * si.hPa
        self.initial_ice_supersaturation = 1.0
        self.kappa = 0.64
        self.initial_temperature = T0

        self.formulae = Formulae(
            particle_shape_and_density="MixedPhaseSpheres",
            homogeneous_ice_nucleation_rate="Koop_Correction",
            seed=seed,
        )
        const = self.formulae.constants
        pvs_i = float(
            self.formulae.saturation_vapour_pressure.pvs_ice(
                self.initial_temperature
            )
        )
        self.initial_water_vapour_mixing_ratio = const.eps / (
            self.initial_pressure / self.initial_ice_supersaturation / pvs_i
            - 1
        )
        dry_air_density = (
            float(
                self.formulae.trivia.p_d(
                    self.initial_pressure,
                    self.initial_water_vapour_mixing_ratio,
                )
            )
            / self.initial_temperature
            / const.Rd
        )

        spectrum = Lognormal(
            norm_factor=self.N_dv_solution_droplet / dry_air_density,
            m_mode=self.r_mean_solution_droplet,
            s_geom=self.sigma_solution_droplet,
        )
        self.r_dry, self.specific_concentration = Linear(spectrum).sample(
            n_sd
        )

        self.t_duration = 7200
        self.dt = dt
        self.n_output = int(self.t_duration / 100)


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        self.settings = settings
        formulae = settings.formulae
        env = Parcel(
            mixed_phase=True,
            dt=settings.dt,
            mass_of_dry_air=settings.mass_of_dry_air,
            p0=settings.initial_pressure,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            T0=settings.initial_temperature,
            w=settings.w_updraft,
        )
        builder = Builder(
            n_sd=settings.n_sd,
            backend=backend_class(formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        builder.add_dynamic(VapourDepositionOnIce())
        builder.add_dynamic(
            Freezing(
                singular=False,
                homogeneous_freezing=True,
                immersion_freezing=False,
            )
        )

        multiplicity = np.asarray(
            settings.specific_concentration * settings.mass_of_dry_air
        )
        attributes = env.init_attributes(
            n_in_dv=multiplicity,
            kappa=settings.kappa,
            r_dry=np.asarray(settings.r_dry),
        )
        attributes["signed water mass"] = np.asarray(
            formulae.particle_shape_and_density.volume_to_mass(
                attributes.pop("volume")
            )
        )
        products = (
            Time(name="t"),
            AmbientRelativeHumidityWrtIce(name="RH_ice"),
            ParticleConcentration(
                name="n_i", radius_range=(-np.inf, 0)
            ),
            SpecificIceWaterContent(name="qi"),
            AmbientTemperature(name="T"),
            ParcelDisplacement(name="z"),
        )
        self.particulator = builder.build(attributes, products=products)

    def run(self, n_steps=None, steps_per_output=None):
        settings = self.settings
        n_steps = n_steps or int(settings.t_duration / settings.dt)
        steps_per_output = steps_per_output or max(
            1, n_steps // settings.n_output
        )
        output = {name: [] for name in self.particulator.products}
        while True:
            for name, product in self.particulator.products.items():
                output[name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
            if self.particulator.n_steps >= n_steps:
                break
            self.particulator.run(
                min(steps_per_output, n_steps - self.particulator.n_steps)
            )
        return {key: np.asarray(val) for key, val in output.items()}
