"""Abade & Albuquerque 2024 (QJRMS 150) — mixed-phase adiabatic parcel with
singular immersion freezing (Niemand et al. 2012 INAS spectrum) and vapour
deposition on ice, with Kaul-et-al-2015 bulk phase partitioning (port of
``pysdm_tpu/models/abade_and_albuquerque_2024.py``; reference
``examples/PySDM_examples/Abade_and_Albuquerque_2024/settings.py`` +
``simulation.py`` + ``fig_2.ipynb``): 100 m parcel rising at 0.5 m/s from
269 K, soluble lognormal aerosol (200/mg, 75 nm, sigma 1.6, kappa 0.6) of
which an ``inp_frac`` fraction carries ice-nucleating surface.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``). Its step:
AmbientThermodynamics, Condensation (K3, which leaves the ice alone),
Freezing, VapourDepositionOnIce."""

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
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..initialisation.spectra import Lognormal
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    AmbientTemperature,
    AmbientWaterVapourMixingRatio,
    ParcelDisplacement,
    SpecificIceWaterContent,
    WaterMixingRatio,
)


class Settings:
    def __init__(
        self,
        *,
        n_sd: int,
        timestep: float,
        enable_immersion_freezing: bool = True,
        enable_vapour_deposition_on_ice: bool = True,
        inp_frac: float = 0.1,
        seed: int = None,
    ):
        self.n_sd = n_sd
        self.timestep = timestep
        self.enable_immersion_freezing = enable_immersion_freezing
        self.enable_vapour_deposition_on_ice = (
            enable_vapour_deposition_on_ice
        )

        self.initial_total_pressure = 1000 * si.hPa  # not given in the paper

        # parameters from the paper
        self.formulae = Formulae(
            seed=seed,
            constants={
                "bulk_phase_partitioning_exponent": 0.1,
                "NIEMAND_A": -0.517,
                "NIEMAND_B": 8.934,
            },
            bulk_phase_partitioning="KaulEtAl2015",
            particle_shape_and_density="MixedPhaseSpheres",
            diffusion_coordinate="WaterMassLogarithm",
            freezing_temperature_spectrum="Niemand_et_al_2012",
        )
        self.initial_water_vapour_mixing_ratio = 1.5 * si.g / si.kg
        self.parcel_linear_extent = 100 * si.m
        self.updraft = 0.5 * si.m / si.s
        self.freezing_inp_frac = inp_frac
        self.freezing_inp_dry_radius = 0.5 * si.um

        thd_0 = float(
            self.formulae.state_variable_triplet.th_dry(
                269 * si.K, self.initial_water_vapour_mixing_ratio
            )
        )
        rhod_0 = float(
            self.formulae.state_variable_triplet.rho_d(
                self.initial_total_pressure,
                self.initial_water_vapour_mixing_ratio,
                thd_0,
            )
        )

        self.mass_of_dry_air = rhod_0 * float(
            self.formulae.trivia.volume(radius=self.parcel_linear_extent)
        )
        self.soluble_aerosol = Lognormal(
            norm_factor=200 / si.mg * self.mass_of_dry_air,
            m_mode=75 * si.nm,
            s_geom=1.6,
        )
        self.kappa = 0.6
        self.initial_temperature = float(
            self.formulae.state_variable_triplet.T(rhod_0, thd_0)
        )


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        self.settings = settings
        formulae = settings.formulae
        env = Parcel(
            dt=settings.timestep,
            mass_of_dry_air=settings.mass_of_dry_air,
            p0=settings.initial_total_pressure,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            T0=settings.initial_temperature,
            w=settings.updraft,
            mixed_phase=True,
        )
        builder = Builder(
            n_sd=settings.n_sd,
            backend=backend_class(formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        if settings.enable_immersion_freezing:
            builder.add_dynamic(Freezing())
        if settings.enable_vapour_deposition_on_ice:
            builder.add_dynamic(VapourDepositionOnIce())

        r_dry, n_in_dv = ConstantMultiplicity(
            settings.soluble_aerosol
        ).sample(n_sd=settings.n_sd)
        attributes = env.init_attributes(
            n_in_dv=n_in_dv, kappa=settings.kappa, r_dry=r_dry
        )
        attributes["signed water mass"] = np.asarray(
            formulae.particle_shape_and_density.volume_to_mass(
                attributes.pop("volume")
            )
        )

        if settings.enable_immersion_freezing:
            trivia = formulae.trivia
            n_inp = int(settings.n_sd * settings.freezing_inp_frac)
            rng = np.random.default_rng(seed=formulae.seed)
            attributes["freezing temperature"] = rng.permutation(
                np.pad(
                    np.asarray(
                        formulae.freezing_temperature_spectrum.invcdf(
                            rng.uniform(low=0, high=1, size=n_inp),
                            float(
                                trivia.sphere_surface(
                                    diameter=2
                                    * settings.freezing_inp_dry_radius
                                )
                            ),
                        )
                    ),
                    (0, settings.n_sd - n_inp),
                    mode="constant",
                    constant_values=(float(trivia.C2K(-38.0))),
                )
            )

        self.products = (
            WaterMixingRatio(name="water", radius_range=(0, np.inf)),
            SpecificIceWaterContent(name="ice"),
            ParcelDisplacement(name="height"),
            AmbientTemperature(name="T"),
            AmbientWaterVapourMixingRatio(name="vapour"),
        )
        self.particulator = builder.build(
            attributes, products=self.products
        )

    def run(self, *, nt, steps_per_output_interval):
        output = {name: [] for name in self.particulator.products}
        while True:
            for name, product in self.particulator.products.items():
                output[name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
            if self.particulator.n_steps >= nt:
                break
            self.particulator.run(
                min(
                    steps_per_output_interval,
                    nt - self.particulator.n_steps,
                )
            )
        return {"products": {k: np.asarray(v) for k, v in output.items()}}
