"""Niedermeier et al. 2014 — time-dependent (ABIFM-style J_het) immersion
freezing in a mixed-phase adiabatic parcel (port of
``pysdm_tpu/models/niedermeier_et_al_2014.py``; reference
``examples/PySDM_examples/Niedermeier_et_al_2014/settings.py`` +
``simulation.py``): ammonium-sulphate CCN spectrum (Ervens & Feingold 2012
sampling, reference ``Ervens_and_Feingold_2012/settings.py``), one
IN-active mode split into ``in_sampling_n`` super-particles carrying an
immersed surface area, 300 m ascent at 0.2 m/s.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``). Its step:
AmbientThermodynamics, Condensation (K3), Freezing."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation, Freezing
from ..environments import Parcel
from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
from ..physics import si
from ..products import (
    AmbientTemperature,
    IceWaterContent,
    ParcelDisplacement,
)
from .ervens_and_feingold_2012 import (
    sampled_ccn_diameter_number_concentration_spectrum,
)


class Settings:
    def __init__(
        self,
        *,
        formulae,
        initial_temperature,
        timestep,
        ccn_sampling_n: int = 11,
        in_sampling_n: int = 20,
    ):
        self.ccn_sampling_n = ccn_sampling_n
        self.in_sampling_n = in_sampling_n
        self.timestep = timestep
        self.initial_temperature = initial_temperature
        self.formulae = formulae
        self.initial_relative_humidity = 0.985
        self.vertical_velocity = 20 * si.cm / si.s
        self.displacement = 300 * si.m
        self.kappa = 0.53  # ammonium sulfate (Tab. 1 in P&K07)
        self.mass_of_dry_air = 1e3 * si.kg
        self.ccn_dry_diameter_range = (10 * si.nm, 353 * si.nm)

    @property
    def p0(self):
        return 1000 * si.hPa

    @property
    def T0(self):
        return self.initial_temperature

    @property
    def pv0(self):
        pvs = float(
            self.formulae.saturation_vapour_pressure.pvs_water(self.T0)
        )
        return self.initial_relative_humidity * pvs

    @property
    def initial_water_vapour_mixing_ratio(self):
        pv0 = self.pv0
        return self.formulae.constants.eps * pv0 / (self.p0 - pv0)

    @property
    def rhod0(self):
        rho_v = self.pv0 / self.formulae.constants.Rv / self.T0
        return rho_v / self.initial_water_vapour_mixing_ratio


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        self.settings = settings
        n_particles = settings.ccn_sampling_n - 1 + settings.in_sampling_n
        env = Parcel(
            dt=settings.timestep,
            p0=settings.p0,
            T0=settings.T0,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            mass_of_dry_air=settings.mass_of_dry_air,
            w=settings.vertical_velocity,
            mixed_phase=True,
        )
        builder = Builder(
            n_sd=n_particles,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        builder.add_dynamic(Freezing(singular=False))

        air_volume = settings.mass_of_dry_air / settings.rhod0
        ccn_diameter, ccn_conc = (
            sampled_ccn_diameter_number_concentration_spectrum(
                size_range=settings.ccn_dry_diameter_range,
                n_sd=settings.ccn_sampling_n,
            )
        )
        trivia = settings.formulae.trivia
        dry_volume = np.asarray(trivia.volume(radius=ccn_diameter / 2))

        # the largest CCN bin doubles as the immersion-nuclei mode: it alone
        # carries immersed surface area and is split into in_sampling_n SDs
        immersed_surface_area = np.zeros_like(dry_volume)
        immersed_surface_area[-1] = float(
            trivia.sphere_surface(diameter=ccn_diameter[-1])
        )

        attributes = {
            "multiplicity": np.asarray(ccn_conc) * air_volume,
            "dry volume": dry_volume,
            "kappa times dry volume": settings.kappa * dry_volume,
            "immersed surface area": immersed_surface_area,
        }
        r_wet = equilibrate_wet_radii(
            r_dry=np.asarray(ccn_diameter) / 2,
            environment=env,
            kappa_times_dry_volume=attributes["kappa times dry volume"],
        )
        attributes["signed water mass"] = np.asarray(
            trivia.volume(radius=r_wet)
        ) * settings.formulae.constants.rho_w

        for attribute, data in attributes.items():
            attributes[attribute] = np.concatenate(
                (
                    data[:-1],
                    np.full(
                        settings.in_sampling_n,
                        (
                            data[-1]
                            if attribute != "multiplicity"
                            else data[-1] / settings.in_sampling_n
                        ),
                    ),
                )
            )

        products = (
            IceWaterContent(),
            ParcelDisplacement(name="z"),
            AmbientTemperature(name="T"),
        )
        self.particulator = builder.build(attributes, products=products)
        self.steps = int(
            settings.displacement
            / settings.vertical_velocity
            / settings.timestep
        )

    def run(self):
        output = {name: [] for name in self.particulator.products}
        for _ in range(self.steps + 1):
            for name, product in self.particulator.products.items():
                output[name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
            if self.particulator.n_steps < self.steps:
                self.particulator.run(1)
        return output
