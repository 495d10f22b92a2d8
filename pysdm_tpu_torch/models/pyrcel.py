"""Pyrcel-comparison adiabatic-parcel activation setup, config #3 (port of
``pysdm_tpu/models/pyrcel.py``; reference
``examples/PySDM_examples/Pyrcel/settings.py`` + ``simulation.py``):
multi-mode kappa-Koehler aerosol, a condensation-only parcel ascent and the
per-mode activated fractions.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``). Its
``scipy_solver`` option swaps the implicit condensation solve for
``utils/scipy_ode_condensation_solver.py``'s host ODE integration (a
cross-check, for tests)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..environments import Parcel
from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import si
from ..products import (
    AmbientRelativeHumidity,
    ParcelDisplacement,
    PeakSupersaturation,
    Time,
)


class Settings:
    def __init__(
        self,
        *,
        dz,
        n_sd_per_mode,
        aerosol_modes_by_kappa,
        vertical_velocity,
        initial_temperature,
        initial_pressure,
        initial_relative_humidity,
        displacement,
        formulae,
    ):
        self.formulae = formulae
        self.n_sd_per_mode = n_sd_per_mode
        self.aerosol_modes_by_kappa = aerosol_modes_by_kappa
        const = self.formulae.constants
        self.vertical_velocity = vertical_velocity
        self.initial_pressure = initial_pressure
        self.initial_temperature = initial_temperature
        pv0 = initial_relative_humidity * float(
            formulae.saturation_vapour_pressure.pvs_water(initial_temperature)
        )
        self.initial_vapour_mixing_ratio = (
            const.eps * pv0 / (initial_pressure - pv0)
        )
        self.t_max = displacement / vertical_velocity
        self.timestep = dz / vertical_velocity
        self.output_interval = self.timestep

    @property
    def initial_air_density(self):
        f = self.formulae
        rhod = (
            float(
                f.trivia.p_d(
                    self.initial_pressure, self.initial_vapour_mixing_ratio
                )
            )
            / self.initial_temperature
            / f.constants.Rd
        )
        return float(
            f.state_variable_triplet.rho_of_rhod_and_water_vapour_mixing_ratio(
                rhod, self.initial_vapour_mixing_ratio
            )
        )

    @property
    def nt(self):
        nt = self.t_max / self.timestep
        nt_int = round(nt)
        np.testing.assert_almost_equal(nt, nt_int)
        return nt_int

    @property
    def steps_per_output_interval(self):
        return int(self.output_interval / self.timestep)

    @property
    def output_steps(self):
        return np.arange(0, self.nt + 1, self.steps_per_output_interval)


class Simulation:
    def __init__(
        self, settings, products=None, backend_class=GPU,
        rtol_thd=1e-10, rtol_x=1e-10, scipy_solver=False,
    ):
        n_sd = sum(settings.n_sd_per_mode)
        self.settings = settings
        env = Parcel(
            dt=settings.timestep,
            p0=settings.initial_pressure,
            initial_water_vapour_mixing_ratio=settings.initial_vapour_mixing_ratio,
            T0=settings.initial_temperature,
            w=settings.vertical_velocity,
            mass_of_dry_air=44 * si.kg,
        )
        builder = Builder(
            n_sd=n_sd, backend=backend_class(settings.formulae), environment=env
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation(rtol_thd=rtol_thd, rtol_x=rtol_x))

        volume = env.mass_of_dry_air / settings.initial_air_density
        attributes = {
            k: np.empty(0)
            for k in ("dry volume", "kappa times dry volume", "multiplicity")
        }
        for i, (kappa, spectrum) in enumerate(
            settings.aerosol_modes_by_kappa.items()
        ):
            sampling = ConstantMultiplicity(spectrum)
            r_dry, n_per_volume = sampling.sample(settings.n_sd_per_mode[i])
            v_dry = np.asarray(settings.formulae.trivia.volume(radius=r_dry))
            attributes["multiplicity"] = np.append(
                attributes["multiplicity"], n_per_volume * volume
            )
            attributes["dry volume"] = np.append(attributes["dry volume"], v_dry)
            attributes["kappa times dry volume"] = np.append(
                attributes["kappa times dry volume"], v_dry * kappa
            )
        r_wet = equilibrate_wet_radii(
            r_dry=np.asarray(
                settings.formulae.trivia.radius(volume=attributes["dry volume"])
            ),
            environment=env,
            kappa_times_dry_volume=attributes["kappa times dry volume"],
        )
        attributes["volume"] = np.asarray(
            settings.formulae.trivia.volume(radius=r_wet)
        )
        products = products or (
            PeakSupersaturation(name="S_max"),
            AmbientRelativeHumidity(name="RH"),
            ParcelDisplacement(name="z"),
            Time(name="t"),
        )
        self.particulator = builder.build(attributes, products=products)
        if scipy_solver:
            from ..utils.scipy_ode_condensation_solver import (
                patch_particulator,
            )

            patch_particulator(self.particulator)
        self._sanity_checks(attributes, volume)

    def _sanity_checks(self, attributes, volume):
        for attribute in attributes.values():
            assert attribute.shape[0] == self.particulator.n_sd
        np.testing.assert_approx_equal(
            sum(attributes["multiplicity"]) / volume,
            sum(
                mode.norm_factor
                for mode in self.settings.aerosol_modes_by_kappa.values()
            ),
            significant=4,
        )

    def run(self, observers=()):
        for observer in observers:
            self.particulator.observers.append(observer)
        output = {
            "products": {
                name: [] for name in self.particulator.products
            },
            "attributes": {"volume": []},
        }
        for step in self.settings.output_steps:
            self.particulator.run(int(step) - self.particulator.n_steps)
            for name, product in self.particulator.products.items():
                output["products"][name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
            output["attributes"]["volume"].append(
                np.asarray(self.particulator.attributes["volume"]).copy()
            )
        return output
