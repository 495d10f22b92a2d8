"""Grabowski & Pawlowska 2023 (GRL): an adiabatic-parcel ripening study
(port of ``pysdm_tpu/models/grabowski_and_pawlowska_2023.py``; reference
``examples/PySDM_examples/Grabowski_and_Pawlowska_2023/settings.py`` +
``simulation.py``): pristine and polluted two-mode lognormal aerosol
(kappa = 1.28), a 1000 m ascent at a prescribed vertical velocity,
condensation tolerances of the reference default / 100 and a mass
accommodation coefficient of 0.3; the diagnostics are the ripening,
activating and deactivating rates and the droplet spectrum across
activation.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``). Its
``scipy_solver`` option swaps the implicit condensation solve for
``utils/scipy_ode_condensation_solver.py``'s host ODE integration (a
cross-check, for tests)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..dynamics.condensation import DEFAULTS as COND_DEFAULTS
from ..environments import Parcel
from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..initialisation.spectra import Lognormal, Sum
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    AmbientRelativeHumidity,
    ActivatingRate,
    DeactivatingRate,
    MeanRadius,
    ParcelDisplacement,
    PeakSupersaturation,
    RipeningRate,
    Time,
)

CONDENSATION_TOLERANCE = COND_DEFAULTS.rtol_thd / 100

AEROSOL_MODES_BY_KAPPA = {
    "pristine": {
        1.28: Sum(
            (
                Lognormal(
                    norm_factor=125 / si.cm**3, m_mode=11 * si.nm, s_geom=1.2
                ),
                Lognormal(
                    norm_factor=65 / si.cm**3, m_mode=60 * si.nm, s_geom=1.7
                ),
            )
        )
    },
    "polluted": {
        1.28: Sum(
            (
                Lognormal(
                    norm_factor=160 / si.cm**3, m_mode=29 * si.nm, s_geom=1.36
                ),
                Lognormal(
                    norm_factor=380 / si.cm**3, m_mode=71 * si.nm, s_geom=1.57
                ),
            )
        )
    },
}


class Settings:
    def __init__(
        self,
        *,
        aerosol: str,
        vertical_velocity: float,
        dt: float,
        n_sd: int,
        initial_temperature: float = 283 * si.K,
        initial_pressure: float = 900 * si.mbar,
        initial_relative_humidity: float = 0.97,
        displacement: float = 1000 * si.m,
        mass_accommodation_coefficient: float = 0.3,
        rtol_thd: float = CONDENSATION_TOLERANCE,
        rtol_x: float = CONDENSATION_TOLERANCE,
    ):
        self.formulae = Formulae(
            constants={"MAC": mass_accommodation_coefficient}
        )
        self.n_sd = n_sd
        self.aerosol_modes_by_kappa = AEROSOL_MODES_BY_KAPPA[aerosol]
        const = self.formulae.constants
        self.vertical_velocity = vertical_velocity
        self.initial_pressure = initial_pressure
        self.initial_temperature = initial_temperature
        pv0 = initial_relative_humidity * float(
            self.formulae.saturation_vapour_pressure.pvs_water(
                initial_temperature
            )
        )
        self.initial_vapour_mixing_ratio = (
            const.eps * pv0 / (initial_pressure - pv0)
        )
        self.t_max = displacement / vertical_velocity
        self.timestep = dt
        self.output_interval = self.timestep
        self.rtol_thd = rtol_thd
        self.rtol_x = rtol_x

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
        return rhod * (1 + self.initial_vapour_mixing_ratio)

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
        self,
        settings,
        products=None,
        backend_class=GPU,
        scipy_solver=False,
        sampling_class=ConstantMultiplicity,
    ):
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
            n_sd=settings.n_sd,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(
            Condensation(
                rtol_thd=settings.rtol_thd, rtol_x=settings.rtol_x
            )
        )

        volume = env.mass_of_dry_air / settings.initial_air_density
        assert len(settings.aerosol_modes_by_kappa.keys()) == 1
        kappa = tuple(settings.aerosol_modes_by_kappa.keys())[0]
        spectrum = settings.aerosol_modes_by_kappa[kappa]
        r_dry, n_per_volume = sampling_class(spectrum).sample(settings.n_sd)
        v_dry = np.asarray(settings.formulae.trivia.volume(radius=r_dry))
        attributes = {
            "multiplicity": n_per_volume * volume,
            "dry volume": v_dry,
            "kappa times dry volume": v_dry * kappa,
        }
        r_wet = equilibrate_wet_radii(
            r_dry=np.asarray(
                settings.formulae.trivia.radius(volume=v_dry)
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
            MeanRadius(name="r_mean"),
            RipeningRate(name="ripening rate"),
            ActivatingRate(name="activating rate"),
            DeactivatingRate(name="deactivating rate"),
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

    def run(self):
        output = {
            "products": {name: [] for name in self.particulator.products},
            "attributes": {"volume": [], "multiplicity": None},
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
        output["attributes"]["multiplicity"] = np.asarray(
            self.particulator.attributes["multiplicity"]
        ).copy()
        return output
