"""Arabas & Shima 2017 (Nonlin. Processes Geophys. 24) single-super-droplet
oscillating-parcel activation and deactivation setup (port of
``pysdm_tpu/models/arabas_and_shima_2017.py``; reference
``examples/PySDM_examples/Arabas_and_Shima_2017/settings.py`` +
``simulation.py``): a sinusoidal vertical velocity w(t) drives RH across the
activation threshold; the droplet's growth and evaporation hysteresis loop
is the paper's fig. 5. August-Roche-Magnus saturation vapour pressure.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``); w(t) is
NumPy on the host, where the parcel's clock lives."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..dynamics.condensation import DEFAULTS as COND_DEFAULTS
from ..environments import Parcel
from ..physics import Formulae, si
from ..products import (
    AmbientRelativeHumidity,
    ParcelDisplacement,
    Time,
)

N_SD = 1  # single super-droplet (the paper's setup)


class Settings:
    def __init__(
        self,
        *,
        w_avg,
        N_STP,
        r_dry,
        mass_of_dry_air,
        coord="WaterMassLogarithm",
        n_output=500,
    ):
        self.formulae = Formulae(
            saturation_vapour_pressure="AugustRocheMagnus",
            diffusion_coordinate=coord,
        )
        const = self.formulae.constants
        self.p0 = 1000 * si.hectopascals
        self.RH0 = 0.98
        self.kappa = 0.2
        self.T0 = 300 * si.kelvin
        self.z_half = 150 * si.metres
        pvs = float(self.formulae.saturation_vapour_pressure.pvs_water(self.T0))
        self.initial_water_vapour_mixing_ratio = const.eps / (
            self.p0 / self.RH0 / pvs - 1
        )
        self.w_avg = w_avg
        self.r_dry = r_dry
        self.N_STP = N_STP
        self.n_in_dv = N_STP / const.rho_STP * mass_of_dry_air
        self.mass_of_dry_air = mass_of_dry_air
        self.n_output = n_output
        self.rtol_x = COND_DEFAULTS.rtol_x
        self.rtol_thd = COND_DEFAULTS.rtol_thd
        self.dt_cond_range = COND_DEFAULTS.cond_range

    @property
    def t_total(self):
        return 2 * self.z_half / self.w_avg

    @property
    def dt_max(self):
        result = self.t_total / self.n_output
        if result < 1 * si.centimetre / si.second:
            result /= 100
        return result

    def w(self, t):
        return (
            self.w_avg
            * np.pi
            / 2
            * np.sin(np.pi * t / self.z_half * self.w_avg)
        )


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        self.settings = settings
        env = Parcel(
            dt=settings.dt_max,
            mass_of_dry_air=settings.mass_of_dry_air,
            p0=settings.p0,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            T0=settings.T0,
            w=settings.w,
        )
        builder = Builder(
            n_sd=N_SD, backend=backend_class(settings.formulae), environment=env
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(
            Condensation(rtol_x=settings.rtol_x, rtol_thd=settings.rtol_thd)
        )
        attributes = env.init_attributes(
            n_in_dv=settings.n_in_dv,
            kappa=settings.kappa,
            r_dry=settings.r_dry,
        )
        products = (
            AmbientRelativeHumidity(name="RH"),
            ParcelDisplacement(name="z"),
            Time(name="t"),
        )
        self.particulator = builder.build(attributes, products=products)

    def run(self):
        settings = self.settings
        n_steps = settings.n_output
        output = {"RH": [], "z": [], "t": [], "r": []}
        for _ in range(n_steps):
            self.particulator.run(1)
            output["RH"].append(
                float(np.asarray(self.particulator.products["RH"].get())[0])
            )
            output["z"].append(
                float(np.asarray(self.particulator.products["z"].get())[0])
            )
            output["t"].append(self.particulator.products["t"].get())
            output["r"].append(
                float(np.asarray(self.particulator.attributes["radius"])[0])
            )
        return output
