"""Yang et al. 2018 (ACP): a cloud-cycling parcel with an oscillating
updraft (port of ``pysdm_tpu/models/yang_et_al_2018.py``; reference
``examples/PySDM_examples/Yang_et_al_2018/settings.py`` + ``simulation.py``):
lognormal ammonium-sulphate-like aerosol (kappa = 0.53), 1200 s of constant
ascent, then a square-wave vertical velocity (period 1000 s) driving
repeated activation and deactivation; logarithm-of-mass diffusion
coordinate and August-Roche-Magnus saturation vapour pressure; diagnoses
ripening and the broadening of the droplet spectrum across cycles.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``); w(t) is
NumPy on the host, where the parcel's clock lives."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..dynamics.condensation import DEFAULTS as COND_DEFAULTS
from ..environments import Parcel
from ..initialisation import spectra
from ..initialisation.sampling import spectral_sampling
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    ActivatedMeanRadius,
    CondensationTimestepMin,
    CondensationTimestepMax,
    MeanRadius,
    ParticleSizeSpectrumPerVolume,
    RipeningRate,
    Time,
)

INITIAL_RELATIVE_HUMIDITY = 0.8561
INITIAL_TEMPERATURE = 284.3 * si.K
INITIAL_PRESSURE = 938.5 * si.hPa
INITIAL_ALTITUDE = 600 * si.m


class Settings:
    def __init__(self, n_sd: int = 100, dt_output: float = 1 * si.s,
                 dt_max: float = 1 * si.s, total_time: float = 3 * si.h):
        self.total_time = total_time
        self.mass_of_dry_air = 1000 * si.kg
        self.n_steps = int(self.total_time / (5 * si.s))
        self.n_sd = n_sd
        self.r_dry, self.n = spectral_sampling.Logarithmic(
            spectrum=spectra.Lognormal(
                norm_factor=1000 / si.mg * self.mass_of_dry_air,
                m_mode=50 * si.nm,
                s_geom=1.4,
            ),
            size_range=(10.633 * si.nm, 513.06 * si.nm),
        ).sample(n_sd)
        self.dt_max = dt_max
        self.dt_output = dt_output
        self.r_bins_edges = np.linspace(0, 20 * si.um, 101, endpoint=True)
        self.coord = "WaterMassLogarithm"
        self.adaptive = True
        self.rtol_x = COND_DEFAULTS.rtol_x
        self.rtol_thd = COND_DEFAULTS.rtol_thd
        self.dt_cond_range = COND_DEFAULTS.cond_range
        self.T0 = INITIAL_TEMPERATURE
        self.RH0 = INITIAL_RELATIVE_HUMIDITY
        self.p0 = INITIAL_PRESSURE
        self.z0 = INITIAL_ALTITUDE
        self.kappa = 0.53
        self.t0 = 1200 * si.s
        self.f0 = 1 / 1000 * si.hertz

    def w(self, t):
        """0.5 m/s ascent for t < t0, then a square wave (paper eq. 1)"""
        return 0.5 * np.where(
            t < self.t0,
            1.0,
            np.sign(-np.sin(2 * np.pi * self.f0 * (t - self.t0))),
        )


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        dt_output = settings.total_time / settings.n_steps
        self.n_substeps = 1
        while dt_output / self.n_substeps >= settings.dt_max:
            self.n_substeps += 1
        self.formulae = Formulae(
            diffusion_coordinate=settings.coord,
            saturation_vapour_pressure="AugustRocheMagnus",
        )
        env = Parcel(
            dt=dt_output / self.n_substeps,
            mass_of_dry_air=settings.mass_of_dry_air,
            p0=settings.p0,
            initial_water_vapour_mixing_ratio=self.formulae.constants.eps
            / (
                settings.p0
                / settings.RH0
                / float(
                    self.formulae.saturation_vapour_pressure.pvs_water(
                        settings.T0
                    )
                )
                - 1
            ),
            T0=settings.T0,
            w=settings.w,
            z0=settings.z0,
        )
        builder = Builder(
            backend=backend_class(self.formulae),
            n_sd=settings.n_sd,
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(
            Condensation(
                adaptive=settings.adaptive,
                rtol_x=settings.rtol_x,
                rtol_thd=settings.rtol_thd,
                dt_cond_range=settings.dt_cond_range,
            )
        )
        products = (
            ParticleSizeSpectrumPerVolume(
                name="Particles Wet Size Spectrum",
                radius_bins_edges=settings.r_bins_edges,
            ),
            CondensationTimestepMin(name="dt_cond_min"),
            CondensationTimestepMax(name="dt_cond_max"),
            RipeningRate(name="ripening rate"),
            MeanRadius(
                name="r_mean_gt_1_um", radius_range=(1 * si.um, np.inf)
            ),
            ActivatedMeanRadius(
                name="r_act", count_activated=True, count_unactivated=False
            ),
            Time(name="t"),
        )
        attributes = env.init_attributes(
            n_in_dv=settings.n, kappa=settings.kappa, r_dry=settings.r_dry
        )
        self.particulator = builder.build(attributes, products)
        self.n_steps = settings.n_steps

    def save(self, output):
        p = self.particulator
        output["r_bins_values"].append(
            np.asarray(p.products["Particles Wet Size Spectrum"].get()).copy()
        )
        volume = np.asarray(p.attributes["volume"])
        output["r"].append(
            np.asarray(self.formulae.trivia.radius(volume=volume))
        )
        output["S"].append(float(p.get_env("RH")[0]) - 1)
        output["t"].append(float(np.asarray(p.products["t"].get())))
        output["T"].append(float(p.get_env("T")[0]))
        output["z"].append(float(p.get_env("z")[0]))
        output["water_vapour_mixing_ratio"].append(float(p.get_env("qv")[0]))
        for key in ("dt_cond_max", "dt_cond_min", "ripening rate",
                    "r_mean_gt_1_um", "r_act"):
            output[key].append(
                float(np.asarray(p.products[key].get()).reshape(-1)[0])
            )

    def run(self):
        output = {
            key: []
            for key in (
                "r", "S", "z", "t", "water_vapour_mixing_ratio", "T",
                "r_bins_values", "dt_cond_max", "dt_cond_min",
                "ripening rate", "r_mean_gt_1_um", "r_act",
            )
        }
        self.save(output)
        for _ in range(self.n_steps):
            self.particulator.run(self.n_substeps)
            self.save(output)
        return output
