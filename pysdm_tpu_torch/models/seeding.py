"""Cloud-seeding demo (port of ``pysdm_tpu/models/seeding.py``; reference
``examples/PySDM_examples/seeding/``: ``settings.py`` + ``simulation.py``):
time-dependent super-particle injection into an oscillating-updraft parcel.
An initial 75 nm lognormal aerosol (kappa = 0.5) condenses and collides; a
1 um seeding mode (kappa = 0.8) is injected at a prescribed rate into
NaN-multiplicity slots, and speeds rain formation through Geometric-kernel
coalescence.

Collisions take K1 on the mirror croupier at every N. Where n_sd_initial +
n_sd_seeding is not a multiple of 32768 the JAX package takes K1a with
``jax.random`` rows instead, so with collisions on the two packages agree
only statistically. ``Simulation`` builds on the ``GPU`` backend unless the
caller passes ``backend_class=CPU`` (the JAX package defaults to its
``CPU``)."""

import math

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation, Seeding
from ..dynamics.collisions.collision import Coalescence
from ..dynamics.collisions.collision_kernels import Geometric
from ..environments import Parcel
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..initialisation.spectra import Lognormal
from ..physics import si
from ..products import (
    EffectiveRadius,
    ParticleConcentration,
    SuperDropletCountPerGridbox,
    Time,
    WaterMixingRatio,
)


class Settings:
    def __init__(
        self,
        *,
        super_droplet_injection_rate,
        formulae,
        n_sd_initial: int = 100,
        n_sd_seeding: int = 100,
        rain_water_radius_threshold: float = 25 * si.um,
        enable_collisions: bool = True,
    ):
        self.enable_collisions = enable_collisions
        self.formulae = formulae
        self.n_sd_initial = n_sd_initial
        self.n_sd_seeding = n_sd_seeding
        self.rain_water_radius_threshold = rain_water_radius_threshold

        self.t_max = 25 * si.min
        self.w_max = 3 * si.m / si.s
        self.w_min = 0.025 * si.m / si.s
        self.timestep = 15 * si.s
        self.mass_of_dry_air = 666 * si.kg

        t_max = self.t_max
        w_min, w_max = self.w_min, self.w_max
        self.updraft = lambda t: w_min + (w_max - w_min) * max(
            0.0, math.sin(t / t_max * 2 * math.pi)
        ) ** 2
        self.initial_water_vapour_mixing_ratio = 666 / 30 * si.g / si.kg
        self.initial_total_pressure = 1000 * si.hPa
        self.initial_temperature = 300 * si.K
        self.initial_aerosol_kappa = 0.5
        self.initial_aerosol_dry_radii = Lognormal(
            norm_factor=200 / si.mg * self.mass_of_dry_air,
            m_mode=75 * si.nm,
            s_geom=1.6,
        )
        self.super_droplet_injection_rate = super_droplet_injection_rate

        r_dry, n_in_dv = ConstantMultiplicity(
            Lognormal(
                norm_factor=10 / si.mg * self.mass_of_dry_air,
                m_mode=1 * si.um,
                s_geom=1.1,
            )
        ).sample(n_sd=n_sd_seeding)
        v_dry = np.asarray(formulae.trivia.volume(radius=r_dry))
        self.seeded_particle_multiplicity = n_in_dv
        self.seeded_particle_extensive_attributes = {
            "signed water mass": np.full(n_sd_seeding, 0.0001 * si.ng),
            "dry volume": v_dry,
            "kappa times dry volume": 0.8 * v_dry,
        }


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU):
        self.settings = settings
        env = Parcel(
            dt=settings.timestep,
            mass_of_dry_air=settings.mass_of_dry_air,
            w=settings.updraft,
            initial_water_vapour_mixing_ratio=(
                settings.initial_water_vapour_mixing_ratio
            ),
            p0=settings.initial_total_pressure,
            T0=settings.initial_temperature,
        )
        builder = Builder(
            n_sd=settings.n_sd_seeding + settings.n_sd_initial,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        if settings.enable_collisions:
            builder.add_dynamic(Coalescence(collision_kernel=Geometric()))
        builder.add_dynamic(
            Seeding(
                super_droplet_injection_rate=(
                    settings.super_droplet_injection_rate
                ),
                seeded_particle_multiplicity=(
                    settings.seeded_particle_multiplicity
                ),
                seeded_particle_extensive_attributes=(
                    settings.seeded_particle_extensive_attributes
                ),
            )
        )
        r_dry, n_in_dv = ConstantMultiplicity(
            settings.initial_aerosol_dry_radii
        ).sample(n_sd=settings.n_sd_initial)
        attributes = env.init_attributes(
            n_in_dv=n_in_dv,
            kappa=settings.initial_aerosol_kappa,
            r_dry=r_dry,
        )
        # seeding slots: NaN multiplicity marks empty (reference pads with
        # NaN for multiplicity, zero for extensive attributes)
        self.particulator = builder.build(
            attributes={
                k: np.pad(
                    np.asarray(v, dtype=float),
                    pad_width=(0, settings.n_sd_seeding),
                    mode="constant",
                    constant_values=np.nan if k == "multiplicity" else 0,
                )
                for k, v in attributes.items()
            },
            products=(
                SuperDropletCountPerGridbox(name="sd_count"),
                Time(),
                WaterMixingRatio(
                    radius_range=(
                        settings.rain_water_radius_threshold,
                        np.inf,
                    ),
                    name="rain water mixing ratio",
                ),
                EffectiveRadius(
                    name="r_eff", radius_range=(0.5 * si.um, 25 * si.um)
                ),
                ParticleConcentration(
                    name="n_drop", radius_range=(0.5 * si.um, 25 * si.um)
                ),
            ),
        )
        self.n_steps = int(settings.t_max // settings.timestep)

    def run(self):
        output = {
            "attributes": {"water mass": []},
            "products": {key: [] for key in self.particulator.products},
        }
        for step in range(self.n_steps + 1):
            if step != 0:
                self.particulator.run(1)
            data = np.asarray(
                self.particulator.attributes["water mass"]
            ).astype(float)
            data[data == 0] = np.nan
            output["attributes"]["water mass"].append(data)
            for key in output["products"]:
                value = np.asarray(
                    self.particulator.products[key].get()
                ).reshape(-1)[0]
                output["products"][key].append(float(value))
        for out in ("attributes", "products"):
            for key, val in output[out].items():
                output[out][key] = np.array(val)
        return output
