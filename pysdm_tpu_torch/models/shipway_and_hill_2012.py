"""Shipway and Hill 2012 (QJRMS 138) single-column kinematic setup, config #4
(port of ``pysdm_tpu/models/shipway_and_hill_2012.py``; reference
``examples/PySDM_examples/Shipway_and_Hill_2012/settings.py``,
``simulation.py`` and ``mpdata_1d.py``): a prescribed updraft rho*w =
rho_w_1 sin(pi t / t_1) for t < t_1, MPDATA vapour advection,
condensation, coalescence, and displacement with sedimentation and surface
precipitation counted at the top of a particle reservoir below z = 0.

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import math

import numpy as np

from ..backends import GPU
from ..builder import Builder
from ..dynamics import (
    AmbientThermodynamics,
    Coalescence,
    Condensation,
    Displacement,
    EulerianAdvection,
)
from ..dynamics.collisions.collision_kernels import Geometric
from ..dynamics.eulerian_advection import MPDATA_1D
from ..environments import Kinematic1D
from ..impl.mesh import Mesh
from ..initialisation import spectra
from ..initialisation.sampling.spatial_sampling import Pseudorandom
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import Formulae, si
from ..products import (
    AmbientRelativeHumidity,
    AmbientTemperature,
    CloudWaterContent,
    EffectiveRadius,
    PeakSupersaturation,
    SurfacePrecipitation,
    WaterMixingRatio,
)


class Settings:
    def __init__(
        self,
        *,
        n_sd_per_gridbox,
        p0=1007 * si.hPa,  # as used in Olesik et al. 2022 (GMD)
        kappa=1.0,
        rho_times_w_1=2 * si.m / si.s * si.kg / si.m**3,
        particles_per_volume_STP=50 / si.cm**3,
        dt=1 * si.s,
        dz=25 * si.m,
        z_max=3000 * si.m,
        t_max=60 * si.minutes,
        precip=True,
        formulae=None,
        collision_kernel=None,
        enable_condensation=True,
        z_part=None,
        seed=44,
    ):
        self.formulae = formulae or Formulae(seed=seed)
        const = self.formulae.constants
        self.n_sd_per_gridbox = n_sd_per_gridbox
        self.p0 = p0
        self.kappa = kappa
        self.rho_times_w_1 = rho_times_w_1
        self.particles_per_volume_STP = particles_per_volume_STP
        self.dt = dt
        self.dz = dz
        self.precip = precip
        self.z_max = z_max
        self.t_max = t_max
        self.enable_condensation = enable_condensation
        self.z_part = z_part
        self.seed = seed
        self.collision_kernel = collision_kernel or Geometric(
            collection_efficiency=1
        )
        self.t_1 = 600 * si.s
        # particle reservoir below z = 0 (reference ``settings.py:73-77``):
        # keeps the surface layer stocked with super-droplets while the
        # updraft carries them out of the lower cells
        apprx_w1 = rho_times_w_1 / const.rho_STP
        self.particle_reservoir_depth = (
            (2 * apprx_w1 * self.t_1 / np.pi) // dz + 1
        ) * dz

        self.wet_radius_spectrum_per_mass_of_dry_air = spectra.Lognormal(
            norm_factor=particles_per_volume_STP / const.rho_STP,
            m_mode=0.08 / 2 * si.um,
            s_geom=1.4,
        )
        # idealised stable profiles (the reference's interp1d tables,
        # ``settings.py:84-96``)
        self._th_std = lambda z: np.interp(
            z, (0.0, 740.0, 3260.0), (297.9, 297.9, 312.66)
        )
        self.water_vapour_mixing_ratio = lambda z: np.interp(
            z, (0.0, 740.0, 3260.0), (0.015, 0.0138, 0.0024)
        )
        f = self.formulae

        def thd_of_z(z):
            return np.asarray(
                f.state_variable_triplet.th_dry(
                    self._th_std(z), self.water_vapour_mixing_ratio(z)
                )
            )

        def rhod_of_z(z):
            z = np.maximum(np.asarray(z, dtype=float), 0.0)  # flat below 0
            p = f.hydrostatics.p_of_z_assuming_const_th_and_initial_water_vapour_mixing_ratio(
                self.p0, self._th_std(0.0),
                self.water_vapour_mixing_ratio(0.0), z,
            )
            return np.asarray(
                f.state_variable_triplet.rho_d(
                    p, self.water_vapour_mixing_ratio(z), self._th_std(z)
                )
            )

        self.thd_of_z = thd_of_z
        self.rhod_of_z = rhod_of_z

    def rho_times_w(self, t):
        """the prescribed updraft at time t (a host float)"""
        return self.rho_times_w_1 * math.sin(math.pi * t / self.t_1) * (t < self.t_1)

    @property
    def nz(self):
        # column cells including the below-surface particle reservoir
        # (reference settings.py:176-182)
        assert self.particle_reservoir_depth % self.dz == 0
        nz = (self.z_max + self.particle_reservoir_depth) / self.dz
        assert nz == int(nz)
        return int(nz)

    @property
    def nt(self):
        assert self.t_max % self.dt == 0
        return int(self.t_max / self.dt)

    @property
    def n_sd(self):
        return self.nz * self.n_sd_per_gridbox


class Simulation:
    def __init__(self, settings: Settings, backend_class=GPU, products=None):
        self.settings = settings
        self.nt = settings.nt
        self.z0 = -settings.particle_reservoir_depth
        mesh = Mesh(
            grid=(settings.nz,),
            size=(settings.z_max + settings.particle_reservoir_depth,),
        )
        env = Kinematic1D(
            dt=settings.dt,
            mesh=mesh,
            thd_of_z=settings.thd_of_z,
            rhod_of_z=settings.rhod_of_z,
            water_vapour_mixing_ratio_of_z=settings.water_vapour_mixing_ratio,
            z0=self.z0,
        )
        z_faces = self.z0 + settings.dz * np.arange(settings.nz + 1)
        z_centres = self.z0 + settings.dz * (np.arange(settings.nz) + 0.5)
        mpdata = MPDATA_1D(
            nz=settings.nz,
            dt=settings.dt,
            advector_of_t=lambda t: settings.rho_times_w(t)
            * settings.dt
            / settings.dz,
            g_factor_z=settings.rhod_of_z(z_centres),
            g_factor_z_faces=settings.rhod_of_z(z_faces),
        )
        builder = Builder(
            n_sd=settings.n_sd,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.add_dynamic(AmbientThermodynamics())
        if settings.enable_condensation:
            builder.add_dynamic(Condensation(adaptive=True))
        builder.add_dynamic(EulerianAdvection(mpdata))
        builder.add_dynamic(
            Coalescence(collision_kernel=settings.collision_kernel, adaptive=True)
        )
        builder.add_dynamic(
            Displacement(
                enable_sedimentation=settings.precip,
                precipitation_counting_level_index=int(
                    settings.particle_reservoir_depth // settings.dz
                ),
            )
        )
        attributes = env.init_attributes(
            spatial_discretisation=Pseudorandom(),
            spectral_discretisation=ConstantMultiplicity(
                settings.wet_radius_spectrum_per_mass_of_dry_air
            ),
            kappa=settings.kappa,
            collisions_only=not settings.enable_condensation,
            z_part=settings.z_part,
            seed=settings.seed,
        )
        products = products or (
            AmbientRelativeHumidity(name="RH"),
            AmbientTemperature(name="T"),
            WaterMixingRatio(name="qc", radius_range=(1 * si.um, np.inf)),
            CloudWaterContent(name="cwc"),
            EffectiveRadius(name="reff", radius_range=(1 * si.um, np.inf)),
            *(
                (PeakSupersaturation(name="S_max"),)
                if settings.enable_condensation
                else ()
            ),
            SurfacePrecipitation(name="surf_precip"),
        )
        self.particulator = builder.build(attributes, products=products)

    def run(self, nt=None, steps_per_output=60):
        """run to step ``nt`` (the settings' t_max by default), reading every
        product each ``steps_per_output`` steps; returns the profiles by
        product name, and ``"t"``"""
        nt = nt if nt is not None else self.nt
        output = {name: [] for name in self.particulator.products}
        output["t"] = []
        for step in range(0, nt + 1, steps_per_output):
            self.particulator.run(step - self.particulator.n_steps)
            output["t"].append(step * self.settings.dt)
            for name, product in self.particulator.products.items():
                output[name].append(np.asarray(product.get()).copy())
        return output
