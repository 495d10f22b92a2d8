"""Arabas et al. 2015 (GMD 8) 2D warm-rain kinematic setup, config #5 (port
of ``pysdm_tpu/models/arabas_et_al_2015.py``; reference
``examples/PySDM_examples/Arabas_et_al_2015`` and
``Morrison_and_Grabowski_2007/strato_cumulus.py``): single-eddy
stream-function flow over a 1.5 x 1.5 km domain, two-mode lognormal
aerosol, condensation, coalescence, displacement with sedimentation, and a
1 h spin-up (collisions and sedimentation off) before rain forms.

``make_simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import (
    AmbientThermodynamics,
    Coalescence,
    Condensation,
    Displacement,
    EulerianAdvection,
)
from ..dynamics.eulerian_advection import MPDATA_2D
from ..dynamics.collisions.collision_kernels import Geometric
from ..initialisation import spectra
from ..initialisation.sampling.spatial_sampling import Pseudorandom
from ..environments.kinematic_2d import Kinematic2D
from ..physics import Formulae, si


class Settings:
    def __init__(
        self,
        formulae=None,
        *,
        grid=(25, 25),
        size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=20,
        rhod_w_max=0.6 * si.m / si.s * si.kg / si.m**3,
        simulation_time=90 * si.minute,
        spin_up_time=1 * si.hour,
    ):
        self.formulae = formulae or Formulae()
        const = self.formulae.constants
        self.grid = grid
        self.size = size
        self.dt = dt
        self.n_sd_per_gridbox = n_sd_per_gridbox
        self.rhod_w_max = rhod_w_max
        self.simulation_time = simulation_time
        self.spin_up_time = spin_up_time

        self.th_std0 = 289 * si.K
        self.initial_water_vapour_mixing_ratio = 7.5 * si.g / si.kg
        self.p0 = 1015 * si.hPa
        self.kappa = 1.0

        self.aerosol_radius_threshold = 0.5 * si.um
        self.drizzle_radius_threshold = 25 * si.um
        self.r_bins_edges = np.logspace(
            np.log10(0.001 * si.um), np.log10(100 * si.um), 64, endpoint=True
        )
        self.mode_1 = spectra.Lognormal(
            norm_factor=60 / si.cm**3 / const.rho_STP, m_mode=0.04 * si.um, s_geom=1.4
        )
        self.mode_2 = spectra.Lognormal(
            norm_factor=40 / si.cm**3 / const.rho_STP, m_mode=0.15 * si.um, s_geom=1.6
        )
        self.spectrum_per_mass_of_dry_air = spectra.Sum((self.mode_1, self.mode_2))

        self.kernel = Geometric(collection_efficiency=1)
        self.coalescence_adaptive = True
        self.condensation_adaptive = True
        self.mpdata_iters = 2
        self.mpdata_iga = True
        self.mpdata_fct = True
        self.output_interval = 1 * si.minute

    @property
    def n_sd(self):
        return self.grid[0] * self.grid[1] * self.n_sd_per_gridbox

    @property
    def n_steps(self):
        return int(self.simulation_time / self.dt)

    @property
    def n_spin_up(self):
        return int(self.spin_up_time / self.dt)

    def stream_function(self, xX, zZ, _):
        """single eddy (Arabas et al. 2015 eq. 36)"""
        X = self.size[0]
        return (
            -self.rhod_w_max * X / np.pi * np.sin(np.pi * zZ) * np.cos(2 * np.pi * xX)
        )

    def rhod_of_zZ(self, zZ):
        f = self.formulae
        p = f.hydrostatics.p_of_z_assuming_const_th_and_initial_water_vapour_mixing_ratio(
            self.p0, self.th_std0, self.initial_water_vapour_mixing_ratio,
            zZ * self.size[-1],
        )
        return np.asarray(
            f.state_variable_triplet.rho_d(
                p, self.initial_water_vapour_mixing_ratio, self.th_std0
            )
        )

    @property
    def initial_dry_potential_temperature_profile(self):
        return np.full(
            self.grid[-1],
            float(
                self.formulae.state_variable_triplet.th_dry(
                    self.th_std0, self.initial_water_vapour_mixing_ratio
                )
            ),
        )

    @property
    def initial_vapour_mixing_ratio_profile(self):
        return np.full(self.grid[-1], self.initial_water_vapour_mixing_ratio)


class SpinUp:
    """disable collisions and sedimentation for the first ``spin_up_steps``
    (reference ``Arabas_et_al_2015/spin_up.py``) through the step's flags"""

    def __init__(self, particulator, spin_up_steps):
        self.particulator = particulator
        self.spin_up_steps = spin_up_steps
        particulator.set_flag("collision_enable", False)
        particulator.set_flag("sedimentation_enable", False)

    def finish(self):
        self.particulator.set_flag("collision_enable", True)
        self.particulator.set_flag("sedimentation_enable", True)


def make_simulation(settings: Settings = None, backend_class=GPU, products=()):
    """build the full Arabas-2015 particulator (reference
    ``utils/kinematic_2d/simulation.py``); returns (particulator, spin_up)"""
    settings = settings or Settings()
    backend = backend_class(formulae=settings.formulae)
    environment = Kinematic2D(
        dt=settings.dt,
        grid=settings.grid,
        size=settings.size,
        rhod_of=settings.rhod_of_zZ,
    )
    builder = Builder(
        n_sd=settings.n_sd, backend=backend, environment=environment
    )
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=settings.condensation_adaptive))
    advectees = {
        "th": np.repeat(
            settings.initial_dry_potential_temperature_profile.reshape(1, -1),
            settings.grid[0],
            axis=0,
        ),
        "water_vapour_mixing_ratio": np.repeat(
            settings.initial_vapour_mixing_ratio_profile.reshape(1, -1),
            settings.grid[0],
            axis=0,
        ),
    }
    solver = MPDATA_2D(
        advectees=advectees,
        stream_function=settings.stream_function,
        rhod_of_zZ=settings.rhod_of_zZ,
        dt=settings.dt,
        grid=settings.grid,
        size=settings.size,
        n_iters=settings.mpdata_iters,
        infinite_gauge=settings.mpdata_iga,
        nonoscillatory=settings.mpdata_fct,
    )
    builder.add_dynamic(EulerianAdvection(solver))
    builder.add_dynamic(Displacement(enable_sedimentation=True))
    builder.add_dynamic(
        Coalescence(
            collision_kernel=settings.kernel,
            adaptive=settings.coalescence_adaptive,
        )
    )
    attributes = environment.init_attributes(
        spatial_discretisation=Pseudorandom(),
        dry_radius_spectrum=settings.spectrum_per_mass_of_dry_air,
        kappa=settings.kappa,
        seed=settings.formulae.seed,
    )
    particulator = builder.build(attributes, products=products)
    spin_up = SpinUp(particulator, settings.n_spin_up)
    return particulator, spin_up
