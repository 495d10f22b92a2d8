"""Morrison & Grabowski 2007 (JAS 64): the single-eddy strato-cumulus 2D
kinematic framework (port of
``pysdm_tpu/models/morrison_and_grabowski_2007.py``; reference
``examples/PySDM_examples/Morrison_and_Grabowski_2007/common.py`` +
``strato_cumulus.py`` + ``fig_1.ipynb``). The Arabas et al. 2015 warm rain
derives from it (the same thermodynamic profile, th_std0 = 289 K, qv0 =
7.5 g/kg, p0 = 1015 hPa, and the same eddy stream function); here with
MG2007's process toggles, mixed-phase freezing among them, and the fig-1
velocity field.

With freezing on, the grid is mixed-phase and every super-droplet carries
a singular freezing temperature, a max-merged attribute, so coalescence
takes the float64 collision path (``Collision.route()`` "float64") as in
the JAX package. ``make_simulation`` builds on the ``GPU`` backend unless
the caller passes ``backend_class=CPU`` (the JAX package defaults to its
``CPU``)."""

import numpy as np

from ..backends import GPU
from ..impl import arakawa_c
from ..physics import si
from . import arabas_et_al_2015


class StratoCumulus(arabas_et_al_2015.Settings):
    """reference ``strato_cumulus.py:StratoCumulus(Common)``; the
    thermodynamic profile and stream function live in the shared Settings
    base (see its ``th_std0``/``stream_function``/``rhod_of_zZ``)"""

    def __init__(self, formulae=None, *, rhod_w_max, **kwargs):
        super().__init__(formulae, rhod_w_max=rhod_w_max, **kwargs)
        # MG2007 common.py process-toggle surface
        self.processes = {
            "particle advection": True,
            "fluid advection": True,
            "coalescence": True,
            "condensation": True,
            "sedimentation": True,
            "breakup": False,
            "freezing": False,
        }
        self.freezing_singular = True
        self.freezing_thaw = False
        self.freezing_inp_frac = 1
        const = self.formulae.constants
        self.T_bins_edges = np.linspace(
            const.T0 - 40, const.T0 - 20, 64, endpoint=True
        )
        n_bins_per_phase = 25
        self.terminal_velocity_radius_bin_edges = np.concatenate(
            [
                np.linspace(-n_bins_per_phase, -1, n_bins_per_phase + 1) * si.um,
                np.linspace(0, n_bins_per_phase, n_bins_per_phase + 1) * si.um,
            ]
        )


def velocity_field(settings: StratoCumulus):
    """(u, w) at the Arakawa-C face positions from the stream function —
    the reference fig-1 diagnostic (``fig_1.ipynb``): GC components scaled
    back to velocities by dx/dt (resp. dz/dt) and divided by rhod at the
    faces"""
    rho_times_courant = arakawa_c.nondivergent_vector_field_2d(
        settings.grid,
        settings.size,
        settings.dt,
        settings.stream_function,
        t=np.nan,
    )
    dx = settings.size[0] / settings.grid[0]
    dz = settings.size[-1] / settings.grid[-1]
    x_faces = arakawa_c.x_vec_coord(settings.grid)
    z_faces = arakawa_c.z_vec_coord(settings.grid)
    u = (
        np.asarray(rho_times_courant[0])
        * dx
        / settings.dt
        / settings.rhod_of_zZ(x_faces[-1])
    )
    w = (
        np.asarray(rho_times_courant[1])
        * dz
        / settings.dt
        / settings.rhod_of_zZ(z_faces[-1])
    )
    return {"u": u, "w": w, "x_faces": x_faces, "z_faces": z_faces}


def make_simulation(settings: StratoCumulus, backend_class=GPU, products=()):
    """2D kinematic simulation honoring the MG2007 freezing toggle
    (reference ``utils/kinematic_2d/simulation.py:140-174``): warm-process
    wiring is shared with the Arabas-2015 builder; with
    ``settings.processes['freezing']`` the environment goes mixed-phase,
    a singular freezing temperature (or immersed surface area) is sampled
    per particle from the dry size, and the Freezing dynamic is added."""
    from ..builder import Builder
    from ..dynamics import (
        AmbientThermodynamics,
        Coalescence,
        Condensation,
        Displacement,
        EulerianAdvection,
        Freezing,
    )
    from ..dynamics.eulerian_advection import MPDATA_2D
    from ..environments.kinematic_2d import Kinematic2D
    from ..initialisation.sampling.spatial_sampling import Pseudorandom

    freezing_on = settings.processes.get("freezing", False)
    if not freezing_on:
        return arabas_et_al_2015.make_simulation(
            settings, backend_class=backend_class, products=products
        )

    environment = Kinematic2D(
        dt=settings.dt,
        grid=settings.grid,
        size=settings.size,
        rhod_of=settings.rhod_of_zZ,
        mixed_phase=True,
    )
    builder = Builder(
        n_sd=settings.n_sd,
        backend=backend_class(formulae=settings.formulae),
        environment=environment,
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
    builder.add_dynamic(
        EulerianAdvection(
            MPDATA_2D(
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
        )
    )
    builder.add_dynamic(Displacement(enable_sedimentation=True))
    builder.add_dynamic(
        Coalescence(
            collision_kernel=settings.kernel,
            adaptive=settings.coalescence_adaptive,
        )
    )
    builder.add_dynamic(
        Freezing(
            singular=settings.freezing_singular, thaw=settings.freezing_thaw
        )
    )
    attributes = environment.init_attributes(
        spatial_discretisation=Pseudorandom(),
        dry_radius_spectrum=settings.spectrum_per_mass_of_dry_air,
        kappa=settings.kappa,
        seed=settings.formulae.seed,
    )
    attributes["signed water mass"] = attributes.pop("water mass")
    formulae = settings.formulae
    rng = np.random.default_rng(formulae.seed)
    immersed_surface_area = np.asarray(
        formulae.trivia.sphere_surface(
            diameter=2
            * np.asarray(
                formulae.trivia.radius(volume=attributes["dry volume"])
            )
        )
    )
    if settings.freezing_singular:
        attributes["freezing temperature"] = np.asarray(
            formulae.freezing_temperature_spectrum.invcdf(
                rng.random(immersed_surface_area.size), immersed_surface_area
            )
        )
    else:
        attributes["immersed surface area"] = immersed_surface_area
    particulator = builder.build(attributes, products=products)
    spin_up = arabas_et_al_2015.SpinUp(particulator, settings.n_spin_up)
    return particulator, spin_up
