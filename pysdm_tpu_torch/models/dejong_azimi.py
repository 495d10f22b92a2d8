"""de Jong & Azimi box and 1D rain-shaft collision benchmarks, compared in
the reference with the Cloudy.jl bulk-moment scheme (port of
``pysdm_tpu/models/dejong_azimi.py``; reference
``examples/PySDM_examples/deJong_Azimi/{simulation_0D,settings1D}.py``): 0D
Golovin coalescence tracking the first three volume moments on K1
(``ops/cuda/collision.py``), and a Shipway and Hill 2012 column with
condensation off and a Golovin kernel, through the port's column
``Simulation`` on K2 and K4.

``run_box`` and the column's ``Simulation`` build on the ``GPU`` backend
unless the caller passes ``backend_class=CPU`` (the JAX package defaults
to its ``CPU``)."""

from collections import namedtuple

import numpy as np

from ..backends import GPU
from ..builder import Builder
from ..dynamics import Coalescence
from ..dynamics.collisions.coalescence_efficiencies import ConstEc
from ..dynamics.collisions.collision_kernels import Golovin
from ..environments import Box
from ..initialisation import spectra
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import Formulae, si
from ..products import (
    ParticleVolumeVersusRadiusLogarithmSpectrum,
    VolumeFirstMoment,
    VolumeSecondMoment,
    ZerothMoment,
)
from .shipway_and_hill_2012 import Settings as SettingsSH


class Settings0D:
    """reference ``deJong_Azimi/box.ipynb`` Settings0D, the Cloudy.jl
    moment-comparison setup (``cloudy_data_0d.py``): a Gamma(k = 1, theta =
    1e5 um^3) spectrum at 100/cm^3, Golovin b = 5e3/s, moments at t =
    0/60/120 s"""

    def __init__(self, *, kernel=None, steps=(0, 60, 120), n_sd=2**12,
                 dt=1 * si.s, seed=44, radius_bins_edges=None):
        self.n_sd = n_sd
        self.n_part = 100 / si.cm**3
        self.dt = dt
        self.dv = 1 * si.m**3
        self.rho = 1000 * si.kg / si.m**3
        self.rhod = 1 * si.kg / si.m**3
        self.formulae = Formulae(terminal_velocity="PowerSeries", seed=seed)
        self.kernel = kernel or Golovin(b=5e3 / si.s)
        self.coal_eff = ConstEc(1.0)
        self.adaptive = True
        self.steps = steps
        self.radius_bins_edges = (
            radius_bins_edges
            if radius_bins_edges is not None
            else np.logspace(
                np.log10(8.0 * si.um), np.log10(5e3 * si.um),
                num=64, endpoint=True,
            )
        )
        self.spectrum = spectra.Gamma(
            norm_factor=self.n_part * self.dv, k=1.0, theta=1e5 * si.um**3
        )


def run_box(settings, backend_class=GPU):
    """reference ``deJong_Azimi/simulation_0D.py:19-57``: the dv/dlnr
    spectrum and the volume moments M0, M1, M2 at ``settings.steps``"""
    builder = Builder(
        n_sd=settings.n_sd,
        backend=backend_class(settings.formulae),
        environment=Box(dv=settings.dv, dt=settings.dt),
    )
    builder.particulator.environment["rhod"] = settings.rhod
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        settings.spectrum
    ).sample(settings.n_sd)
    builder.add_dynamic(
        Coalescence(
            collision_kernel=settings.kernel,
            coalescence_efficiency=settings.coal_eff,
            adaptive=settings.adaptive,
        )
    )
    products = (
        ParticleVolumeVersusRadiusLogarithmSpectrum(
            radius_bins_edges=settings.radius_bins_edges, name="dv/dlnr"
        ),
        ZerothMoment(name="M0"),
        VolumeFirstMoment(name="M1"),
        VolumeSecondMoment(name="M2"),
    )
    particulator = builder.build(attributes, products)

    y = np.ndarray((len(settings.steps), len(settings.radius_bins_edges) - 1))
    mom = np.ndarray((len(settings.steps), 3))
    for i, step in enumerate(settings.steps):
        particulator.run(step - particulator.n_steps)
        y[i] = particulator.products["dv/dlnr"].get()[0]
        for k, name in enumerate(("M0", "M1", "M2")):
            mom[i, k] = float(particulator.products[name].get()[0])

    return namedtuple("_", ("radius_bins_left_edges", "dv_dlnr", "moments"))(
        radius_bins_left_edges=settings.radius_bins_edges[:-1],
        dv_dlnr=y,
        moments=mom,
    )


class Settings1D(SettingsSH):
    """reference ``deJong_Azimi/settings1D.py``: the Shipway and Hill 2012
    column with condensation off, Golovin(b = 5e3) collisions and a wet
    Gamma(k = 1, theta = 1e5 um^3) spectrum seeded in the z_part band; run
    it through ``shipway_and_hill_2012.Simulation``"""

    def __init__(
        self,
        *,
        n_sd_per_gridbox,
        dt=1 * si.s,
        dz=25 * si.m,
        z_max=3000 * si.m,
        t_max=60 * si.minutes,
        precip=True,
        z_part=(0.5, 0.75),
        seed=44,
    ):
        super().__init__(
            n_sd_per_gridbox=n_sd_per_gridbox,
            particles_per_volume_STP=100 / si.cm**3,
            dt=dt,
            dz=dz,
            z_max=z_max,
            t_max=t_max,
            precip=precip,
            collision_kernel=Golovin(b=5e3 / si.s),
            enable_condensation=False,
            z_part=z_part,
            formulae=Formulae(terminal_velocity="PowerSeries", seed=seed),
            seed=seed,
        )
        self.z_part = z_part
        z_frac = z_part[1] - z_part[0]
        self.wet_radius_spectrum_per_mass_of_dry_air = spectra.Gamma(
            norm_factor=(
                (100 / si.cm**3) / self.formulae.constants.rho_STP * z_frac
            ),
            k=1.0,
            theta=1e5 * si.um**3,
        )
