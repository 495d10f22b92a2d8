"""Shima et al. 2009 (QJRMS 135) fig. 2 box-coalescence setup, config #1
(port of ``pysdm_tpu/models/shima_et_al_2009.py``; reference
``examples/PySDM_examples/Shima_et_al_2009/settings.py`` + ``example.py``):
a 0D box, the Golovin additive kernel, an exponential initial spectrum,
dv/dlnr mass-density spectra at t = 0/1200/2400/3600 s, the Golovin 1963
analytic solution for validation and the wall time of the run. The
collision substep is K1 (``ops/cuda/collision.py``).

``run`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np
from scipy import special

from ..backends import GPU
from ..builder import Builder
from ..dynamics import Coalescence
from ..dynamics.collisions.collision_kernels import Golovin
from ..environments import Box
from ..initialisation import spectra
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import Formulae, si
from ..products import ParticleVolumeVersusRadiusLogarithmSpectrum, WallTime


class Settings:
    def __init__(self, steps=None, formulae=None, seed=44):
        self.steps = steps if steps is not None else [0, 1200, 2400, 3600]
        self.formulae = formulae or Formulae(seed=seed)
        self.n_sd = 2**13
        self.n_part = 2**23 / si.metre**3
        self.X0 = float(self.formulae.trivia.volume(radius=30.531 * si.um))
        self.dv = 1e6 * si.metres**3
        self.norm_factor = self.n_part * self.dv
        self.rho = 1000 * si.kilogram / si.metre**3
        self.dt = 1 * si.second
        self.adaptive = False
        self.seed = seed
        self.kernel = Golovin(b=1.5e3 / si.second)
        self.spectrum = spectra.Exponential(
            norm_factor=self.norm_factor, scale=self.X0
        )
        self.radius_bins_edges = np.logspace(
            np.log10(10 * si.um), np.log10(5e3 * si.um), num=128, endpoint=True
        )

    @property
    def output_steps(self):
        return [int(step / self.dt) for step in self.steps]


def golovin_analytic_dvdlnr(radius, t, *, b, x_0, n_part, rho):
    """the Golovin 1963 closed-form mass-density solution dm/dlnr for the
    exponential initial spectrum (the curve the reference's SpectrumPlotter
    draws from ``settings.kernel.analytic_solution``)"""
    x = 4 / 3 * np.pi * radius**3
    tau = 1 - np.exp(-n_part * b * x_0 * t)
    sqrt_tau = np.sqrt(tau)
    phi = (
        (1 - tau)
        / (x * sqrt_tau)
        * special.ive(1, 2 * x / x_0 * sqrt_tau)
        * np.exp(-(1 + tau - 2 * sqrt_tau) * x / x_0)
    )
    return n_part * phi * 3 * x**2 * rho


def run(settings: Settings = None, backend_class=GPU, observers=()):
    """returns ({step: dv/dlnr spectrum [kg/m3/(unit lnr)]}, wall_time_s)
    (reference ``Shima_et_al_2009/example.py:25-58``); the wall time ends
    when the device has finished"""
    settings = settings or Settings()
    builder = Builder(
        n_sd=settings.n_sd,
        backend=backend_class(formulae=settings.formulae),
        environment=Box(dv=settings.dv, dt=settings.dt),
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        settings.spectrum
    ).sample(settings.n_sd)
    builder.add_dynamic(
        Coalescence(collision_kernel=settings.kernel, adaptive=settings.adaptive)
    )
    products = (
        ParticleVolumeVersusRadiusLogarithmSpectrum(
            settings.radius_bins_edges, name="dv/dlnr"
        ),
        WallTime(),
    )
    particulator = builder.build(attributes, products)
    particulator.observers.extend(observers)

    vals = {}
    particulator.products["wall time"].reset()
    for step in settings.output_steps:
        particulator.run(step - particulator.n_steps)
        vals[step] = np.asarray(particulator.products["dv/dlnr"].get()[0]).copy()
        vals[step][:] *= settings.rho
    exec_time = particulator.products["wall time"].get()
    return vals, exec_time
