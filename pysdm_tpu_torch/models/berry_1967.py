"""Berry 1967 (JAS 24) gravitational-collection box setup (port of
``pysdm_tpu/models/berry_1967.py``; reference
``examples/PySDM_examples/Berry_1967/settings.py`` + ``example.py``): the
geometric collision kernel with a terminal-velocity variant, an
exponential initial spectrum. The collision substep is K1
(``ops/cuda/collision.py``), which evaluates the geometric kernel in its
body.

``run`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..backends import GPU
from ..builder import Builder
from ..dynamics import Coalescence
from ..dynamics.collisions import collision_kernels
from ..environments import Box
from ..initialisation import spectra
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import Formulae, si
from ..products import ParticleVolumeVersusRadiusLogarithmSpectrum


class Settings:
    def __init__(self, steps=None, terminal_velocity_variant="GunnKinzer1949"):
        self.formulae = Formulae(
            seed=44, terminal_velocity=terminal_velocity_variant
        )
        self.init_x_min = float(
            self.formulae.trivia.volume(radius=3.94 * si.micrometre)
        )
        self.init_x_max = float(
            self.formulae.trivia.volume(radius=25 * si.micrometres)
        )
        self.n_sd = 2**13
        self.n_part = 239 / si.cm**3
        self.X0 = float(self.formulae.trivia.volume(radius=10 * si.micrometres))
        self.dv = 1e1 * si.metres**3
        self.norm_factor = self.n_part * self.dv
        self.rho = self.formulae.constants.rho_w
        self.dt = 1 * si.seconds
        self.adaptive = False
        self.seed = 44
        self._steps = steps or [200 * i for i in range(10)]
        self.kernel = collision_kernels.Geometric(collection_efficiency=1)
        self.spectrum = spectra.Exponential(
            norm_factor=self.norm_factor, scale=self.X0
        )
        self.radius_bins_edges = np.logspace(
            np.log10(3.94 * si.um), np.log10(220 * si.um), num=100, endpoint=True
        )

    @property
    def output_steps(self):
        return [int(step / self.dt) for step in self._steps]


def run(settings: Settings = None, backend_class=GPU):
    """returns ({step: dv/dlnr [kg/m3]}, particulator) (reference
    ``Berry_1967/example.py``)"""
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
    )
    particulator = builder.build(attributes, products)
    vals = {}
    for step in settings.output_steps:
        particulator.run(step - particulator.n_steps)
        vals[step] = np.asarray(particulator.products["dv/dlnr"].get()[0]).copy()
        vals[step][:] *= settings.rho
    return vals, particulator
