"""Bieli et al. 2022 (JAMES): coalescence and breakup moment evolution in a
0D box (port of ``pysdm_tpu/models/bieli_et_al_2022.py``; reference
``examples/PySDM_examples/Bieli_et_al_2022/settings.py`` +
``simulation.py``): gamma initial spectrum, Golovin kernel, Feingold 1988
fragmentation, three coalescence efficiencies; tracks the first three volume
moments M0/M1/M2 used to fit the Cloudy.jl moment closure in the paper. The
collision substep is the float64 breakup path (``ops/breakup.py``): K5 has
no body for Feingold 1988.

``run`` and ``make_core`` build on the ``GPU`` backend unless the caller
passes ``backend_class=CPU`` (the JAX package's run on its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics.collisions.collision import Collision
from ..dynamics.collisions.breakup_efficiencies import ConstEb
from ..dynamics.collisions.breakup_fragmentations import Feingold1988
from ..dynamics.collisions.coalescence_efficiencies import ConstEc
from ..dynamics.collisions.collision_kernels import Golovin
from ..environments import Box
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..initialisation.spectra import Gamma
from ..physics import si
from ..physics.formulae import Formulae
from ..products import make_arbitrary_moment_product


class Settings:
    def __init__(self, formulae: Formulae = None):
        rho_w = 1000.0  # kg/m3 (constants_defaults.rho_w)
        self.n_sd = 2**12
        self.n_part = 1e4 / si.cm**3
        self.theta = 0.33e-9 * si.g / rho_w
        self.k = 1
        self.dv = 0.1 * si.m**3
        self.norm_factor = self.n_part * self.dv
        self.dt = 1 * si.s
        self.adaptive = False
        self.seed = 44
        self._steps = list(range(60))
        self.kernel = Golovin(b=2000 * si.cm**3 / si.g / si.s * rho_w)
        self.coal_effs = [ConstEc(Ec=0.8), ConstEc(Ec=0.9), ConstEc(Ec=1.0)]
        self.vmin = 1.0 * si.um**3
        self.nfmax = 10
        self.fragtol = 1e-3
        self.fragmentation = Feingold1988(
            scale=self.k * self.theta,
            fragtol=self.fragtol,
            vmin=self.vmin,
            nfmax=self.nfmax,
        )
        self.break_eff = ConstEb(1.0)
        self.spectrum = Gamma(
            norm_factor=self.norm_factor, k=self.k, theta=self.theta
        )
        self.rho = rho_w
        self.formulae = formulae or Formulae(seed=self.seed)

    @property
    def output_steps(self):
        return [int(step / self.dt) for step in self._steps]


def make_core(settings, coal_eff, backend_class=GPU):
    builder = Builder(
        n_sd=settings.n_sd,
        backend=backend_class(settings.formulae),
        environment=Box(dv=settings.dv, dt=settings.dt),
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        settings.spectrum
    ).sample(settings.n_sd)
    collision = Collision(
        collision_kernel=settings.kernel,
        coalescence_efficiency=coal_eff,
        breakup_efficiency=settings.break_eff,
        fragmentation_function=settings.fragmentation,
        adaptive=settings.adaptive,
    )
    builder.add_dynamic(collision)
    common_args = {
        "attr": "volume",
        "attr_unit": "m^3",
        "skip_division_by_m0": True,
        "skip_division_by_dv": True,
    }
    products = tuple(
        make_arbitrary_moment_product(rank=rank, **common_args)(
            name=f"M{rank}"
        )
        for rank in range(3)
    )
    return builder.build(attributes, products)


def run(settings=None, coal_eff=None, backend_class=GPU):
    """run the fig-3 setup for one coalescence efficiency; returns
    {'M0': [...], 'M1': [...], 'M2': [...]} over output_steps"""
    settings = settings or Settings()
    coal_eff = coal_eff or settings.coal_effs[-1]
    particulator = make_core(settings, coal_eff, backend_class)
    output = {f"M{rank}": [] for rank in range(3)}
    for step in settings.output_steps:
        particulator.run(step - particulator.n_steps)
        for name in output:
            output[name].append(
                float(
                    np.asarray(
                        particulator.products[name].get()
                    ).reshape(-1)[0]
                )
            )
    return output
