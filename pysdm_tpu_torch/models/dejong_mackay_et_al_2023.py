"""de Jong, Mackay et al. 2023 (GMD 16) collisional-breakup box setup,
config #2 (port of ``pysdm_tpu/models/dejong_mackay_et_al_2023.py``;
reference ``examples/PySDM_examples/deJong_Mackay_et_al_2023/
settings_0D.py`` + ``simulation_0D.py``): geometric collision kernel,
Berry-1967 coalescence efficiency, constant breakup efficiency, exponential
fragmentation, dv/dlnr + number spectra and collision/coalescence/breakup
rate products. The collision substep is K5 (``ops/cuda/breakup.py``).

``run_box_breakup`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..backends import GPU
from ..builder import Builder
from ..dynamics import Collision
from ..dynamics.collisions import breakup_fragmentations
from ..dynamics.collisions.breakup_efficiencies import ConstEb
from ..dynamics.collisions.coalescence_efficiencies import Berry1967
from ..dynamics.collisions.collision_kernels import Geometric
from ..environments import Box
from ..initialisation import spectra
from ..initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
    Logarithmic,
)
from ..physics import Formulae, si
from ..products import (
    BreakupRatePerGridbox,
    CoalescenceRatePerGridbox,
    CollisionRateDeficitPerGridbox,
    CollisionRatePerGridbox,
    NumberSizeSpectrum,
    ParticleVolumeVersusRadiusLogarithmSpectrum,
)

_TRIVIA = Formulae().trivia
X0 = float(_TRIVIA.volume(radius=30.531 * si.micrometres))


class Settings0D:
    def __init__(self, fragmentation=None, seed=44, warn_overflows=True):
        self.n_sd = 2**10
        self.n_part = 100 / si.cm**3
        self.frag_scale = float(_TRIVIA.volume(radius=100 * si.micrometres))
        self.dv = 1 * si.m**3
        self.norm_factor = self.n_part * self.dv
        self.rho = 1000 * si.kilogram / si.metre**3
        self.dt = 1 * si.second
        self.adaptive = True
        self.warn_overflows = warn_overflows
        self.seed = seed
        self._steps = [0]
        self.kernel = Geometric()
        self.coal_eff = Berry1967()
        self.fragmentation = fragmentation or breakup_fragmentations.Exponential(
            scale=self.frag_scale
        )
        self.vmin = 0.0
        self.break_eff = ConstEb(1.0)  # no "bouncing"
        self.spectrum = spectra.Exponential(
            norm_factor=self.norm_factor, scale=X0
        )
        self.radius_bins_edges = np.logspace(
            np.log10(0.01 * si.um), np.log10(5000 * si.um), num=64, endpoint=True
        )
        self.radius_range = (0 * si.um, 1e6 * si.um)
        self.formulae = Formulae(
            seed=seed,
            fragmentation_function=type(self.fragmentation).__name__,
        )

    @property
    def output_steps(self):
        return [int(step / self.dt) for step in self._steps]


def run_box_breakup(
    settings: Settings0D,
    steps=None,
    backend_class=GPU,
    sample_in_radius=False,
    return_nv=False,
):
    """returns namespace with x (bin radii), y (dv/dlnr per step),
    rates (collision/deficit/coalescence/breakup per step), optionally
    y2 = number spectra (reference ``simulation_0D.py:28-100``), and core,
    the particulator"""
    builder = Builder(
        n_sd=settings.n_sd,
        backend=backend_class(settings.formulae),
        environment=Box(dv=settings.dv, dt=settings.dt),
    )
    attributes = {}
    if sample_in_radius:
        diams, attributes["multiplicity"] = Logarithmic(settings.spectrum).sample(
            settings.n_sd
        )
        attributes["volume"] = np.asarray(
            settings.formulae.trivia.volume(radius=diams / 2)
        )
    else:
        attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
            settings.spectrum
        ).sample(settings.n_sd)
    builder.add_dynamic(
        Collision(
            collision_kernel=settings.kernel,
            coalescence_efficiency=settings.coal_eff,
            breakup_efficiency=settings.break_eff,
            fragmentation_function=settings.fragmentation,
            adaptive=settings.adaptive,
            warn_overflows=settings.warn_overflows,
        )
    )
    products = (
        ParticleVolumeVersusRadiusLogarithmSpectrum(
            radius_bins_edges=settings.radius_bins_edges, name="dv/dlnr"
        ),
        NumberSizeSpectrum(settings.radius_bins_edges, name="N(v)"),
        CollisionRatePerGridbox(name="cr"),
        CollisionRateDeficitPerGridbox(name="crd"),
        CoalescenceRatePerGridbox(name="cor"),
        BreakupRatePerGridbox(name="br"),
    )
    core = builder.build(attributes, products)

    steps = steps if steps is not None else settings.output_steps
    y = np.empty((len(steps), len(settings.radius_bins_edges) - 1))
    y2 = np.empty_like(y) if return_nv else None
    rates = np.zeros((len(steps), 4))
    for i, step in enumerate(steps):
        core.run(step - core.n_steps)
        y[i] = core.products["dv/dlnr"].get()[0] * settings.rho
        if return_nv:
            y2[i] = core.products["N(v)"].get()[0]
        rates[i] = [
            float(core.products[k].get().sum()) for k in ("cr", "crd", "cor", "br")
        ]
    x = (settings.radius_bins_edges[:-1] + settings.radius_bins_edges[1:]) / 2

    class _Out:
        pass

    out = _Out()
    out.x, out.y, out.y2, out.rates, out.core = x, y, y2, rates, core
    return out
