"""Arabas et al. 2025 (JAS; arXiv:2308.05015): immersion freezing in a
prescribed-cooling box (port of ``pysdm_tpu/models/arabas_et_al_2025.py``;
reference ``examples/PySDM_examples/Arabas_et_al_2025/commons.py`` +
``make_particulator.py`` + ``run_simulation.py`` + ``frozen_fraction.py``):
singular (INAS-derived freezing-temperature spectrum) against
time-dependent (ABIFM J_het) freezing, and the frozen fraction under
different cooling rates. The paper's headline: singular frozen fractions do
not depend on the cooling rate, time-dependent ones shift with it.

The ambient T is prescribed on the host: ``update_thermo`` writes it into
the box's env state, one host-to-device copy, and reads nothing back.
``make_particulator`` builds on the ``GPU`` backend unless the caller
passes ``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import Freezing
from ..environments import Box
from ..initialisation.sampling.spectro_glacial_sampling import (
    SpectroGlacialSampling,
)
from ..initialisation.spectra import Lognormal
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    AmbientTemperature,
    SpecificIceWaterContent,
    Time,
)

#: ABIFM and INAS parameters (reference ``commons.py``)
FREEZING_CONSTANTS = {
    "dust": {
        "NIEMAND_A": -0.517,
        "NIEMAND_B": 8.934,
        "ABIFM_M": 22.62,
        "ABIFM_C": -1.35,
    },
    "illite": {"ABIFM_M": 54.48, "ABIFM_C": -10.67},
}

COOLING_RATES = (-3.75 * si.K / si.min, -0.75 * si.K / si.min,
                 -0.15 * si.K / si.min)

BEST_FIT_LN_S_GEOM = 0.25
LOGNORMAL_MODE_SURF_A = float(
    Formulae().trivia.sphere_surface(diameter=0.74 * si.um)
)
LOGNORMAL_SGM_G = 2.55
TEMP_RANGE = (250 * si.K, 230 * si.K)

A_VALUE_LARGER_THAN_ONE = 44


class FrozenFraction:
    """reference ``frozen_fraction.py``"""

    def __init__(self, *, volume, droplet_volume, total_particle_number,
                 rho_w):
        self.volume = volume
        self.rho_w = rho_w
        self.droplet_volume = droplet_volume
        self.total_particle_number = total_particle_number

    def qi2ff(self, ice_mass_per_volume):
        ice_mass = ice_mass_per_volume * self.volume
        ice_number = ice_mass / (self.rho_w * self.droplet_volume)
        return ice_number / self.total_particle_number

    def ff2qi(self, frozen_fraction):
        ice_number = frozen_fraction * self.total_particle_number
        ice_mass = ice_number * (self.rho_w * self.droplet_volume)
        return ice_mass / self.volume


def make_particulator(
    *,
    constants,
    n_sd,
    dt,
    initial_temperature,
    singular,
    seed,
    shima_T_fz,
    ABIFM_spec,
    droplet_volume,
    total_particle_number,
    volume,
    thaw=False,
    backend_class=GPU,
):
    """reference ``make_particulator.py``: box + Freezing only, ambient T
    prescribed externally via ``update_thermo``"""
    formulae = Formulae(
        seed=seed,
        constants=constants,
        freezing_temperature_spectrum=shima_T_fz,
        heterogeneous_ice_nucleation_rate="ABIFM",
        particle_shape_and_density="MixedPhaseSpheres",
    )

    attributes = {
        "signed water mass": np.ones(n_sd)
        * droplet_volume
        * formulae.constants.rho_w
    }
    sampling = SpectroGlacialSampling(
        freezing_temperature_spectrum=formulae.freezing_temperature_spectrum,
        insoluble_surface_spectrum=ABIFM_spec,
        seed=seed,
    )
    if singular:
        (
            attributes["freezing temperature"],
            _,
            attributes["multiplicity"],
        ) = sampling.sample(n_sd=n_sd)
    else:
        (
            _,
            attributes["immersed surface area"],
            attributes["multiplicity"],
        ) = sampling.sample(n_sd=n_sd)
    attributes["multiplicity"] = (
        attributes["multiplicity"] * total_particle_number
    )

    env = Box(dt=dt, dv=volume)
    builder = Builder(
        n_sd=n_sd, backend=backend_class(formulae), environment=env
    )
    env["T"] = initial_temperature
    env["RH"] = A_VALUE_LARGER_THAN_ONE
    env["rhod"] = 1.0
    builder.add_dynamic(Freezing(singular=singular, thaw=thaw))
    return builder.build(
        attributes=attributes,
        products=(
            Time(name="t"),
            AmbientTemperature(name="T"),
            SpecificIceWaterContent(name="qi"),
        ),
    )


def update_thermo(particulator, T):
    """the box's ambient T, written to the device (``Box.__setitem__``)"""
    particulator.environment["T"] = T


def run_simulation(particulator, temperature_profile, n_steps):
    """reference ``run_simulation.py``: advance the box under a prescribed
    cooling profile (T evaluated at mid-step for the freezing draw)"""
    output = {
        "products": {k: [] for k in particulator.products},
        "frozen": [np.full(particulator.n_sd, False)],
        "spectrum": {},
    }
    for key in ("multiplicity", "freezing temperature",
                "immersed surface area"):
        if key in particulator.attributes:
            output["spectrum"][key] = particulator.attributes[key]
    for key, product in particulator.products.items():
        output["products"][key].append(
            float(np.asarray(product.get()).reshape(-1)[0])
        )
    for step in range(1, n_steps + 1):
        update_thermo(
            particulator, temperature_profile((step - 0.5) * particulator.dt)
        )
        particulator.run(step - particulator.n_steps)
        update_thermo(
            particulator, temperature_profile(step * particulator.dt)
        )
        output["frozen"].append(
            np.asarray(particulator.attributes["volume"]) < 0
        )
        for key, product in particulator.products.items():
            output["products"][key].append(
                float(np.asarray(product.get()).reshape(-1)[0])
            )
    return output


def abifm_spec(total_number=1.0):
    """the paper's lognormal insoluble-surface spectrum"""
    return Lognormal(
        norm_factor=total_number,
        m_mode=LOGNORMAL_MODE_SURF_A,
        s_geom=LOGNORMAL_SGM_G,
    )
