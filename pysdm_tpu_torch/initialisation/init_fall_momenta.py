"""Initial fall momenta = water mass * terminal velocity (port of
``pysdm_tpu/initialisation/init_fall_momenta.py``; reference
``PySDM/initialisation/init_fall_momenta.py``). Host-side NumPy; the
terminal velocity of the Formulae's variant, the Gunn-Kinzer table or the
formula's ``v_term``."""

import numpy as np
import torch


def init_fall_momenta(water_mass, formulae=None, zero=False):
    water_mass = np.asarray(water_mass)
    if zero:
        return np.zeros_like(water_mass)
    from ..physics import Formulae

    formulae = formulae or Formulae()
    volume = np.asarray(
        formulae.particle_shape_and_density.mass_to_volume(water_mass)
    )
    radius = np.asarray(formulae.trivia.radius(volume))
    if formulae.terminal_velocity.variant == "GunnKinzer1949":
        from ..dynamics.terminal_velocity import gunn_kinzer_v_term

        v_term = gunn_kinzer_v_term(
            torch.as_tensor(radius, dtype=torch.float64)
        ).numpy()
    else:
        v_term = np.asarray(formulae.terminal_velocity.v_term(radius))
    return water_mass * v_term
