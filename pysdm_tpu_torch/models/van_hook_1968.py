"""Van Hook 1968 (J. Phys. Chem. 72) fig. 1 — vapour-pressure isotope
effects ln(P_H2O/P_X) vs 1/T for seven isotopologues (HDO as ``2H``, HTO as
``3H``, H2-17O/H2-18O, D2O as ``DOD``, DTO as ``DOT``, T2O as ``TOT``), for
both supercooled liquid and ice (reference
``examples/PySDM_examples/Van_Hook_1968/fig_1.ipynb``; coefficients from
Table V via the constants catalog).

Port of ``pysdm_tpu/models/van_hook_1968.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics import si
from ..physics.formulae import Formulae

ISOTOPOLOGUES = ("TOT", "DOT", "DOD", "3H", "2H", "18O", "17O")


def fig_1(n_points=64):
    """returns {isotopologue: {liquid: (x, y), ice: (x, y)}} with
    x = 1e3/T and y = 1e2*ln(alpha) as plotted in the paper's fig. 1"""
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors="VanHook1968"
    )
    alphas = formulae.isotope_equilibrium_fractionation_factors

    def trans_x(T):
        return 1e3 / T

    def trans_y(alpha):
        return 1e2 * np.log(alpha)

    out = {}
    line_liquid_T = np.linspace(1000 / 2.65 * si.K, 1000 / 3.8 * si.K, n_points)
    line_ice_T = np.linspace(1000 / 3.6 * si.K, 1000 / 4.3 * si.K, n_points)
    for isotopologue in ISOTOPOLOGUES:
        out[isotopologue] = {
            "liquid": (
                trans_x(line_liquid_T),
                trans_y(
                    np.asarray(
                        getattr(alphas, f"alpha_l_{isotopologue}")(line_liquid_T)
                    )
                ),
            ),
            "ice": (
                trans_x(line_ice_T),
                trans_y(
                    np.asarray(
                        getattr(alphas, f"alpha_i_{isotopologue}")(line_ice_T)
                    )
                ),
            ),
        }
    return out
