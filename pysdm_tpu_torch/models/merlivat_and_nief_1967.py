"""Merlivat & Nief 1967 (Tellus 19) fig. 2 — equilibrium fractionation
factor of HDO between vapour and liquid / ice as a function of temperature
(reference ``examples/PySDM_examples/Merlivat_and_Nief_1967/fig_2.ipynb``):
1e3*log10(alpha) vs 1e6/T^2 for alpha_l_2H over +10..-20 C and alpha_i_2H
over 0..-40 C.

Port of ``pysdm_tpu/models/merlivat_and_nief_1967.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics.formulae import Formulae


def fig_2(n_points=64):
    """returns the two fig-2 curves as dicts of (x=1e6/T^2, y=1e3*log10 a)"""
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors="MerlivatAndNief1967"
    )
    alphas = formulae.isotope_equilibrium_fractionation_factors
    const = formulae.constants

    def trans_x(T_C):
        return 1e6 / (T_C + const.T0) ** 2

    def trans_y(alpha):
        return 1e3 * np.log10(np.where(alpha > 0, alpha, np.nan))

    line_liquid_C = np.linspace(10.0, -20.0, n_points)
    line_ice_C = np.linspace(0.0, -40.0, n_points)
    return {
        "liquid": {
            "T_C": line_liquid_C,
            "x": trans_x(line_liquid_C),
            "y": trans_y(np.asarray(alphas.alpha_l_2H(line_liquid_C + const.T0))),
        },
        "ice": {
            "T_C": line_ice_C,
            "x": trans_x(line_ice_C),
            "y": trans_y(np.asarray(alphas.alpha_i_2H(line_ice_C + const.T0))),
        },
    }
