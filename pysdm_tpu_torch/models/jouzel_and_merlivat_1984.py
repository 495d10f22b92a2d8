"""Jouzel & Merlivat 1984 (JGR 89) figs. 8 & 9 — kinetic fractionation at
snow formation under supersaturation with respect to ice (reference
``examples/PySDM_examples/Jouzel_and_Merlivat_1984/fig_8_9.ipynb`` +
``thermodynamic_profiles.py``): ice-saturation "curve 4" (eq. 15), the
Table-1 temperature/pressure profile, and the effective fractionation
alpha_s*alpha_k for 18O as a function of ice saturation Si.

Port of ``pysdm_tpu/models/jouzel_and_merlivat_1984.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics import si
from ..physics.formulae import Formulae

#: Table 1, first two columns (temperature [C] -> pressure); interpolated
TABLE_1_T_C = np.asarray([-50.0, -40.0, -30.0, -20.0, -10.0])
TABLE_1_P = np.asarray([600.0, 630.0, 690.0, 780.0, 925.0]) * si.mbar


def pressure(T):
    """Table-1 pressure profile vs temperature [K] (the reference uses a
    cubic spline; monotone piecewise-linear interpolation here — within the
    plot's line width of the spline over the tabulated range); NaN outside"""
    formulae = Formulae()
    T0 = formulae.constants.T0
    T = np.asarray(T)
    out = np.interp(T - T0, TABLE_1_T_C, TABLE_1_P)
    return np.where(
        (T - T0 >= TABLE_1_T_C[0]) & (T - T0 <= TABLE_1_T_C[-1]), out, np.nan
    )


def ice_saturation_curve_4(const, T):
    """eq. (15)"""
    return 0.99 - 0.006 * (T - const.T0)


def vapour_mixing_ratio(formulae, T):
    """mixing ratio with saturation wrt ice calculated with curve-4 eq."""
    const = formulae.constants
    svp = formulae.saturation_vapour_pressure
    p_v = ice_saturation_curve_4(const, T) * np.asarray(svp.pvs_ice(T))
    rho_v = p_v / const.Rv / T
    rho_d = (pressure(T) - p_v) / const.Rd / T
    return rho_v / rho_d


def fig_8(n_points=100):
    """liquid-saturation and curve-4 ice-saturation ratios vs temperature"""
    formulae = Formulae()
    const = formulae.constants
    svp = formulae.saturation_vapour_pressure
    T = const.T0 + np.linspace(0.0, -50.0, n_points)
    return {
        "T_C": T - const.T0,
        "saturation_wrt_liquid": np.asarray(svp.pvs_water(T))
        / np.asarray(svp.pvs_ice(T)),
        "curve_4": ice_saturation_curve_4(const, T),
    }


def fig_9(temperatures_C=(-10.0, -20.0, -30.0), n_points=100):
    """effective fractionation alpha_s*alpha_k for 18O vs ice saturation"""
    formulae = Formulae(
        isotope_diffusivity_ratios="Stewart1975",
        isotope_equilibrium_fractionation_factors="Majoube1970",
        isotope_kinetic_fractionation_factors="JouzelAndMerlivat1984",
    )
    const = formulae.constants
    Si = np.linspace(1.0, 1.4, n_points)
    out = {"Si": Si}
    for T_C in temperatures_C:
        T = const.T0 + T_C
        alpha_s = float(
            formulae.isotope_equilibrium_fractionation_factors.alpha_i_18O(T)
        )
        alpha_k = np.asarray(
            formulae.isotope_kinetic_fractionation_factors.alpha_kinetic(
                alpha_equilibrium=alpha_s,
                saturation=Si,
                D_ratio_heavy_to_light=float(
                    formulae.isotope_diffusivity_ratios.ratio_18O_heavy_to_light(
                        T
                    )
                ),
            )
        )
        out[T_C] = alpha_k * alpha_s
    return out
