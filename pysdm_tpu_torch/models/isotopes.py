"""Isotope-physics example family — representative reproductions of the
reference's isotope example notebooks (reference example dirs
``Merlivat_and_Nief_1967``, ``Van_Hook_1968``, ``Gonfiantini_1986``,
``Rozanski_and_Sonntag_1982``, ``Gedzelman_and_Arnold_1994``,
``Jouzel_and_Merlivat_1984``, ``Dansgaard_1964``/``Picciotto_et_al_1960``
meteoric-water-line figures): all are formula-level studies over the
isotope physics families (``pysdm_tpu/physics/isotopes.py``), not
particle simulations.

Each helper evaluates one paper's headline curve on a temperature /
rain-out grid and returns plain numpy arrays for plotting or assertion.

Port of ``pysdm_tpu/models/isotopes.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics import si
from ..physics.formulae import Formulae


def equilibrium_fractionation_curves(
    T=None, variants=("MerlivatAndNief1967", "VanHook1968", "Majoube1971"),
):
    """Merlivat & Nief 1967 / Van Hook 1968 / Majoube 1971 figures:
    liquid-vapour (and ice-vapour where defined) 2H equilibrium
    fractionation factor alpha vs temperature"""
    T = np.asarray(
        T if T is not None else np.linspace(233, 313, 81) * si.K
    )
    out = {"T": T}
    for variant in variants:
        f = Formulae(isotope_equilibrium_fractionation_factors=variant)
        fam = f.isotope_equilibrium_fractionation_factors
        curves = {}
        for name in ("alpha_l_2H", "alpha_i_2H", "alpha_l_18O",
                     "alpha_i_18O"):
            if hasattr(fam, name):
                try:
                    curves[name] = np.asarray(getattr(fam, name)(T))
                except TypeError:
                    pass
        out[variant] = curves
    return out


def rayleigh_distillation(
    *, T=278 * si.K, remaining_fraction=None,
    equilibrium="HoritaAndWesolowski1994",
):
    """Gonfiantini 1986 / Rozanski & Sonntag 1982 style Rayleigh rain-out:
    delta-18O of the residual vapour as precipitation removes liquid in
    isotopic equilibrium, R/R0 = f^(alpha-1)
    (``isotope_ratio_evolution.RayleighDistillation``)"""
    f = Formulae(
        isotope_equilibrium_fractionation_factors=equilibrium,
        isotope_ratio_evolution="RayleighDistillation",
    )
    frac = np.asarray(
        remaining_fraction
        if remaining_fraction is not None
        else np.linspace(1.0, 0.05, 96)
    )
    alpha = float(
        f.isotope_equilibrium_fractionation_factors.alpha_l_18O(T)
    )
    r_over_r0 = np.asarray(
        f.isotope_ratio_evolution.R_over_R0(frac, alpha)  # = frac**(alpha-1)
    )
    delta_vapour = r_over_r0 - 1.0  # relative to the initial vapour ratio
    delta_precip = alpha * r_over_r0 - 1.0
    return {
        "remaining_fraction": frac,
        "alpha": alpha,
        "delta_vapour": delta_vapour,
        "delta_precipitation": delta_precip,
    }


def meteoric_water_lines(delta_2H=None):
    """Dansgaard 1964 global meteoric water line and the Picciotto et al.
    1960 Antarctic line: d18O as a function of d2H
    (``isotope_meteoric_water_line`` family)"""
    delta_2H = np.asarray(
        delta_2H if delta_2H is not None else np.linspace(-400e-3, 0, 81)
    )
    out = {"delta_2H": delta_2H}
    for variant in ("Dansgaard1964", "PicciottoEtAl1960"):
        f = Formulae(isotope_meteoric_water_line=variant)
        out[variant] = np.asarray(
            f.isotope_meteoric_water_line.d18O_of_d2H(delta_2H)
        )
    return out


def kinetic_fractionation_vs_humidity(
    *, T=293 * si.K, relative_humidity=None,
):
    """Jouzel & Merlivat 1984 kinetic (non-equilibrium) fractionation:
    effective alpha vs saturation for 18O, using Stewart 1975 diffusivity
    ratios (``isotope_kinetic_fractionation_factors.JouzelAndMerlivat1984``)"""
    rh = np.asarray(
        relative_humidity
        if relative_humidity is not None
        else np.linspace(1.0, 1.35, 36)
    )
    f = Formulae(
        isotope_kinetic_fractionation_factors="JouzelAndMerlivat1984",
        isotope_diffusivity_ratios="Stewart1975",
        isotope_equilibrium_fractionation_factors="Majoube1970",
    )
    alpha_eq = float(
        f.isotope_equilibrium_fractionation_factors.alpha_i_18O(T)
    )
    d_ratio = float(
        f.isotope_diffusivity_ratios.ratio_18O_heavy_to_light(T)
    )
    alpha_k = np.asarray(
        f.isotope_kinetic_fractionation_factors.alpha_kinetic(
            alpha_eq, rh, d_ratio
        )
    )
    return {
        "saturation": rh,
        "alpha_equilibrium": alpha_eq,
        "alpha_kinetic": alpha_k,
    }
