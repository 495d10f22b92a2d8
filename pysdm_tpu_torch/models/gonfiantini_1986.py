"""Gonfiantini 1986 (Handbook of Environmental Isotope Geochemistry vol. 2,
ch. 3) fig. 3.1 — isotopic enrichment of evaporating water as a function of
the remaining-water fraction under different ambient relative humidities
(reference ``examples/PySDM_examples/Gonfiantini_1986/fig_3_1.ipynb``):
eqs. 5, 7, 8, 9 combined into a closed-form delta(remaining fraction), plus
the d2H-vs-d18O evaporation lines against the Craig 1961 meteoric water
line.

Port of ``pysdm_tpu/models/gonfiantini_1986.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics.constants import PER_MILLE
from ..physics import si
from ..physics.formulae import Formulae

HUMIDITIES = (0, 0.25, 0.5, 0.75, 0.95)
DELTA_0 = {"2H": -38 * PER_MILLE, "18O": -6 * PER_MILLE}
DELTA_ATMOS = {"2H": -86 * PER_MILLE, "18O": -12 * PER_MILLE}


def delta(
    *,
    delta_liq_0,
    remaining_water_fraction,
    humidity,
    delta_atmos,
    alpha,
    D_ratio_vs_light,
):
    """liquid delta after evaporating to ``remaining_water_fraction``
    (eqs. 5, 7, 8, 9 in Gonfiantini 1986)"""
    Delta_eps = (1 - humidity) * (1 / D_ratio_vs_light - 1)
    eps = alpha - 1
    AB = lambda x: (x + Delta_eps + eps / alpha) / (1 - humidity + Delta_eps)
    A = AB(humidity * delta_atmos)
    B = -AB(-humidity)
    return (delta_liq_0 - A / B) * remaining_water_fraction**B + A / B


def fig_3_1(
    *,
    temperature=300 * si.K,
    humidities=HUMIDITIES,
    n_points=50,
):
    """returns {isotope: {humidity: delta-of-remaining-fraction}} plus the
    remaining-water-fraction axis"""
    formulae = Formulae(
        isotope_diffusivity_ratios="HellmannAndHarvey2020",
        isotope_equilibrium_fractionation_factors="HoritaAndWesolowski1994",
    )
    remaining = np.linspace(1, 0.01, n_points)
    out = {"remaining_water_fraction": remaining}
    for isotope, delta_0_i in DELTA_0.items():
        out[isotope] = {}
        alpha = float(
            getattr(
                formulae.isotope_equilibrium_fractionation_factors,
                f"alpha_l_{isotope}",
            )(temperature)
        )
        D_ratio = float(
            getattr(
                formulae.isotope_diffusivity_ratios,
                f"ratio_{isotope}_heavy_to_light",
            )(temperature)
        )
        for h in humidities:
            out[isotope][h] = delta(
                delta_liq_0=delta_0_i,
                remaining_water_fraction=remaining,
                humidity=h,
                delta_atmos=DELTA_ATMOS[isotope],
                alpha=alpha,
                D_ratio_vs_light=D_ratio,
            )
    return out
