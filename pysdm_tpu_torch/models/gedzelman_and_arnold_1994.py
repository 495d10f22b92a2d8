"""Gedzelman & Arnold 1994 (JGR 99) fig. 2 — zero-net-fractionation
saturation curves for raindrops falling through ambient vapour (reference
``examples/PySDM_examples/Gedzelman_and_Arnold_1994/fig_2.ipynb``): eqs.
(22) and (23) give the relative humidity S at which the rain (resp. vapour)
isotope ratio is stationary, as a function of the rain ratio R_rain/R_SMOW.

Port of ``pysdm_tpu/models/gedzelman_and_arnold_1994.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics.constants import PER_MILLE
from ..physics import si
from ..physics.formulae import Formulae


class Commons:
    """values shared between eqs. (22) and (23)"""

    def __init__(self, *, formulae, isotope, delta_v, temperature):
        const = formulae.constants
        self.vsmow_ratio = getattr(const, f"VSMOW_R_{isotope}")
        self.iso_ratio_v = float(
            formulae.trivia.isotopic_delta_2_ratio(delta_v, self.vsmow_ratio)
        )
        alpha_fun = getattr(
            formulae.isotope_equilibrium_fractionation_factors,
            f"alpha_l_{isotope}",
        )
        if isotope == "17O":
            alpha_l_18O = (
                formulae.isotope_equilibrium_fractionation_factors.alpha_l_18O(
                    temperature
                )
            )
            self.alpha_w = float(alpha_fun(np.nan, alpha_l_18O))
        else:
            self.alpha_w = float(alpha_fun(temperature))

        self.diff_coef_ratio = 1 / float(
            getattr(
                formulae.isotope_diffusivity_ratios,
                f"ratio_{isotope}_heavy_to_light",
            )(temperature)
        )

        # the psychrometric-coupling coefficient b (eq. 21); the paper's
        # expression is missing the e_s/(Rv T) multiplier, restored here as
        # in the reference notebook
        missing_b_multiplier = (
            float(formulae.saturation_vapour_pressure.pvs_water(temperature))
            / temperature
            / const.Rv
        )
        self.b = (
            missing_b_multiplier
            * float(formulae.latent_heat_vapourisation.lv(temperature)) ** 2
            * const.D0
            / const.K0
            / const.Rv
            / temperature**2
        )
        self.zero_dR_condition = formulae.isotope_ratio_evolution.zero_dR_condition
        any_number = 44.0
        self.vent_coeff_ratio = float(
            formulae.isotope_ventilation_ratio.ratio_heavy_to_light(
                ventilation_coefficient=any_number,
                diffusivity_ratio=self.diff_coef_ratio,
            )
        )


class NoFractionationSaturation:
    """eqs. (22) [liquid] and (23) [vapour] from the paper"""

    def __init__(self, cmn: Commons, *, liquid: bool = False, vapour: bool = False):
        assert liquid != vapour
        self.liquid = liquid
        self.cmn = cmn

    def __call__(self, iso_ratio_r):
        return np.asarray(
            self.cmn.zero_dR_condition(
                iso_ratio_x=iso_ratio_r if self.liquid else self.cmn.iso_ratio_v,
                diff_rat=self.cmn.vent_coeff_ratio * self.cmn.diff_coef_ratio,
                b=self.cmn.b,
                alpha_w=self.cmn.alpha_w,
                iso_ratio_r=iso_ratio_r,
                iso_ratio_v=self.cmn.iso_ratio_v,
            )
        )


def fig_2(
    *,
    isotope="2H",
    delta_v=-200 * PER_MILLE,
    temperature_K=None,
    n_points=200,
):
    """the headline single-panel fig. 2 case: S_R(eq) and S_V(eq) vs the
    normalized rain ratio, for HDO at T0+10 K with delta_v = -200 permil"""
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors="MerlivatAndNief1967",
        isotope_diffusivity_ratios="Stewart1975",
        isotope_ratio_evolution="GedzelmanAndArnold1994",
        isotope_ventilation_ratio="Neglect",
    )
    temperature = temperature_K or (formulae.constants.T0 + 10 * si.K)
    commons = Commons(
        formulae=formulae,
        isotope=isotope,
        delta_v=delta_v,
        temperature=temperature,
    )
    x = np.linspace(
        commons.alpha_w * commons.iso_ratio_v / commons.vsmow_ratio,
        1.1,
        n_points,
    )
    return {
        "rain_ratio_over_vsmow": x,
        "S_rain_eq_22": NoFractionationSaturation(commons, liquid=True)(
            x * commons.vsmow_ratio
        ),
        "S_vapour_eq_23": NoFractionationSaturation(commons, vapour=True)(
            x * commons.vsmow_ratio
        ),
        "commons": commons,
    }
