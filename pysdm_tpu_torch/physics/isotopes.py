"""Water-isotopologue physics families, port of
``pysdm_tpu/physics/isotopes.py`` (reference ``PySDM/physics/isotope_*``, 8
families): equilibrium and kinetic fractionation factors, vapour
diffusivity ratios, meteoric-water-line parameters, isotope-ratio
evolution, relaxation timescales, temperature inference and ventilation
ratios. Each body is arithmetic on its arguments or goes through ``_xp``,
so one body serves Python floats, NumPy arrays and tensors."""

from . import _xp


# --- equilibrium fractionation factors ---------------------------------------
def _exp_poly_inv_T(T, c2, c1, c0):
    return _xp.exp(c2 / T**2 + c1 / T + c0)


class BarkanAndLuz2005:
    """17O from 18O (Barkan & Luz 2005)"""

    @staticmethod
    def alpha_l_17O(const, _, alpha_l_18O):
        return alpha_l_18O**const.BARKAN_AND_LUZ_2005_EXPONENT


class HoritaAndWesolowski1994:
    @staticmethod
    def alpha_l_18O(const, T):
        return _xp.exp(
            const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_18O_T3 / T**3
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_18O_T2 / T**2
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_18O_T1 / T
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_18O_T0
        )

    @staticmethod
    def alpha_l_2H(const, T):
        return _xp.exp(
            const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_2H_T3 / T**3
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_2H_T_0
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_2H_T_1 * T
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_2H_T_2 * T**2
            + const.HORITA_AND_WESOLOWSKI_1994_ALPHA_L_2H_T_3 * T**3
        )


class Majoube1970:
    @staticmethod
    def alpha_i_18O(const, T):
        return _exp_poly_inv_T(
            T,
            const.MAJOUBE_1970_ALPHA_I_18O_T2,
            const.MAJOUBE_1970_ALPHA_I_18O_T1,
            const.MAJOUBE_1970_ALPHA_I_18O_T0,
        )


class Majoube1971:
    @staticmethod
    def alpha_l_18O(const, T):
        return _exp_poly_inv_T(
            T,
            const.MAJOUBE_1971_ALPHA_L_18O_T2,
            const.MAJOUBE_1971_ALPHA_L_18O_T1,
            const.MAJOUBE_1971_ALPHA_L_18O_T0,
        )

    @staticmethod
    def alpha_l_2H(const, T):
        return _exp_poly_inv_T(
            T,
            const.MAJOUBE_1971_ALPHA_L_2H_T2,
            const.MAJOUBE_1971_ALPHA_L_2H_T1,
            const.MAJOUBE_1971_ALPHA_L_2H_T0,
        )


class MerlivatAndNief1967:
    @staticmethod
    def alpha_l_2H(const, T):
        return _exp_poly_inv_T(
            T,
            const.MERLIVAT_NIEF_1967_ALPHA_L_2H_T2,
            const.MERLIVAT_NIEF_1967_ALPHA_L_2H_T1,
            const.MERLIVAT_NIEF_1967_ALPHA_L_2H_T0,
        )

    @staticmethod
    def alpha_i_2H(const, T):
        return _exp_poly_inv_T(
            T,
            const.MERLIVAT_NIEF_1967_ALPHA_I_2H_T2,
            const.MERLIVAT_NIEF_1967_ALPHA_I_2H_T1,
            const.MERLIVAT_NIEF_1967_ALPHA_I_2H_T0,
        )


class LambEtAl2017:
    @staticmethod
    def alpha_i_2H(const, T):
        return _exp_poly_inv_T(
            T,
            const.LAMB_ET_AL_2017_ALPHA_I_2H_T2,
            const.LAMB_ET_AL_2017_ALPHA_I_2H_T1,
            const.LAMB_ET_AL_2017_ALPHA_I_2H_T0,
        )


class EllehojEtAl2013:
    @staticmethod
    def alpha_i_2H(const, T):
        return _exp_poly_inv_T(
            T,
            const.ELLEHOJ_ET_AL_2013_ALPHA_I_2H_T2,
            const.ELLEHOJ_ET_AL_2013_ALPHA_I_2H_T1,
            const.ELLEHOJ_ET_AL_2013_ALPHA_I_2H_T0,
        )


class VanHook1968:
    @staticmethod
    def alpha_l_2H(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_2H_A,
            const.VAN_HOOK_1968_ALPHA_L_2H_B, const.VAN_HOOK_1968_ALPHA_L_2H_C,
        )

    @staticmethod
    def alpha_i_2H(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_2H_A,
            const.VAN_HOOK_1968_ALPHA_I_2H_B, const.VAN_HOOK_1968_ALPHA_I_2H_C,
        )

    @staticmethod
    def alpha_l_18O(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_18O_A,
            const.VAN_HOOK_1968_ALPHA_L_18O_B, const.VAN_HOOK_1968_ALPHA_L_18O_C,
        )

    @staticmethod
    def alpha_i_18O(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_18O_A,
            const.VAN_HOOK_1968_ALPHA_I_18O_B, const.VAN_HOOK_1968_ALPHA_I_18O_C,
        )

    @staticmethod
    def alpha_l_17O(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_17O_A,
            const.VAN_HOOK_1968_ALPHA_L_17O_B, const.VAN_HOOK_1968_ALPHA_L_17O_C,
        )

    @staticmethod
    def alpha_i_17O(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_17O_A,
            const.VAN_HOOK_1968_ALPHA_I_17O_B, const.VAN_HOOK_1968_ALPHA_I_17O_C,
        )

    @staticmethod
    def alpha_l_3H(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_3H_A,
            const.VAN_HOOK_1968_ALPHA_L_3H_B, const.VAN_HOOK_1968_ALPHA_L_3H_C,
        )

    @staticmethod
    def alpha_i_3H(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_3H_A,
            const.VAN_HOOK_1968_ALPHA_I_3H_B, const.VAN_HOOK_1968_ALPHA_I_3H_C,
        )

    @staticmethod
    def alpha_l_TOT(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_TOT_A,
            const.VAN_HOOK_1968_ALPHA_L_TOT_B, const.VAN_HOOK_1968_ALPHA_L_TOT_C,
        )

    @staticmethod
    def alpha_i_TOT(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_TOT_A,
            const.VAN_HOOK_1968_ALPHA_I_TOT_B, const.VAN_HOOK_1968_ALPHA_I_TOT_C,
        )

    @staticmethod
    def alpha_l_DOT(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_DOT_A,
            const.VAN_HOOK_1968_ALPHA_L_DOT_B, const.VAN_HOOK_1968_ALPHA_L_DOT_C,
        )

    @staticmethod
    def alpha_i_DOT(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_DOT_A,
            const.VAN_HOOK_1968_ALPHA_I_DOT_B, const.VAN_HOOK_1968_ALPHA_I_DOT_C,
        )

    @staticmethod
    def alpha_l_DOD(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_L_DOD_A,
            const.VAN_HOOK_1968_ALPHA_L_DOD_B, const.VAN_HOOK_1968_ALPHA_L_DOD_C,
        )

    @staticmethod
    def alpha_i_DOD(const, T):
        return _exp_poly_inv_T(
            T, const.VAN_HOOK_1968_ALPHA_I_DOD_A,
            const.VAN_HOOK_1968_ALPHA_I_DOD_B, const.VAN_HOOK_1968_ALPHA_I_DOD_C,
        )


# --- kinetic fractionation factors --------------------------------------------
class CraigGordon:
    """Craig-Gordon evaporation model kinetic factor (Rozanski et al. 2001
    eq. 1.5; Pierchala et al. 2022)"""

    @staticmethod
    def alpha_kinetic(
        const, *, relative_humidity, turbulence_parameter_n, delta_diff, theta
    ):
        return 1 + theta * turbulence_parameter_n * delta_diff * (
            1 - relative_humidity
        )


class JouzelAndMerlivat1984:
    """effective (kinetic) fractionation under supersaturation wrt ice"""

    @staticmethod
    def alpha_kinetic(const, alpha_equilibrium, saturation, D_ratio_heavy_to_light):
        return saturation / (
            alpha_equilibrium / D_ratio_heavy_to_light * (saturation - 1) + 1
        )


# --- diffusivity ratios ---------------------------------------------------------
class GrahamsLaw:
    @staticmethod
    def ratio_2H_heavy_to_light(const, temperature):
        return (
            (2 * const.M_1H + const.M_16O) / (const.M_2H + const.M_1H + const.M_16O)
        ) ** const.ONE_HALF

    @staticmethod
    def ratio_3H_heavy_to_light(const, temperature):
        return (
            (2 * const.M_1H + const.M_16O) / (const.M_3H + const.M_1H + const.M_16O)
        ) ** const.ONE_HALF


class Stewart1975:
    """reduced-mass binary-diffusion ratio (temperature-independent)"""

    @staticmethod
    def ratio_2H_heavy_to_light(const, temperature):
        return (
            (
                (2 * const.M_1H + const.M_16O)
                * (const.Md + const.M_2H + const.M_1H + const.M_16O)
            )
            / (
                (const.M_2H + const.M_1H + const.M_16O)
                * (const.Md + (2 * const.M_1H + const.M_16O))
            )
        ) ** const.ONE_HALF

    @staticmethod
    def ratio_18O_heavy_to_light(const, temperature):
        return (
            (
                (2 * const.M_1H + const.M_16O)
                * (const.Md + 2 * const.M_1H + const.M_18O)
            )
            / (
                (2 * const.M_1H + const.M_18O)
                * (const.Md + (2 * const.M_1H + const.M_16O))
            )
        ) ** const.ONE_HALF


class HellmannAndHarvey2020:
    @staticmethod
    def ratio_2H_heavy_to_light(const, temperature):
        t = temperature / const.HELLMANN_HARVEY_T_UNIT
        return (
            const.HELLMANN_HARVEY_EQ6_COEFF0
            + const.HELLMANN_HARVEY_EQ6_COEFF1 / t
            + const.HELLMANN_HARVEY_EQ6_COEFF2 / t**const.TWO_AND_A_HALF
        )

    @staticmethod
    def ratio_17O_heavy_to_light(const, temperature):
        t = temperature / const.HELLMANN_HARVEY_T_UNIT
        return (
            const.HELLMANN_HARVEY_EQ7_COEFF0
            + const.HELLMANN_HARVEY_EQ7_COEFF1 / t**const.ONE_HALF
            + const.HELLMANN_HARVEY_EQ7_COEFF2 / t**const.TWO_AND_A_HALF
        )

    @staticmethod
    def ratio_18O_heavy_to_light(const, temperature):
        t = temperature / const.HELLMANN_HARVEY_T_UNIT
        return (
            const.HELLMANN_HARVEY_EQ8_COEFF0
            + const.HELLMANN_HARVEY_EQ8_COEFF1 / t**const.ONE_HALF
            + const.HELLMANN_HARVEY_EQ8_COEFF2 / t**const.THREE
        )


# --- meteoric water line -------------------------------------------------------
class BarkanAndLuz2007:
    @staticmethod
    def excess_17O(const, delta_17O, delta_18O):
        return _xp.log(delta_17O + 1) - (
            const.BARKAN_AND_LUZ_2007_EXCESS_18O_COEFF * _xp.log(delta_18O + 1)
        )

    @staticmethod
    def d17O_of_d18O(const, delta_18O):
        return (
            _xp.exp(
                const.BARKAN_AND_LUZ_2007_EXCESS_18O_COEFF * _xp.log(delta_18O + 1)
            )
            - 1
        )


class Dansgaard1964:
    @staticmethod
    def excess_d(const, delta_2H, delta_18O):
        return delta_2H - const.CRAIG_1961_SLOPE_COEFF * delta_18O

    @staticmethod
    def d18O_of_d2H(const, delta_2H):
        return (
            delta_2H - const.CRAIG_1961_INTERCEPT_COEFF
        ) / const.CRAIG_1961_SLOPE_COEFF


class PicciottoEtAl1960MWL:
    @staticmethod
    def d18O_of_d2H(const, delta_2H):
        return (
            delta_2H - const.PICCIOTTO_18O_TO_2H_INTERCEPT_COEFF
        ) / const.PICCIOTTO_18O_TO_2H_SLOPE_COEFF


# --- ratio evolution -------------------------------------------------------------
class MerlivatAndJouzel1979:
    @staticmethod
    def d_Rv_over_Rv(const, alpha, d_alpha, n_vapour, d_n_vapour, n_liquid):
        return ((alpha - 1) * d_n_vapour - n_liquid * d_alpha) / (
            n_vapour + alpha * n_liquid
        )


class RayleighDistillation:
    @staticmethod
    def R_over_R0(const, X_over_X0, a):
        return X_over_X0 ** (a - 1)


class GedzelmanAndArnold1994:
    @staticmethod
    def zero_dR_condition(
        const, diff_rat, iso_ratio_x, iso_ratio_r, iso_ratio_v, b, alpha_w
    ):
        return (diff_rat * iso_ratio_x - iso_ratio_r / alpha_w) / (
            diff_rat * iso_ratio_x - (1 + b) * iso_ratio_v + b * iso_ratio_r / alpha_w
        )


# --- relaxation timescales ---------------------------------------------------------
class Bolin1958:
    @staticmethod
    def tau(const, dm_dt_over_m):
        return 1 / (const.BOLIN_ISOTOPE_TIMESCALE_COEFF_C1 * dm_dt_over_m)


class MiyakeEtAl1968:
    @staticmethod
    def tau(const, rho_s, radius, D_iso, D, S, R_liq, alpha, R_vap, Fk):
        return (radius**2 * alpha * const.rho_w) / (3 * rho_s * D)


class JouzelEtAl1975:
    @staticmethod
    def tau(const, rho_s, radius, D_iso, D, S, R_liq, alpha, R_vap, Fk):
        return (radius**2 * const.rho_w * alpha) / (3 * rho_s * D_iso)


class ZabaEtAl:
    @staticmethod
    def tau(const, rho_s, radius, D_iso, D, S, R_liq, alpha, R_vap, Fk):
        return 1 / (
            3
            * rho_s
            / radius**2
            / const.rho_w
            / alpha
            * D_iso
            * (S * (alpha * R_vap / R_liq - 1) + (S - 1) / (1 + D * Fk))
        )


# --- temperature inference ------------------------------------------------------------
class PicciottoEtAl1960Temperature:
    @staticmethod
    def temperature_from_delta_18O(const, delta_18O):
        return const.T0 + (-delta_18O - const.PICCIOTTO_18O_B) / const.PICCIOTTO_18O_A

    @staticmethod
    def temperature_from_delta_2H(const, delta_2H):
        return const.T0 + (-delta_2H - const.PICCIOTTO_2H_B) / const.PICCIOTTO_2H_A


# --- ventilation ratio -----------------------------------------------------------------
class VentilationNeglect:
    @staticmethod
    def ratio_heavy_to_light(const, ventilation_coefficient, diffusivity_ratio):
        return 1.0 + 0.0 * ventilation_coefficient


class Brutsaert1982:
    @staticmethod
    def ratio_heavy_to_light(const, ventilation_coefficient, diffusivity_ratio):
        return (
            1 - diffusivity_ratio ** (1 / 3)
        ) / ventilation_coefficient + diffusivity_ratio ** (1 / 3)


EQUILIBRIUM_VARIANTS = {
    "BarkanAndLuz2005": BarkanAndLuz2005,
    "HoritaAndWesolowski1994": HoritaAndWesolowski1994,
    "Majoube1970": Majoube1970,
    "Majoube1971": Majoube1971,
    "MerlivatAndNief1967": MerlivatAndNief1967,
    "LambEtAl2017": LambEtAl2017,
    "EllehojEtAl2013": EllehojEtAl2013,
    "VanHook1968": VanHook1968,
}
KINETIC_VARIANTS = {
    "CraigGordon": CraigGordon,
    "JouzelAndMerlivat1984": JouzelAndMerlivat1984,
}
DIFFUSIVITY_RATIO_VARIANTS = {
    "GrahamsLaw": GrahamsLaw,
    "Stewart1975": Stewart1975,
    "HellmannAndHarvey2020": HellmannAndHarvey2020,
}
MWL_VARIANTS = {
    "BarkanAndLuz2007": BarkanAndLuz2007,
    "Dansgaard1964": Dansgaard1964,
    "PicciottoEtAl1960": PicciottoEtAl1960MWL,
}
RATIO_EVOLUTION_VARIANTS = {
    "MerlivatAndJouzel1979": MerlivatAndJouzel1979,
    "RayleighDistillation": RayleighDistillation,
    "GedzelmanAndArnold1994": GedzelmanAndArnold1994,
}
RELAXATION_TIMESCALE_VARIANTS = {
    "Bolin1958": Bolin1958,
    "MiyakeEtAl1968": MiyakeEtAl1968,
    "JouzelEtAl1975": JouzelEtAl1975,
    "ZabaEtAl": ZabaEtAl,
}
TEMPERATURE_INFERENCE_VARIANTS = {
    "PicciottoEtAl1960": PicciottoEtAl1960Temperature,
}
VENTILATION_RATIO_VARIANTS = {
    "Neglect": VentilationNeglect,
    "Brutsaert1982": Brutsaert1982,
}
