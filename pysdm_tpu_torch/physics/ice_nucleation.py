"""Ice-nucleation families (port of ``pysdm_tpu/physics/ice_nucleation.py``;
reference ``PySDM/physics/freezing_temperature_spectrum/``,
``heterogeneous_ice_nucleation_rate/``,
``homogeneous_ice_nucleation_rate/``): singular freezing-temperature
spectra, immersion-freezing rates J_het and homogeneous-freezing rates
J_hom.

The polynomials in Koop et al. 2000 and Koop & Murray 2016 cancel large
terms (up to ~5.6e4 for a sum of order 10), so their powers are taken by
``_xp.integer_power``, in the order of the JAX package's multiplications:
in float64 the two packages then agree to rounding, and in float32 both
lose the same digits (ROADMAP, float32 homogeneous rates).
"""

from . import _xp


# --- freezing temperature spectra (singular) ---------------------------------
class NiemandEtAl2012:
    """INAS-density-based spectrum (Niemand et al. 2012, JAS 69)"""

    @staticmethod
    def ns(const, T):
        return _xp.exp(const.NIEMAND_A * (T - const.T0) + const.NIEMAND_B)

    @staticmethod
    def pdf(const, T, A_insol):
        ns_T = _xp.exp(const.NIEMAND_A * (T - const.T0) + const.NIEMAND_B)
        return -A_insol * const.NIEMAND_A * ns_T * _xp.exp(-A_insol * ns_T)

    @staticmethod
    def cdf(const, T, A_insol):
        ns_T = _xp.exp(const.NIEMAND_A * (T - const.T0) + const.NIEMAND_B)
        return (
            1
            - _xp.exp(-A_insol * ns_T)
            - _xp.exp(
                -A_insol * _xp.exp(-const.NIEMAND_A * const.T0 + const.NIEMAND_B)
            )
        )

    @staticmethod
    def invcdf(const, cdf, A_insol):
        tmp = _xp.log(
            (
                _xp.log(1 - cdf)
                + _xp.exp(
                    -A_insol
                    * _xp.exp(-const.NIEMAND_A * const.T0 + const.NIEMAND_B)
                )
            )
            / -A_insol
        )
        return const.T0 + (tmp - const.NIEMAND_B) / const.NIEMAND_A


class Bigg1953:
    """immersed-surface-independent spectrum (Bigg 1953)"""

    @staticmethod
    def pdf(const, T, A_insol):
        A = _xp.log(1 - 0.5)
        B = const.BIGG_DT_MEDIAN - const.T0
        return -A * _xp.exp(A * _xp.exp(B + T) + B + T)

    @staticmethod
    def cdf(const, T, A_insol):
        return _xp.exp(
            _xp.log(1 - 0.5) * _xp.exp(const.BIGG_DT_MEDIAN - (const.T0 - T))
        )

    @staticmethod
    def invcdf(const, cdf, A_insol):
        return const.T0 - const.BIGG_DT_MEDIAN + _xp.log(
            _xp.log(cdf) / _xp.log(1 - 0.5)
        )

    @staticmethod
    def median(const):
        return const.T0 - const.BIGG_DT_MEDIAN


# --- heterogeneous (immersion) nucleation rates ------------------------------
class ABIFM:
    """water-activity-based immersion freezing (Knopf & Alpert 2013)"""

    @staticmethod
    def j_het(const, a_w_ice):
        return (
            10 ** (const.ABIFM_M * (1 - a_w_ice) + const.ABIFM_C) * const.ABIFM_UNIT
        )


class ConstantHet:
    @staticmethod
    def j_het(const, a_w_ice):
        return const.J_HET + 0.0 * a_w_ice


# --- homogeneous nucleation rates ---------------------------------------------
class _KoopRange:
    @staticmethod
    def d_a_w_ice_within_range(const, da_w_ice):
        return da_w_ice >= const.KOOP_MIN_DA_W_ICE

    @staticmethod
    def d_a_w_ice_maximum(const, da_w_ice):
        return _xp.minimum(da_w_ice, const.KOOP_MAX_DA_W_ICE)


def _koop_2000_log10(const, da_w_ice):
    return (
        const.KOOP_2000_C1
        + const.KOOP_2000_C2 * da_w_ice
        + const.KOOP_2000_C3 * _xp.integer_power(da_w_ice, 2)
        + const.KOOP_2000_C4 * _xp.integer_power(da_w_ice, 3)
    )


class Koop2000(_KoopRange):
    """solution droplets, 0.26 < da_w_ice < 0.34 (Koop et al. 2000)"""

    @staticmethod
    def j_hom(const, T, da_w_ice):
        return 10 ** _koop_2000_log10(const, da_w_ice) * const.KOOP_UNIT


class Koop_Correction(_KoopRange):
    """Koop-2000 shifted to match Koop & Murray 2016 at water saturation
    (Spichtinger et al. 2023)"""

    @staticmethod
    def j_hom(const, T, da_w_ice):
        return (
            10 ** (_koop_2000_log10(const, da_w_ice) + const.KOOP_CORR)
            * const.KOOP_UNIT
        )


class KoopMurray2016(_KoopRange):
    """pure-water droplets at water saturation (Koop & Murray 2016 eq. A9)"""

    @staticmethod
    def j_hom(const, T, da_w_ice):
        dT = T - const.T0
        return (
            10
            ** (
                const.KOOP_MURRAY_C0
                + const.KOOP_MURRAY_C1 * dT
                + const.KOOP_MURRAY_C2 * _xp.integer_power(dT, 2)
                + const.KOOP_MURRAY_C3 * _xp.integer_power(dT, 3)
                + const.KOOP_MURRAY_C4 * _xp.integer_power(dT, 4)
                + const.KOOP_MURRAY_C5 * _xp.integer_power(dT, 5)
                + const.KOOP_MURRAY_C6 * _xp.integer_power(dT, 6)
            )
            * const.KOOP_UNIT
        )


class ConstantHom:
    @staticmethod
    def d_a_w_ice_within_range(const, da_w_ice):
        return da_w_ice == da_w_ice  # always True, elementwise

    @staticmethod
    def d_a_w_ice_maximum(const, da_w_ice):
        return da_w_ice

    @staticmethod
    def j_hom(const, T, da_w_ice):
        return const.J_HOM + 0.0 * T


FREEZING_TEMPERATURE_SPECTRUM_VARIANTS = {
    "Niemand_et_al_2012": NiemandEtAl2012,
    "Bigg_1953": Bigg1953,
}

HETEROGENEOUS_RATE_VARIANTS = {
    "ABIFM": ABIFM,
    "Constant": ConstantHet,
}

HOMOGENEOUS_RATE_VARIANTS = {
    "Koop2000": Koop2000,
    "Koop_Correction": Koop_Correction,
    "KoopMurray2016": KoopMurray2016,
    "Constant": ConstantHom,
}
