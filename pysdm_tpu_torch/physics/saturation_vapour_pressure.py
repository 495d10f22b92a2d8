"""Saturation vapour pressure variants (port of
``pysdm_tpu/physics/saturation_vapour_pressure.py``; reference
``PySDM/physics/saturation_vapour_pressure/``): the same variant names and
fit coefficients, each body written against ``_xp``."""

import math

from . import _xp


class AugustRocheMagnus:
    @staticmethod
    def pvs_water(const, T):
        return const.ARM_C1 * _xp.exp(
            (const.ARM_C2 * (T - const.T0)) / ((T - const.T0) + const.ARM_C3)
        )

    @staticmethod
    def pvs_ice(const, T):
        return math.nan * (T - const.T0) / const.ARM_C3 * const.ARM_C1


class Bolton1980:
    @staticmethod
    def pvs_water(const, T):
        """valid for -30C <= T <= 35C, eq. (10)"""
        return const.B80W_G0 * _xp.exp(
            (const.B80W_G1 * (T - const.T0)) / ((T - const.T0) + const.B80W_G2)
        )

    @staticmethod
    def pvs_ice(const, T):
        return math.nan * (T - const.T0) / const.B80W_G2 * const.B80W_G0


def _horner(coefficients, dT):
    acc = coefficients[-1]
    for coeff in coefficients[-2::-1]:
        acc = coeff + dT * acc
    return acc


class FlatauWalkoCotton:
    """Flatau et al. 1992 polynomial fits (Horner form)"""

    @staticmethod
    def pvs_water(const, T):
        return _horner(
            tuple(getattr(const, f"FWC_C{k}") for k in range(9)), T - const.T0
        )

    @staticmethod
    def pvs_ice(const, T):
        return _horner(
            tuple(getattr(const, f"FWC_I{k}") for k in range(9)), T - const.T0
        )


class Lowe1977:
    @staticmethod
    def pvs_water(const, T):
        return _horner(
            tuple(getattr(const, f"L77W_A{k}") for k in range(7)), T - const.T0
        )

    @staticmethod
    def pvs_ice(const, T):
        return _horner(
            tuple(getattr(const, f"L77I_A{k}") for k in range(7)), T - const.T0
        )


class MurphyKoop2005:
    @staticmethod
    def pvs_water(const, T):
        """valid for 123 < T < 332 K, eq (10)"""
        return const.MK05_LIQ_C1 * _xp.exp(
            const.MK05_LIQ_C2
            - const.MK05_LIQ_C3 / T
            - const.MK05_LIQ_C4 * _xp.log(T / const.MK05_LIQ_C5)
            + const.MK05_LIQ_C6 * T
            + _xp.tanh(const.MK05_LIQ_C7 * (T - const.MK05_LIQ_C8))
            * (
                const.MK05_LIQ_C9
                - const.MK05_LIQ_C10 / T
                - const.MK05_LIQ_C11 * _xp.log(T / const.MK05_LIQ_C12)
                + const.MK05_LIQ_C13 * T
            )
        )

    @staticmethod
    def pvs_ice(const, T):
        """valid for T > 110 K, eq (7)"""
        return const.MK05_ICE_C1 * _xp.exp(
            const.MK05_ICE_C2
            - const.MK05_ICE_C3 / T
            + const.MK05_ICE_C4 * _xp.log(T / const.MK05_ICE_C5)
            - const.MK05_ICE_C6 * T
        )


class Wexler1976:
    @staticmethod
    def pvs_water(const, T):
        return (
            _xp.exp(
                const.W76W_G0 / _xp.integer_power(T, 2)
                + const.W76W_G1 / T
                + const.W76W_G2
                + const.W76W_G3 * T
                + const.W76W_G4 * _xp.integer_power(T, 2)
                + const.W76W_G5 * _xp.integer_power(T, 3)
                + const.W76W_G6 * _xp.integer_power(T, 4)
                + const.W76W_G7 * _xp.log(T / const.one_kelvin)
            )
            * const.W76W_G8
        )

    @staticmethod
    def pvs_ice(const, T):
        return math.nan * (T - const.T0) / const.B80W_G2 * const.B80W_G0


VARIANTS = {
    "AugustRocheMagnus": AugustRocheMagnus,
    "Bolton1980": Bolton1980,
    "FlatauWalkoCotton": FlatauWalkoCotton,
    "Lowe1977": Lowe1977,
    "MurphyKoop2005": MurphyKoop2005,
    "Wexler1976": Wexler1976,
}
