"""Transition-regime corrections for condensational growth (port of
``pysdm_tpu/physics/diffusion_kinetics.py``; reference
``PySDM/physics/diffusion_kinetics/``)."""

import math

from . import _xp


class FuchsSutugin:
    @staticmethod
    def lambdaD(const, D, T):
        return D / _xp.sqrt(2 * const.Rv * T)

    @staticmethod
    def lambdaK(const, T, p):
        return (4.0 / 5) * const.K0 * T / p / _xp.sqrt(2 * const.Rd * T)

    @staticmethod
    def D(const, D, r, lmbd):
        return (
            D
            * (1 + lmbd / r)
            / (
                1
                + (4.0 / 3 / const.MAC + 0.377) * lmbd / r
                + (4.0 / 3 / const.MAC) * lmbd / r * lmbd / r
            )
        )

    @staticmethod
    def K(const, K, r, lmbd):
        return (
            K
            * (1 + lmbd / r)
            / (
                1
                + (4.0 / 3 / const.HAC + 0.377) * lmbd / r
                + (4.0 / 3 / const.HAC) * lmbd / r * lmbd / r
            )
        )


class Neglect:
    @staticmethod
    def lambdaD(const, D, T):
        return -1.0

    @staticmethod
    def lambdaK(const, T, p):
        return -1.0

    @staticmethod
    def D(const, D, r, lmbd):
        return D

    @staticmethod
    def K(const, K, r, lmbd):
        return K


class PruppacherKlett:
    """Pruppacher & Klett 2005 eq. 13-14 (Okuyama & Zung 1967)"""

    @staticmethod
    def lambdaD(const, D, T):
        return D / _xp.sqrt(2 * const.Rv * T)

    @staticmethod
    def lambdaK(const, T, p):
        return -1.0

    @staticmethod
    def D(const, D, r, lmbd):
        return D / (
            (r / (r + const.dv_pk05)) + 2 * math.sqrt(const.PI) * lmbd / r / const.MAC
        )

    @staticmethod
    def K(const, K, r, lmbd):
        return K


class GrabowskiEtAl2011(PruppacherKlett):
    pass


class LoweEtAl2019(PruppacherKlett):
    @staticmethod
    def lambdaK(const, T, p):
        return -1.0

    @staticmethod
    def K(const, K, r, lmbd):
        return K


VARIANTS = {
    "FuchsSutugin": FuchsSutugin,
    "Neglect": Neglect,
    "PruppacherKlett": PruppacherKlett,
    "GrabowskiEtAl2011": GrabowskiEtAl2011,
    "LoweEtAl2019": LoweEtAl2019,
}
