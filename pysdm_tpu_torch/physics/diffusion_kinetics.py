"""Transition-regime corrections for condensational growth: the
``FuchsSutugin`` and ``Neglect`` variants of
``pysdm_tpu/physics/diffusion_kinetics.py``. The other variants come with
the rest of physics/ (ROADMAP)."""

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


VARIANTS = {"FuchsSutugin": FuchsSutugin, "Neglect": Neglect}
