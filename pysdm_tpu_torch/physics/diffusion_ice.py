"""Ice-phase diffusional-growth families (port of
``pysdm_tpu/physics/diffusion_ice.py``; reference
``PySDM/physics/diffusion_ice_kinetics/`` and ``diffusion_ice_capacity/``):
transition-regime corrections (Lamb & Verlinde 2011 ch. 8.2) and crystal
capacitance shapes."""

from . import _xp


class KineticsNeglect:
    @staticmethod
    def lambdaD(const, T, p):
        return -1.0 + 0.0 * T

    @staticmethod
    def lambdaK(const, T, p):
        return -1.0 + 0.0 * T

    @staticmethod
    def D(const, D, r, lmbd, T):
        return D

    @staticmethod
    def K(const, K, r, lmbd, T, rho):
        return K


class KineticsStandard:
    """transition-regime correction with the vapour free path after
    Pruppacher & Klett 2010 (13.1)"""

    @staticmethod
    def lambdaD(const, T, p):
        return const.lmbd_w_0 * T / const.T_STP * const.p_STP / p

    @staticmethod
    def lambdaK(const, T, p):
        return const.lmbd_w_0 * T / const.T_STP * const.p_STP / p

    @staticmethod
    def D(const, D, r, lmbd, T):
        return D / (
            r / (r + lmbd * const.C_cunn)
            + 4.0 * D / const.MAC_ice / _xp.sqrt(8.0 * const.Rv * T / const.PI) / r
        )

    @staticmethod
    def K(const, K, r, lmbd, T, rho):
        return K / (
            r / (r + lmbd)
            + K
            / const.HAC_ice
            / _xp.sqrt(8.0 * const.Rd * T / const.PI)
            / const.c_pd
            / rho
            / r
        )


class CapacitySpherical:
    @staticmethod
    def capacity(const, mass):
        return _xp.power(abs(mass) / const.PI_4_3 / const.rho_i, const.ONE_THIRD)


class CapacityColumnar:
    """prolate-ellipsoid capacitance (Spichtinger et al. 2023 eqs. A11-A12)"""

    @staticmethod
    def capacity(const, mass):
        m = abs(mass)
        return (
            const.capacity_columnar_ice_A1 * m**const.capacity_columnar_ice_B1
            + const.capacity_columnar_ice_A2 * m**const.capacity_columnar_ice_B2
        )

    @staticmethod
    def reference_capacity(const, polar_diameter, eccentricity):
        return (
            polar_diameter
            * eccentricity
            / _xp.log((1 + eccentricity) / (1 - eccentricity))
        )


KINETICS_VARIANTS = {"Neglect": KineticsNeglect, "Standard": KineticsStandard}
CAPACITY_VARIANTS = {"Spherical": CapacitySpherical, "Columnar": CapacityColumnar}
