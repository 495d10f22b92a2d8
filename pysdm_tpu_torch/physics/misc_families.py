"""The smaller single-purpose families the parcel reads (port of the
matching parts of ``pysdm_tpu/physics/misc_families.py``): hydrostatics,
air dynamic viscosity, ventilation (``Neglect``), surface tension
(``Constant``) and the diffusion coordinate."""

from . import _xp


# --- hydrostatics -----------------------------------------------------------
class ConstantGVapourMixingRatioAndThetaStd:
    @staticmethod
    def drho_dz(
        const, p, T, water_vapour_mixing_ratio, lv, d_liquid_water_mixing_ratio__dz=0
    ):
        Rq = const.Rv / (1 / water_vapour_mixing_ratio + 1) + const.Rd / (
            1 + water_vapour_mixing_ratio
        )
        cp = const.c_pv / (1 / water_vapour_mixing_ratio + 1) + const.c_pd / (
            1 + water_vapour_mixing_ratio
        )
        rho = p / Rq / T
        return (
            const.g_std / T * rho * (Rq / cp - 1)
            - p * lv / cp / T**2 * d_liquid_water_mixing_ratio__dz
        ) / Rq

    @staticmethod
    def p_of_z_assuming_const_th_and_initial_water_vapour_mixing_ratio(
        const, p0, thstd, water_vapour_mixing_ratio, z
    ):
        z0 = 0.0
        Rq = const.Rv / (1 / water_vapour_mixing_ratio + 1) + const.Rd / (
            1 + water_vapour_mixing_ratio
        )
        arg = (
            _xp.power(p0 / const.p1000, const.Rd_over_c_pd)
            - (z - z0) * const.Rd_over_c_pd * const.g_std / thstd / Rq
        )
        return const.p1000 * _xp.power(arg, 1 / const.Rd_over_c_pd)


HYDROSTATICS_VARIANTS = {
    "ConstantGVapourMixingRatioAndThetaStd": ConstantGVapourMixingRatioAndThetaStd,
}


# --- air_dynamic_viscosity --------------------------------------------------
class ZografosEtAl1987:
    @staticmethod
    def eta_air(const, temperature):
        """fit for T in [100, 3000] K; neglects pressure effects"""
        return (
            const.ZOGRAFOS_1987_COEFF_T3 * temperature**3
            + const.ZOGRAFOS_1987_COEFF_T2 * temperature**2
            + const.ZOGRAFOS_1987_COEFF_T1 * temperature
            + const.ZOGRAFOS_1987_COEFF_T0
        )


AIR_DYNAMIC_VISCOSITY_VARIANTS = {"ZografosEtAl1987": ZografosEtAl1987}


# --- ventilation ------------------------------------------------------------
class VentilationNeglect:
    @staticmethod
    def ventilation_coefficient(const, sqrt_re_times_cbrt_sc):
        return _xp.power(sqrt_re_times_cbrt_sc, 0)


VENTILATION_VARIANTS = {"Neglect": VentilationNeglect}


# --- surface_tension --------------------------------------------------------
class SurfaceTensionConstant:
    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        return const.sgm_w


SURFACE_TENSION_VARIANTS = {"Constant": SurfaceTensionConstant}


# --- diffusion_coordinate ---------------------------------------------------
class WaterMass:
    @staticmethod
    def dx_dt(const, m, dm_dt):
        return dm_dt

    @staticmethod
    def mass(const, x):
        return x

    @staticmethod
    def x(const, mass):
        return mass

    @staticmethod
    def x_max(const):
        """1 kg droplet!"""
        return const.ONE


class WaterMassLogarithm:
    @staticmethod
    def dx_dt(const, m, dm_dt):
        return dm_dt / m

    @staticmethod
    def mass(const, x):
        return _xp.exp(x)

    @staticmethod
    def x(const, mass):
        return _xp.log(mass)

    @staticmethod
    def x_max(const):
        return const.ZERO


DIFFUSION_COORDINATE_VARIANTS = {
    "WaterMass": WaterMass,
    "WaterMassLogarithm": WaterMassLogarithm,
}
