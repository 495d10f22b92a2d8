"""The smaller single-purpose families (port of
``pysdm_tpu/physics/misc_families.py``): particle advection, hydrostatics,
air dynamic viscosity, ventilation, surface tension (``Constant``; the film
variants are in ``surface_tension.py``), the diffusion coordinate, the
terminal velocity (``GunnKinzer1949``, whose table, and ``PowerSeries``,
whose power law, live in ``dynamics/terminal_velocity.py``; ``RogersYau``),
the optical albedo and depth, and the bulk phase partitioning
(``KaulEtAl2015``)."""

from . import _xp


# --- particle_advection -----------------------------------------------------
class ExplicitInSpace:
    @staticmethod
    def displacement(const, position_in_cell, c_l, c_r):
        return c_l * (1 - position_in_cell) + c_r * position_in_cell


class ImplicitInSpace:
    """eqs. 14-16 in Arabas et al. 2015"""

    @staticmethod
    def displacement(const, position_in_cell, c_l, c_r):
        return (c_l * (1 - position_in_cell) + c_r * position_in_cell) / (1 - c_r + c_l)


PARTICLE_ADVECTION_VARIANTS = {
    "ExplicitInSpace": ExplicitInSpace,
    "ImplicitInSpace": ImplicitInSpace,
}


# --- terminal_velocity -------------------------------------------------------
class GunnKinzer1949:
    """the Gunn & Kinzer 1949 table; the attribute resolver interpolates it
    (``dynamics/terminal_velocity.py``)"""


class PowerSeries:
    """a power law in the radius; the attribute resolver evaluates
    ``dynamics/terminal_velocity.py`` ``PowerSeries``"""


class RogersYau:
    @staticmethod
    def v_term(const, radius):
        """eqs 8.5, 8.6, 8.8 in Rogers & Yau 1989"""
        return _xp.where(
            radius < const.ROGERS_YAU_TERM_VEL_SMALL_R_LIMIT,
            const.ROGERS_YAU_TERM_VEL_SMALL_K * radius**2,
            _xp.where(
                radius < const.ROGERS_YAU_TERM_VEL_MEDIUM_R_LIMIT,
                const.ROGERS_YAU_TERM_VEL_MEDIUM_K * radius,
                const.ROGERS_YAU_TERM_VEL_LARGE_K * _xp.sqrt(radius),
            ),
        )


TERMINAL_VELOCITY_VARIANTS = {
    "GunnKinzer1949": GunnKinzer1949,
    "PowerSeries": PowerSeries,
    "RogersYau": RogersYau,
}


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


class VariableGIsothermal:
    @staticmethod
    def pressure(const, z, p0, temperature, molar_mass):
        return p0 * _xp.exp(
            -const.g_std
            / const.R_str
            * molar_mass
            / temperature
            * z
            / (1 + z / const.celestial_body_radius)
        )


HYDROSTATICS_VARIANTS = {
    "ConstantGVapourMixingRatioAndThetaStd": ConstantGVapourMixingRatioAndThetaStd,
    "VariableGIsothermal": VariableGIsothermal,
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


class Froessling1938:
    @staticmethod
    def ventilation_coefficient(const, sqrt_re_times_cbrt_sc):
        return const.FROESSLING_1938_A + const.FROESSLING_1938_B * sqrt_re_times_cbrt_sc


class PruppacherAndRasmussen1979:
    @staticmethod
    def ventilation_coefficient(const, sqrt_re_times_cbrt_sc):
        return _xp.where(
            sqrt_re_times_cbrt_sc < const.PRUPPACHER_RASMUSSEN_1979_XTHRES,
            const.PRUPPACHER_RASMUSSEN_1979_CONSTSMALL
            + const.PRUPPACHER_RASMUSSEN_1979_COEFFSMALL
            * _xp.power(
                sqrt_re_times_cbrt_sc, const.PRUPPACHER_RASMUSSEN_1979_POWSMALL
            ),
            const.PRUPPACHER_RASMUSSEN_1979_CONSTBIG
            + const.PRUPPACHER_RASMUSSEN_1979_COEFFBIG * sqrt_re_times_cbrt_sc,
        )


VENTILATION_VARIANTS = {
    "Neglect": VentilationNeglect,
    "Froessling1938": Froessling1938,
    "PruppacherAndRasmussen1979": PruppacherAndRasmussen1979,
}


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


class Null:
    """placeholder variant for families with no physics selected"""


# fragmentation_function: the names the JAX package accepts
# (``pysdm_tpu/physics/formulae.py:133-144``), each bound to Null
FRAGMENTATION_FUNCTION_VARIANTS = {
    name: Null
    for name in (
        "Null", "AlwaysN", "ConstantMass", "Exponential", "ExponFrag",
        "Feingold1988", "Gaussian", "LowList1982Nf", "SLAMS", "Straub2010Nf",
    )
}


# --- optical_albedo / optical_depth -----------------------------------------
class Bohren1987:
    """cloud albedo from optical depth (reference
    ``physics/optical_albedo/bohren1987.py``, Bohren 1987 eq. 14)"""

    @staticmethod
    def albedo(const, tau):
        return ((1.0 - const.asymmetry_g) * tau) / (
            2.0 + (1.0 - const.asymmetry_g) * tau
        )


class Stephens1978:
    """cloud optical depth from LWP and effective radius (reference
    ``physics/optical_depth/stephens_1978.py``, Stephens 1978 eq. 7)"""

    @staticmethod
    def tau(const, LWP, reff):
        return (1.5 * LWP) / (const.rho_w * reff)


OPTICAL_ALBEDO_VARIANTS = {"Null": Null, "Bohren1987": Bohren1987}
OPTICAL_DEPTH_VARIANTS = {"Null": Null, "Stephens1978": Stephens1978}


# --- bulk_phase_partitioning -------------------------------------------------
class KaulEtAl2015:
    """bulk liquid fraction against temperature (reference
    ``physics/bulk_phase_partitioning/kaul_et_al_2015.py``, Kaul et al. 2015
    eq. 1)"""

    @staticmethod
    def liquid_fraction(const, T):
        return _xp.minimum(
            _xp.power(
                _xp.maximum(
                    (T - const.bulk_phase_partitioning_T_cold)
                    / (
                        const.bulk_phase_partitioning_T_warm
                        - const.bulk_phase_partitioning_T_cold
                    ),
                    0.0,
                ),
                const.bulk_phase_partitioning_exponent,
            ),
            1.0,
        )


BULK_PHASE_PARTITIONING_VARIANTS = {"KaulEtAl2015": KaulEtAl2015}
