"""Shared helper formulae ("trivia"), port of
``pysdm_tpu/physics/trivia.py``: the liquid-phase and ice helpers, the
chemistry helpers (pH, van 't Hoff, Arrhenius, mixing ratios) and the
isotopic ratio helpers.

Each body is arithmetic on its arguments or goes through ``_xp``, so the
same function serves Python floats, NumPy arrays (set-up) and torch tensors
(the step). All methods take the constants namespace as first argument
(bound by ``Formulae``).
"""

from . import _xp


class Trivia:
    @staticmethod
    def volume_of_density_mass(const, rho, m):
        return m / rho

    @staticmethod
    def radius(const, volume):
        return (volume / const.PI_4_3) ** const.ONE_THIRD

    @staticmethod
    def area(const, radius):
        return const.PI * const.FOUR * radius**const.TWO

    @staticmethod
    def volume(const, radius):
        return const.PI_4_3 * radius**const.THREE

    @staticmethod
    def sphere_surface(const, diameter):
        return const.PI * diameter**2

    @staticmethod
    def explicit_euler(const, y, dt, dy_dt):
        return y + dt * dy_dt

    @staticmethod
    def K2C(const, TK):
        return TK - const.T0

    @staticmethod
    def C2K(const, TC):
        return TC + const.T0

    @staticmethod
    def within_tolerance(const, error_estimate, value, rtol):
        return error_estimate < rtol * abs(value)

    @staticmethod
    def p_d(const, p, water_vapour_mixing_ratio):
        return p * (1 - 1 / (1 + const.eps / water_vapour_mixing_ratio))

    @staticmethod
    def th_std(const, p, T):
        return T * _xp.power(const.p1000 / p, const.Rd_over_c_pd)

    @staticmethod
    def air_schmidt_number(const, dynamic_viscosity, diffusivity, density):
        return dynamic_viscosity / diffusivity / density

    @staticmethod
    def sqrt_re_times_cbrt_sc(const, Re, Sc):
        return _xp.power(Re, const.ONE_HALF) * _xp.power(Sc, const.ONE_THIRD)

    @staticmethod
    def unfrozen(const, signed_water_mass):
        return signed_water_mass > 0

    @staticmethod
    def unfrozen_and_saturated(const, signed_water_mass, relative_humidity):
        return (signed_water_mass > 0) & (relative_humidity > 1)

    @staticmethod
    def unfrozen_and_ice_saturated(const, signed_water_mass, relative_humidity_ice):
        return (signed_water_mass > 0) & (relative_humidity_ice > 1)

    @staticmethod
    def frozen_and_above_freezing_point(const, signed_water_mass, temperature):
        return (signed_water_mass < 0) & (temperature > const.T0)

    @staticmethod
    def erfinv_approx(const, c):
        """Vedder 1987 eqs. 11-12 approximation of the inverse error function"""
        return (
            2
            * _xp.sqrt(const.VEDDER_1987_A)
            * _xp.sinh(
                _xp.arcsinh(
                    _xp.arctanh(c)
                    / 2
                    / const.VEDDER_1987_b
                    / _xp.power(const.VEDDER_1987_A, const.ONE_AND_A_HALF)
                )
                / 3
            )
        )

    @staticmethod
    def poissonian_avoidance_function(const, r, dt):
        return _xp.exp(-r * dt)

    @staticmethod
    def H2pH(const, H):
        return -_xp.log10(H * 1e-3)

    @staticmethod
    def pH2H(const, pH):
        return _xp.power(10.0, -pH) * 1e3

    @staticmethod
    def vant_hoff(const, K, dH, T, *, T_0):
        return K * _xp.exp(-dH / const.R_str * (1 / T - 1 / T_0))

    @staticmethod
    def tdep2enthalpy(const, tdep):
        return -tdep * const.R_str

    @staticmethod
    def arrhenius(const, A, Ea, T):
        return A * _xp.exp(-Ea / (const.R_str * T))

    @staticmethod
    def mole_fraction_2_mixing_ratio(const, mole_fraction, specific_gravity):
        return specific_gravity * mole_fraction / (1 - mole_fraction)

    @staticmethod
    def mixing_ratio_2_mole_fraction(const, mixing_ratio, specific_gravity):
        return mixing_ratio / (specific_gravity + mixing_ratio)

    @staticmethod
    def mixing_ratio_to_specific_content(const, mixing_ratio):
        return mixing_ratio / (1 + mixing_ratio)

    @staticmethod
    def dn_dlogr(const, r, dn_dr):
        return _xp.log(10.0) * r * dn_dr

    @staticmethod
    def isotopic_delta_2_ratio(const, delta, reference_ratio):
        return (delta + 1) * reference_ratio

    @staticmethod
    def isotopic_ratio_2_delta(const, ratio, reference_ratio):
        return ratio / reference_ratio - 1

    @staticmethod
    def isotopic_enrichment_to_delta_SMOW(const, E, delta_0_SMOW):
        return (E + 1) * (delta_0_SMOW + 1) - 1
