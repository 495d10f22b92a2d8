"""Shared helper formulae ("trivia"), the part of
``pysdm_tpu/physics/trivia.py`` that the liquid-phase and ice slices read.

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
