"""Particle shape & density variants (port of
``pysdm_tpu/physics/particle_shape_and_density.py``; reference
``PySDM/physics/particle_shape_and_density/``): ``LiquidSpheres``, and the
mixed-phase ``MixedPhaseSpheres`` and ``ColumnarIce``, in which a negative
signed water mass is ice, and the geometry helpers of ``PorousSpheroid``
(which has no ``mass_to_volume`` in either package, so condensation cannot
take it)."""

from . import _xp


class LiquidSpheres:
    @staticmethod
    def supports_mixed_phase(const=None):
        return False

    @staticmethod
    def mass_to_volume(const, mass):
        return mass / const.rho_w

    @staticmethod
    def volume_to_mass(const, volume):
        return const.rho_w * volume

    @staticmethod
    def radius_to_mass(const, radius):
        return const.rho_w * const.PI_4_3 * radius**const.THREE

    @staticmethod
    def mass_to_radius(const, mass):
        return (mass / const.rho_w / const.PI_4_3) ** const.ONE_THIRD

    @staticmethod
    def reynolds_number(const, radius, velocity_wrt_air, dynamic_viscosity, density):
        return 2 * radius * velocity_wrt_air * density / dynamic_viscosity

    @staticmethod
    def dm_dt(const, r, r_dr_dt):
        return 4 * const.PI * const.rho_w * r * r_dr_dt

    @staticmethod
    def dm_dt_over_m(const, r, r_dr_dt):
        return 3 / r**2 * r_dr_dt

    @staticmethod
    def r_dr_dt(const, r, dm_dt_over_m):
        return r**2 / 3 * dm_dt_over_m


class MixedPhaseSpheres:
    """negative (signed) water mass represents the ice phase"""

    @staticmethod
    def supports_mixed_phase(const=None):
        return True

    @staticmethod
    def mass_to_volume(const, mass):
        return (
            _xp.maximum(mass, 0.0) / const.rho_w
            + _xp.minimum(mass, 0.0) / const.rho_i
        )

    @staticmethod
    def volume_to_mass(const, volume):
        return (
            _xp.maximum(volume, 0.0) * const.rho_w
            + _xp.minimum(volume, 0.0) * const.rho_i
        )

    @staticmethod
    def radius_to_mass(const, radius):
        vol = const.PI_4_3 * radius**3
        return _xp.maximum(vol, 0.0) * const.rho_w + _xp.minimum(vol, 0.0) * const.rho_i

    @staticmethod
    def mass_to_radius(const, mass):
        return _xp.power(
            _xp.maximum(mass, 0.0) / const.PI_4_3 / const.rho_w, const.ONE_THIRD
        ) + _xp.power(
            -_xp.minimum(mass, 0.0) / const.PI_4_3 / const.rho_i, const.ONE_THIRD
        )

    @staticmethod
    def reynolds_number(const, radius, velocity_wrt_air, dynamic_viscosity, density):
        return 2 * radius * velocity_wrt_air * density / dynamic_viscosity

    @staticmethod
    def dm_dt(const, r, r_dr_dt):
        return 4 * const.PI * const.rho_w * r * r_dr_dt

    @staticmethod
    def dm_dt_over_m(const, r, r_dr_dt):
        return 3 / r**2 * r_dr_dt

    @staticmethod
    def r_dr_dt(const, r, dm_dt_over_m):
        return r**2 / 3 * dm_dt_over_m


class ColumnarIce:
    """columnar ice crystals (Spichtinger & Gierens 2009 mass-length
    relations)"""

    @staticmethod
    def supports_mixed_phase(const=None):
        return True

    @staticmethod
    def mass_to_volume(const, mass):
        return -mass / const.columnar_bulk_ice_density

    @staticmethod
    def volume_to_mass(const, volume):
        return -const.columnar_bulk_ice_density * volume

    @staticmethod
    def _length(const, mass):
        m = abs(mass)
        return _xp.where(
            m < const.columnar_ice_mass_transition,
            _xp.power(
                m / const.columnar_ice_length_alpha_1,
                1 / const.columnar_ice_length_beta_1,
            ),
            _xp.power(
                m / const.columnar_ice_length_alpha_2,
                1 / const.columnar_ice_length_beta_2,
            ),
        )

    @staticmethod
    def polar_radius_empirical_parametrisation(const, mass):
        """column length/2 from mass; piecewise power law (tab. 1 S&G 2009)"""
        return ColumnarIce._length(const, mass) / 2

    @staticmethod
    def aspect_ratio_empirical_parametrisation(const, mass):
        length = ColumnarIce._length(const, mass)
        # diameter from the volume of a cylinder: V = pi/4 d^2 L
        volume = abs(mass) / const.columnar_bulk_ice_density
        diameter = _xp.sqrt(4 * volume / const.PI / length)
        return length / diameter


VARIANTS = {
    "LiquidSpheres": LiquidSpheres,
    "MixedPhaseSpheres": MixedPhaseSpheres,
    "ColumnarIce": ColumnarIce,
}


class PorousSpheroid:
    """porous spheroids (Shima et al. 2020) and prolate spheroids
    (Spichtinger & Gierens 2009): geometry helpers (reference
    ``particle_shape_and_density/porous_spheroids.py``)"""

    @staticmethod
    def supports_mixed_phase(const=None):
        return True

    @staticmethod
    def aspect_ratio(const, polar_radius, equatorial_radius):
        return polar_radius / equatorial_radius

    @staticmethod
    def equatorial_radius(const, polar_radius, aspect_ratio):
        return polar_radius / aspect_ratio

    @staticmethod
    def polar_radius(const, equatorial_radius, aspect_ratio):
        return equatorial_radius * aspect_ratio

    @staticmethod
    def eccentricity(const, aspect_ratio):
        return _xp.sqrt(1 - aspect_ratio**-2.0)


VARIANTS["PorousSpheroid"] = PorousSpheroid
