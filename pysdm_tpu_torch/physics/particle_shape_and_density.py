"""Particle shape & density variants (parity: reference
``PySDM/physics/particle_shape_and_density/``). The port has
``LiquidSpheres``; the mixed-phase and ice variants arrive with ice,
chemistry and isotopes (other dynamics; ROADMAP)."""


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


VARIANTS = {"LiquidSpheres": LiquidSpheres}
