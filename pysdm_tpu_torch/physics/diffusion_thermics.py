"""Temperature and pressure dependence of vapour diffusivity D and thermal
conductivity K (port of ``pysdm_tpu/physics/diffusion_thermics.py``;
reference ``PySDM/physics/diffusion_thermics/``)."""

from . import _xp


class Neglect:
    @staticmethod
    def D(const, T, p):
        return const.D0

    @staticmethod
    def K(const, T, p):
        return const.K0


class TracyWelchPorter:
    @staticmethod
    def D(const, T, p):
        return const.D0 * _xp.power(T / const.T0, const.D_exp) * (const.p1000 / p)

    @staticmethod
    def K(const, T, p):
        return const.K0


class SeinfeldAndPandis2010:
    @staticmethod
    def D(const, T, p):
        return (
            const.d_l19_a * (const.p_STP / p) * _xp.power(T / const.T0, const.d_l19_b)
        )

    @staticmethod
    def K(const, T, p):
        return const.K0


class LoweEtAl2019(SeinfeldAndPandis2010):
    @staticmethod
    def K(const, T, p):
        return const.k_l19_a * (const.k_l19_b + const.k_l19_c * T)


class GrabowskiEtAl2011:
    @staticmethod
    def D(const, T, p):
        """eq (10)"""
        return const.diffusion_thermics_D_G11_A * (
            const.diffusion_thermics_D_G11_B * T + const.diffusion_thermics_D_G11_C
        )

    @staticmethod
    def K(const, T, p):
        """eq (12)"""
        return (
            const.diffusion_thermics_K_G11_A * _xp.integer_power(T, 3)
            + const.diffusion_thermics_K_G11_B * _xp.integer_power(T, 2)
            + const.diffusion_thermics_K_G11_C * T
            + const.diffusion_thermics_K_G11_D
        )


VARIANTS = {
    "Neglect": Neglect,
    "TracyWelchPorter": TracyWelchPorter,
    "SeinfeldAndPandis2010": SeinfeldAndPandis2010,
    "LoweEtAl2019": LoweEtAl2019,
    "GrabowskiEtAl2011": GrabowskiEtAl2011,
}
