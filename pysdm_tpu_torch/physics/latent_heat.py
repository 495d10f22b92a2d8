"""Latent heat of vapourisation and of sublimation (port of
``pysdm_tpu/physics/latent_heat.py``; reference
``PySDM/physics/latent_heat_vapourisation/`` and
``latent_heat_sublimation/``)."""

from . import _xp


class Constant:
    @staticmethod
    def lv(const, T):
        return const.l_tri


class Kirchhoff:
    @staticmethod
    def lv(const, T):
        return const.l_tri + (const.c_pv - const.c_pw) * (T - const.T_tri)


class SeinfeldPandis:
    @staticmethod
    def lv(const, T):
        return const.l_tri * (const.T_tri / T) ** (const.l_l19_a + const.l_l19_b * T)


class Lowe2019(SeinfeldPandis):
    pass


VAPOURISATION_VARIANTS = {
    "Constant": Constant,
    "Kirchhoff": Kirchhoff,
    "SeinfeldPandis": SeinfeldPandis,
    "Lowe2019": Lowe2019,
}


class MurphyKoop2005Sublimation:
    @staticmethod
    def ls(const, T):
        """eq. (5) in Murphy & Koop 2005 (J/mol there; converted via Mv),
        valid T > 30 K"""
        return (
            const.MK05_SUB_C1
            + const.MK05_SUB_C2 * T
            - const.MK05_SUB_C3 * T**2
            + const.MK05_SUB_C4 * _xp.exp(-((T / const.MK05_SUB_C5) ** 2))
        ) / const.Mv


SUBLIMATION_VARIANTS = {"MurphyKoop2005": MurphyKoop2005Sublimation}
