"""Latent heat of vapourisation and of sublimation (port of
``pysdm_tpu/physics/latent_heat.py``): the ``Kirchhoff`` vapourisation
variant and the ``MurphyKoop2005`` sublimation variant. The other
vapourisation variants come with the rest of physics/ (ROADMAP)."""

from . import _xp


class Kirchhoff:
    @staticmethod
    def lv(const, T):
        return const.l_tri + (const.c_pv - const.c_pw) * (T - const.T_tri)


VAPOURISATION_VARIANTS = {"Kirchhoff": Kirchhoff}


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
