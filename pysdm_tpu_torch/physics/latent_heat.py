"""Latent heat of vapourisation: the ``Kirchhoff`` variant of
``pysdm_tpu/physics/latent_heat.py``. The other variants come with the rest
of physics/ (ROADMAP)."""


class Kirchhoff:
    @staticmethod
    def lv(const, T):
        return const.l_tri + (const.c_pv - const.c_pw) * (T - const.T_tri)


VAPOURISATION_VARIANTS = {"Kirchhoff": Kirchhoff}
