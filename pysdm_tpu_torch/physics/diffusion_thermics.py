"""Temperature and pressure dependence of vapour diffusivity and thermal
conductivity: the ``Neglect`` variant of
``pysdm_tpu/physics/diffusion_thermics.py``. The other variants come with
the rest of physics/ (ROADMAP)."""


class Neglect:
    @staticmethod
    def D(const, T, p):
        return const.D0

    @staticmethod
    def K(const, T, p):
        return const.K0


VARIANTS = {"Neglect": Neglect}
