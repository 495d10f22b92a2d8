"""IsotopicFractionation dynamic (port of
``pysdm_tpu/dynamics/isotopic_fractionation.py``; reference
``PySDM/dynamics/isotopic_fractionation.py``): fractionation of water
isotopologues across condensation. In the reference the backend kernel is a
stub on both CPU and GPU (``isotope_methods.py:28``), and so it is in the
JAX package and here: the dynamic checks its wiring (Condensation
registered before it) and requests the heavy isotopes' mole amounts, and
its step leaves the state as it is."""

LIGHT_ISOTOPES = ("1H", "16O")
HEAVY_ISOTOPES = ("2H", "3H", "17O", "18O")


class IsotopicFractionation:
    def __init__(self, isotopes: tuple = HEAVY_ISOTOPES):
        self.isotopes = isotopes
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        keys = list(self.particulator.dynamics.keys())
        if "Condensation" not in keys or keys.index("Condensation") > keys.index(
            "IsotopicFractionation"
        ):
            raise AssertionError(
                "Condensation needs to be registered to run prior to"
                " IsotopicFractionation"
            )
        for isotope in self.isotopes:
            builder.request_attribute(f"moles_{isotope}")

    def make_step(self, particulator):
        def step(sim):
            return sim

        return step
