"""Saturation vapour pressure: the ``FlatauWalkoCotton`` variant of
``pysdm_tpu/physics/saturation_vapour_pressure.py`` (Flatau et al. 1992
polynomial fits in Horner form). The other variants come with the rest of
physics/ (ROADMAP)."""


class FlatauWalkoCotton:
    @staticmethod
    def pvs_water(const, T):
        dT = T - const.T0
        c = (
            const.FWC_C0,
            const.FWC_C1,
            const.FWC_C2,
            const.FWC_C3,
            const.FWC_C4,
            const.FWC_C5,
            const.FWC_C6,
            const.FWC_C7,
            const.FWC_C8,
        )
        acc = c[-1]
        for coeff in c[-2::-1]:
            acc = coeff + dT * acc
        return acc

    @staticmethod
    def pvs_ice(const, T):
        dT = T - const.T0
        c = (
            const.FWC_I0,
            const.FWC_I1,
            const.FWC_I2,
            const.FWC_I3,
            const.FWC_I4,
            const.FWC_I5,
            const.FWC_I6,
            const.FWC_I7,
            const.FWC_I8,
        )
        acc = c[-1]
        for coeff in c[-2::-1]:
            acc = coeff + dT * acc
        return acc


VARIANTS = {"FlatauWalkoCotton": FlatauWalkoCotton}
