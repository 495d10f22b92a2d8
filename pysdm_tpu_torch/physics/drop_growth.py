"""Condensational drop-growth variants (port of
``pysdm_tpu/physics/drop_growth.py``; Rogers & Yau notation)."""


class Fick:
    @staticmethod
    def Fk(const, T, K, lv):
        """heat conduction not taken into account"""
        return 0.0

    @staticmethod
    def Fd(const, T, D, pvs):
        """term associated with vapour diffusion"""
        return const.rho_w * const.Rv * T / D / pvs

    @staticmethod
    def r_dr_dt(const, RH_eq, RH, Fk, Fd):
        return (RH - RH_eq) / Fd


class Howell1949(Fick):
    @staticmethod
    def Fk(const, T, K, lv):
        """thermodynamic term associated with heat conduction"""
        return const.rho_w * lv / T / K * (lv / T / const.Rv)

    @staticmethod
    def r_dr_dt(const, RH_eq, RH, Fk, Fd):
        return (RH - RH_eq) / (Fk + Fd)


class Mason1971(Howell1949):
    @staticmethod
    def Fk(const, T, K, lv):
        """thermodynamic term associated with heat conduction (with the -1)"""
        return const.rho_w * lv / T / K * (lv / T / const.Rv - 1)


VARIANTS = {
    "Fick": Fick,
    "Howell1949": Howell1949,
    "Mason1971": Mason1971,
}
