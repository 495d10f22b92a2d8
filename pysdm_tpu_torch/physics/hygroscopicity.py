"""kappa-Koehler hygroscopicity (port of
``pysdm_tpu/physics/hygroscopicity.py``, Petters & Kreidenweis 2007)."""

from . import _xp


class KappaKoehler:
    @staticmethod
    def RH_eq(const, r, T, kp, rd3, sgm):
        return (
            _xp.exp((2 * sgm / const.Rv / T / const.rho_w) / r)
            * (r**3 - rd3)
            / (r**3 - rd3 * (1 - kp))
        )

    @staticmethod
    def r_cr(const, kp, rd3, T, sgm):
        return _xp.sqrt(3 * kp * rd3 / (2 * sgm / const.Rv / T / const.rho_w))


class KappaKoehlerLeadingTerms:
    @staticmethod
    def RH_eq(const, r, T, kp, rd3, sgm):
        return (
            1
            + (2 * sgm / const.Rv / T / const.rho_w) / r
            - kp * rd3 / _xp.power(r, const.THREE)
        )

    @staticmethod
    def r_cr(const, kp, rd3, T, sgm):
        return _xp.sqrt(3 * kp * rd3 / (2 * sgm / const.Rv / T / const.rho_w))


VARIANTS = {
    "KappaKoehler": KappaKoehler,
    "KappaKoehlerLeadingTerms": KappaKoehlerLeadingTerms,
}
