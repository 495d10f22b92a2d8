"""Fragmentation functions (parity: reference
``PySDM/dynamics/collisions/breakup_fragmentations/``), port of
``pysdm_tpu/dynamics/collisions/breakup_fragmentations.py``.

Each ``pairwise(formulae, attrs_a, attrs_b, u01)`` returns
``(n_fragment, fragment_mass)`` for the pair and its fragment draw.
``AlwaysN``, ``ConstantMass`` and ``Exponential`` (alias ``ExponFrag``) are
the JAX package's ``pallas_safe`` set: K5 (``ops/cuda/breakup.py``)
evaluates their fragment mass in its body from ``kernel_id`` and
``cuda_params``. ``Gaussian``, ``Feingold1988``, ``LowList1982Nf``,
``SLAMS`` and ``Straub2010Nf`` have no ``kernel_id``: a collision with them
takes the float64 breakup path (``ops/breakup.py``), as in the JAX package.
Their branchy per-pair control flow is where-selection over every branch,
as there: unused lanes may hold NaN or inf, which ``torch.where`` selects
away.
"""

import numpy as np
import torch

from ...physics import si
from ...ops.cuda.breakup import (
    FRAG_ALWAYS_N,
    FRAG_CONSTANT_MASS,
    FRAG_EXPONENTIAL,
    fragment_mass,
)

erf = torch.special.erf


def apply_limiters(frag_volume, total_volume, *, vmin=0.0, nfmax=None):
    """reference limiter order: clip fragment to the pair total; cap the
    fragment count at nfmax; fragments below vmin suppress breakup
    (fragment = whole pair)"""
    fv = torch.where(
        torch.isnan(frag_volume) | (frag_volume <= 0), total_volume, frag_volume
    )
    fv = torch.minimum(fv, total_volume)
    if nfmax is not None:
        too_many = total_volume / fv > nfmax
        return torch.where(
            too_many, total_volume / nfmax,
            torch.where(fv < vmin, total_volume, fv),
        )
    return torch.where(fv < vmin, total_volume, fv)


class _Fragmentation:
    required_attributes = ("water mass",)
    # the default constants' water density; ``register`` takes the
    # formulae's
    rho_w = 1.0 * si.kg / si.litre

    def register(self, builder):
        builder.request_attribute("water mass")
        self.rho_w = builder.formulae.constants.rho_w

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        """(n_fragment, fragment_mass) through the body K5's twin runs"""
        mass_a, mass_b = attrs_a["water mass"], attrs_b["water mass"]
        params = self._params(formulae.constants.rho_w)
        mass = fragment_mass(self.kernel_id, params, mass_a, mass_b, u01)
        return (mass_a + mass_b) / mass, mass

    @property
    def cuda_params(self):
        return self._params(self.rho_w)


class AlwaysN(_Fragmentation):
    kernel_id = FRAG_ALWAYS_N

    def __init__(self, n=1):
        self.n = n

    def _params(self, rho_w):
        return (float(self.n),)


class ConstantMass(_Fragmentation):
    """every fragment has the prescribed mass"""

    kernel_id = FRAG_CONSTANT_MASS

    def __init__(self, c):
        self.c = c

    def _params(self, rho_w):
        return (float(self.c),)


class Exponential(_Fragmentation):
    """exponentially-distributed fragment size (reference expon_frag
    semantics): volume -scale ln(1 - u) at least vmin, at most nfmax
    fragments"""

    kernel_id = FRAG_EXPONENTIAL

    def __init__(self, scale, vmin=0.0, nfmax=None):
        self.scale = scale  # volume scale
        self.vmin = vmin
        self.nfmax = nfmax

    def _params(self, rho_w):
        nfmax = -1.0 if self.nfmax is None else float(self.nfmax)
        return (float(self.scale), float(self.vmin), nfmax, float(rho_w))


class ExponFrag(Exponential):
    """DEPRECATED alias of Exponential (reference ``expon_frag.py``)"""


class Gaussian:
    """normally-distributed fragment volume"""

    required_attributes = ("water mass",)

    def __init__(self, mu, sigma, vmin=0.0, nfmax=None):
        self.mu = mu
        self.sigma = sigma
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("water mass")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        mass_sum = attrs_a["water mass"] + attrs_b["water mass"]
        frag_volume = self.mu + self.sigma * formulae.trivia.erfinv_approx(
            torch.clamp(2 * u01 - 1, -0.999999, 0.999999)
        )
        frag_volume = frag_volume.clamp_min(self.vmin)
        fragment_mass = frag_volume * const.rho_w
        n_fragment = mass_sum / fragment_mass.clamp_min(1e-300)
        if self.nfmax is not None:
            n_fragment = n_fragment.clamp_max(self.nfmax)
            fragment_mass = mass_sum / n_fragment
        return n_fragment, fragment_mass


class Feingold1988:
    """scaled exponential fragment-size pdf (Feingold et al. 1999; reference
    ``breakup_fragmentations/feingold1988.py``)"""

    required_attributes = ("water mass", "volume")

    def __init__(self, scale, fragtol=1e-3, vmin=0.0, nfmax=None):
        self.scale = scale
        self.fragtol = fragtol
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        x_plus_y = attrs_a["volume"] + attrs_b["volume"]
        frag_volume = -self.scale * torch.log(
            (1 - u01 * self.scale / x_plus_y).clamp_min(self.fragtol)
        )
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        n_fragment = x_plus_y / frag_volume
        return n_fragment, frag_volume * const.rho_w


def _fixed_point_sigma(H, mu, dcoal):
    """10 iterations of sigma = sqrt(2/pi) / H / (1 + erf((dcoal - mu) /
    (sqrt(2) sigma))), from sigma = 1/H: the height normalisation of the
    Gaussian modes (reference ``fragmentation_function/lowlist82.py``)"""
    sigma = 1.0 / H
    for _ in range(10):
        sigma = (
            1.0 / H * np.sqrt(2 / np.pi)
            / (1 + erf((dcoal - mu) / (np.sqrt(2.0) * sigma)))
        )
    return sigma


def _ll82_f1(dl, dcoal):
    """filament mode 1 (reference ``fragmentation_function/lowlist82.py``
    params_f1): Gaussian at the large drop's diameter, height-normalised by
    a 10-iteration fixed point for sigma. All diameters in cm."""
    H = 50.8 * dl ** (-0.718)
    return H, dl, _fixed_point_sigma(H, dl, dcoal)


def _ll82_f2(ds):
    H = 4.18 * ds ** (-1.17)
    return H, ds, 1.0 / (np.sqrt(2 * np.pi) * H)


def _ll82_f3(ds, dl):
    """filament mode 3 (lognormal satellite fragments), params_f3 with the
    degenerate (sigma->0 / H->0) exits folded in through where-selection"""
    Ff1 = (
        (-2.25e4 * (dl - 0.403) ** 2 - 37.9) * ds**2.5
        + 9.67 * (dl - 0.170) ** 2
        + 4.95
    ).clamp_min(0.0)
    Ff2 = 1.02e4 * ds**2.83 + 2.0
    ds0 = ((Ff1 / 2.83) ** (1 / 1.02e4)).clamp_min(0.04)
    Ff = torch.where(ds > ds0, Ff1.clamp_min(2.0), Ff2.clamp_min(2.0))
    Dff3 = 0.241 * ds + 0.0129
    Pf301 = 1.68e5 * ds**2.33
    Pf302 = (
        (43.4 * (dl + 1.81) ** 2 - 159.0) / ds
        - 3870 * (dl - 0.285) ** 2
        - 58.1
    ).clamp_min(0.0)
    alpha = (ds - ds0) / (0.2 * ds0)
    Pf303 = alpha * Pf301 + (1 - alpha) * Pf302
    Pf0 = torch.where(
        ds < ds0, Pf301, torch.where(ds > 1.2 * ds0, Pf302, Pf303)
    )
    sigma = 10 * Dff3
    mu = torch.log(Dff3) + sigma**2
    H = Pf0 * Dff3 / torch.exp(-0.5 * sigma**2)
    dead = torch.zeros_like(ds, dtype=torch.bool)
    for _ in range(10):
        dead = dead | (sigma == 0.0) | (H == 0.0)
        safe_sigma = torch.where(dead, 1.0, sigma)
        safe_H = torch.where(dead, 1.0, H)
        sigma = (
            np.sqrt(2 / np.pi) * (Ff - 2.0) / safe_H
            / (1 - erf((np.log(0.01) - mu) / np.sqrt(2.0) / safe_sigma))
        )
        mu = torch.log(Dff3) + sigma**2
        H = Pf0 * Dff3 / torch.exp(-0.5 * sigma**2)
    lg = torch.log(ds0)
    return (
        torch.where(dead, 0.0, H),
        torch.where(dead, lg, mu),
        torch.where(dead, lg, sigma),
    )


def _ll82_s1(dl, ds, dcoal):
    H = 100.0 * torch.exp(-3.25 * ds)
    return H, dl, _fixed_point_sigma(H, dl, dcoal)


def _ll82_s2(dl, ds, St):
    Dss2 = 0.254 * ds**0.413 * torch.exp(3.53 * ds**2.51 * (dl - ds))
    bstar = 14.2 * torch.exp(-17.2 * ds)
    Ps20 = 0.23 * ds ** (-3.93) * dl**bstar
    sigma = 10 * Dss2
    mu = torch.log(Dss2) + sigma**2
    H = Ps20 * Dss2 / torch.exp(-0.5 * sigma**2)
    Fs = 5 * erf((St - 2.52e-6) / 1.85e-6) + 6
    for _ in range(10):
        sigma = (
            np.sqrt(2 / np.pi) * (Fs - 1.0) / H
            / (1 - erf((np.log(0.01) - mu) / np.sqrt(2.0) / sigma))
        )
        mu = torch.log(Dss2) + sigma**2
        H = Ps20 * Dss2 / torch.exp(-0.5 * sigma**2)
    return H, mu, sigma


def _ll82_d1(W1, dl, dcoal, CKE):
    mu = dl * (1 - torch.exp(-3.70 * (3.10 - W1)))
    H = 1.58e-5 * CKE ** (-1.22)
    return H, mu, _fixed_point_sigma(H, mu, dcoal)


def _ll82_d2(ds, dl, CKE):
    Ddd2 = torch.exp(-17.4 * ds - 0.671 * (dl - ds)) * ds
    bstar = 0.007 * ds ** (-2.54)
    Pd20 = 0.0884 * ds ** (-2.52) * (dl - ds).clamp_min(1e-30) ** bstar
    sigma = 10 * Ddd2
    mu = torch.log(Ddd2) + sigma**2
    H = Pd20 * Ddd2 / torch.exp(-0.5 * sigma**2)
    Fd = (297.5 + 23.7 * torch.log(CKE)).clamp_min(1.0)
    dead = Fd == 1.0
    for _ in range(10):
        dead = dead | (sigma == 0.0) | (H <= 0.1) | (sigma >= 1.0)
        safe_sigma = torch.where(dead, 0.5, sigma)
        safe_H = torch.where(dead, 1.0, H)
        sigma = (
            np.sqrt(2 / np.pi) * (Fd - 1.0) / safe_H
            / (1 - erf((np.log(0.01) - mu) / np.sqrt(2.0) / safe_sigma))
        )
        mu = torch.log(Ddd2) + sigma**2
        H = Pd20 * Ddd2 / torch.exp(-0.5 * sigma**2)
    lg = torch.log(Ddd2)
    return (
        torch.where(dead, 0.0, H),
        torch.where(dead, lg, mu),
        torch.where(dead, lg, sigma),
    )


class LowList1982Nf:
    """Low & List 1982 (JAS 39) filament/sheet/disk breakup fragment-size
    distribution (reference ``breakup_fragmentations/lowlist82.py``,
    ``physics/fragmentation_function/lowlist82.py``, and the
    ``_ll82_fragmentation_body`` kernel): breakup-type probabilities
    Rf/Rs/Rd from collision kinetic energy and Weber numbers, then a
    per-type Gaussian/lognormal mixture sampled by inverse CDF, every
    branch evaluated and selected by ``torch.where``"""

    required_attributes = (
        "water mass", "volume", "radius", "relative fall velocity",
    )

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        tol = 1e-8
        erfinv = formulae.trivia.erfinv_approx
        va, vb = attrs_a["volume"], attrs_b["volume"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        ua, ub = (
            attrs_a["relative fall velocity"],
            attrs_b["relative fall velocity"],
        )
        x_plus_y = va + vb
        safe_sum = x_plus_y.clamp_min(1e-300)
        ds_m = 2 * torch.minimum(ra, rb)
        dl_m = 2 * torch.maximum(ra, rb)
        dcoal_m = (safe_sum / (const.PI / 6)) ** (1 / 3)
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * safe_sum ** (2 / 3)
        St = const.PI * const.sgm_w * (ds_m**2 + dl_m**2)
        CKE = const.rho_w / 2 * (va * vb / safe_sum) * (ua - ub) ** 2
        CKE = CKE.clamp_min(1e-300)
        We = CKE / Sc
        W2 = CKE / St

        # breakup-type ratios (reference ``ll82_Nr``)
        Rf = torch.where(CKE >= 0.893e-6, 1.11e-4 * CKE ** (-0.654), 1.0)
        Rs = torch.where(
            We >= 0.86, 0.685 * (1 - torch.exp(-1.63 * (W2 - 0.86))), 0.0
        )
        Rd = torch.where(Rs + Rf > 1.0, 0.0, 1.0 - Rs - Rf)

        # diameters in cm for the parameterisation
        ds = (ds_m / const.CM).clamp_min(1e-10)
        dl = (dl_m / const.CM).clamp_min(1e-10)
        dcoal = dcoal_m / const.CM

        def gauss(mu, sigma, X):
            return mu + np.sqrt(2.0) * sigma * erfinv(2 * X - 1)

        def logn(mu, sigma, X):
            return torch.exp(mu + np.sqrt(2.0) * sigma * erfinv(2 * X - 1))

        def pos(x):
            return x.clamp_min(1e-300)

        # filament branch
        Hf1, mu_f1, sg_f1 = _ll82_f1(dl, dcoal)
        Hf2, mu_f2, sg_f2 = _ll82_f2(ds)
        Hf3, mu_f3, sg_f3 = _ll82_f3(ds, dl)
        w1 = Hf1 * mu_f1
        w2 = Hf2 * mu_f2
        w3 = Hf3 * torch.exp(mu_f3)
        wsum = pos(w1 + w2 + w3)
        rf = u01 / pos(Rf)
        d_f = torch.where(
            rf <= w1 / wsum,
            gauss(mu_f1, sg_f1, (rf * wsum / pos(w1)).clamp_min(tol)),
            torch.where(
                rf <= (w1 + w2) / wsum,
                gauss(mu_f2, sg_f2, (rf * wsum - w1) / pos(w2)),
                logn(
                    mu_f3, sg_f3,
                    ((rf * wsum - w1 - w2) / pos(w3)).clamp_max(1.0 - tol),
                ),
            ),
        )

        # sheet branch
        Hs1, mu_s1, sg_s1 = _ll82_s1(dl, ds, dcoal)
        Hs2, mu_s2, sg_s2 = _ll82_s2(dl, ds, St)
        v1 = Hs1 * mu_s1
        v2 = Hs2 * torch.exp(mu_s2)
        vsum = pos(v1 + v2)
        rs = (u01 - Rf) / pos(Rs)
        d_s = torch.where(
            rs <= v1 / vsum,
            gauss(mu_s1, sg_s1, (rs * vsum / pos(v1)).clamp_min(tol)),
            logn(
                mu_s2, sg_s2,
                ((rs * vsum - v1) / pos(v2)).clamp_max(1.0 - tol),
            ),
        )

        # disk branch
        Hd1, mu_d1, sg_d1 = _ll82_d1(We, dl, dcoal, CKE)
        Hd2, mu_d2, sg_d2 = _ll82_d2(ds, dl, CKE)
        q1 = Hd1 * mu_d1
        qsum = pos(q1 + Hd2)
        rd = (u01 - Rf - Rs) / pos(Rd)
        d_d = torch.where(
            rd <= q1 / qsum,
            gauss(mu_d1, sg_d1, (rd * qsum / pos(q1)).clamp_min(tol)),
            logn(
                mu_d2, sg_d2,
                ((rd * qsum - q1) / pos(Hd2)).clamp_max(1.0 - tol),
            ),
        )

        diameter_cm = torch.where(
            u01 <= Rf, d_f, torch.where(u01 <= Rf + Rs, d_s, d_d)
        )
        frag_volume = (diameter_cm * 0.01) ** 3 * const.PI / 6
        # small-large-drop and degenerate-pair special cases
        frag_volume = torch.where(
            dl_m <= 0.4e-3,
            dcoal_m**3 * const.PI / 6,
            torch.where((ds_m <= 0.0) | (dl_m <= 0.0), 1e-18, frag_volume),
        )
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w


class SLAMS:
    """Stochastic Lagrangian Aggregates Model plankton-poop spectrum
    (Jokulsdottir & Archer 2016; reference ``breakup_fragmentations/slams.py``):
    P(n fragments) ~ 0.91 (n+2)^-1.56, n in 0..21"""

    required_attributes = ("water mass", "volume")

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax
        self._cum_probs = np.cumsum(0.91 * (np.arange(22) + 2.0) ** -1.56)

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        x_plus_y = attrs_a["volume"] + attrs_b["volume"]
        cum = torch.as_tensor(self._cum_probs, dtype=u01.dtype, device=u01.device)
        idx = torch.searchsorted(cum, u01, right=False)  # first n, u < cum
        n_fragment = torch.where(idx < 22, idx + 2, 1).to(u01.dtype)
        frag_volume = apply_limiters(
            x_plus_y / n_fragment, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w


class Straub2010Nf:
    """Straub et al. 2010 four-mode fragment-size distribution (reference
    ``breakup_fragmentations/straub2010.py`` + ``fragmentation_methods.py``
    straub kernels): modes weighted by Nr1..Nr4(CW, gam) with the fourth
    mode's diameter fixed by mass conservation"""

    required_attributes = ("water mass", "volume", "radius", "relative fall velocity")

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        va, vb = attrs_a["volume"], attrs_b["volume"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        ua, ub = (
            attrs_a["relative fall velocity"],
            attrs_b["relative fall velocity"],
        )
        x_plus_y = va + vb
        v_max = torch.maximum(va, vb)
        ds = 2 * torch.minimum(ra, rb)
        gam = torch.maximum(ra, rb) / torch.minimum(ra, rb).clamp_min(1e-30)
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * x_plus_y ** (2 / 3)
        CKE = (
            const.rho_w
            / 2
            * (va * vb / x_plus_y.clamp_min(1e-300))
            * (ua - ub) ** 2
        )
        We = CKE / Sc.clamp_min(1e-300)
        CW = We * CKE / 1e-6  # CKE*We / microjoule (reference straub wrapper)

        # mode weights (reference ``straub_Nr``)
        Nr1 = torch.where(gam * CW >= 7.0, 0.088 * (gam * CW - 7.0), 0.0)
        Nr2 = torch.where(CW >= 21.0, 0.22 * (CW - 21.0), 0.0)
        Nr3 = torch.where(
            CW >= 21.0, torch.where(CW <= 46.0, 0.04 * (46.0 - CW), 0.0), 1.0
        )

        CM = 1e-2  # centimetre
        E_D1 = const.STRAUB_E_D1
        sigma1 = torch.sqrt(
            torch.log((CW / 64 / 100 * CM * CM / 12 / E_D1**2 + 1).clamp_min(1.0))
        )
        mu1 = np.log(E_D1) - sigma1**2 / 2
        sigma2 = (7 * (CW - 21) * CM / 1000).clamp_min(0.0) / np.sqrt(12.0)
        mu2 = const.STRAUB_MU2
        sigma3 = (1 + 0.76 * torch.sqrt(CW)) * CM / 100 / np.sqrt(12.0)
        mu3 = 0.9 * ds

        # mass remainder (reference ``straub_mass_remainder``)
        M1 = Nr1 * torch.exp(3 * mu1 + 9 * sigma1**2 / 2)
        M2 = Nr2 * (mu2**3 + 3 * mu2 * sigma2**2)
        M3 = Nr3 * (mu3**3 + 3 * mu3 * sigma3**2)
        M4 = v_max * 6 / const.PI + ds**3 - M1 - M2 - M3
        d34 = torch.where(
            M4 > 0, torch.exp(torch.log(M4.clamp_min(1e-300)) / 3), 0.0
        )
        M4 = M4.clamp_min(0.0)
        Nrt = M1 + M2 + M3 + M4

        safe_Nrt = Nrt.clamp_min(1e-300)
        lo, hi = 1e-12, 1 - 1e-12
        u = torch.clamp(u01, lo, hi)
        X1 = torch.clamp(u * safe_Nrt / M1.clamp_min(1e-300), lo, hi)
        X2 = torch.clamp((u * safe_Nrt - M1) / M2.clamp_min(1e-300), lo, hi)
        X3 = torch.clamp(
            (u * safe_Nrt - M1 - M2) / M3.clamp_min(1e-300), lo, hi
        )
        erfinv = formulae.trivia.erfinv_approx
        d_1 = torch.exp(mu1 + np.sqrt(2.0) * sigma1 * erfinv(X1))
        d_2 = mu2 + np.sqrt(2.0) * sigma2 * erfinv(X2)
        d_3 = mu3 + np.sqrt(2.0) * sigma3 * erfinv(X3)
        diameter = torch.where(
            u < M1 / safe_Nrt,
            d_1,
            torch.where(
                u < (M1 + M2) / safe_Nrt,
                d_2,
                torch.where(u < (M1 + M2 + M3) / safe_Nrt, d_3, d34),
            ),
        )
        diameter = torch.where(Nrt > 0, diameter, 0.0)
        frag_volume = diameter**3 * const.PI / 6
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w
