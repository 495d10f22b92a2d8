"""Surface-tension variants with organic surface partitioning (port of
``pysdm_tpu/physics/surface_tension.py``; reference
``PySDM/physics/surface_tension/``): ``CompressedFilmOvadnevaite``
(Ovadnevaite et al. 2017, Lowe et al. 2019), ``CompressedFilmRuehl`` and
``SzyszkowskiLangmuir`` (Ruehl et al. 2016). ``Constant`` lives in
``misc_families.py``, as in the reference.

Ruehl's implicit isotherm is solved by the JAX package's fixed 64-step
bisection of the surface fraction on [1e-16, 1], branch-free, in float64
whatever the inputs' type (the JAX package bisects in
``jnp.result_type(float)``, float64 under its x64 mode).

Two departures that leave float64 results as they are and keep float32
inputs (K3's twin, ``ops/condensation.py``) finite and accurate: Ruehl's
c = m_sigma N_A / (2 R T) is formed in float64 (m_sigma N_A alone, 1.8e40
for Singer and Ward's 0.3e17 J/m^2, is above the float32 maximum, and the
JAX formula on float32 inputs takes c = inf); Ovadnevaite's film volume
v_wet - 4/3 pi (r - delta)^3 is formed in float32 as
4/3 pi delta (3 r (r - delta) + delta^2), since the difference loses about
r / (3 delta) ulps (1e4 at r = 4 um, delta = 0.1 nm: 1e-3 of the film
volume), and is 0 above ~2 mm, where a drop without organic then gets
0 / 0 (in float64 the reference's difference stays).
"""

import numpy as np
import torch

from . import _xp


class CompressedFilmOvadnevaite:
    """monolayer compressed film: sigma is the coverage-weighted mean of the
    water and organic surface tensions"""

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        r_wet = ((3 * v_wet) / (4 * const.PI)) ** (1 / 3)
        d = const.delta_min
        if _single(r_wet):
            # v_wet - 4/3 pi (r - d)^3 without the difference
            v_delta = const.PI_4_3 * d * (3 * r_wet * (r_wet - d) + d * d)
        else:
            v_delta = v_wet - const.PI_4_3 * (r_wet - d) ** 3
        v_beta = f_org * v_dry
        c_beta = _xp.minimum(v_beta / v_delta, 1.0)
        return (1 - c_beta) * const.sgm_w + c_beta * const.sgm_org


def _ruehl_iso(const, T, v_wet, v_dry, f_org):
    """the Ruehl-2016 isotherm quantities (Cb_iso, A_iso); f_org == 0 (pure
    water) takes a safe denominator here and a ``where`` at the call sites"""
    f_org_safe = _xp.where(f_org == 0, 1.0, f_org)
    r_wet = ((3 * v_wet) / (4 * const.PI)) ** (1 / 3)
    Cb_iso = (f_org_safe * v_dry / const.RUEHL_nu_org) / (
        v_wet / const.water_molar_volume
    )
    A_iso = (4 * const.PI * r_wet**2) / (
        f_org_safe * v_dry * const.N_A / const.RUEHL_nu_org
    )
    return Cb_iso, A_iso


def _float64_like(x, others, value):
    """``value`` in float64, shaped like ``x``: a tensor (on the device of
    the first tensor argument) if any argument is one, else an array"""
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, value, dtype=torch.float64)
    for other in others:
        if isinstance(other, torch.Tensor):
            return torch.full(
                np.shape(x), value, dtype=torch.float64, device=other.device
            )
    return np.full(np.shape(x), value, dtype=np.float64)


def _single(x):
    """whether ``x`` is a float32 tensor or array"""
    return getattr(x, "dtype", None) in (torch.float32, np.float32)


def _float64(x):
    """``x`` in float64: a tensor stays a tensor on its device"""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.asarray(x, dtype=np.float64)


def _clip(x, lo, hi):
    return _xp.minimum(_xp.maximum(x, lo), hi)


class CompressedFilmRuehl:
    """compressed-film equation of state with bulk/surface partitioning
    solved from the isotherm (Ruehl et al. 2016 supplementary eqs. 13, 15)"""

    N_BISECT = 64

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        Cb_iso, A_iso = _ruehl_iso(const, T, v_wet, v_dry, f_org)
        c = (const.RUEHL_m_sigma * const.N_A) / (2 * const.R_str * _float64(T))

        def minfun(f_surf):
            lhs = Cb_iso * (1 - f_surf) / const.RUEHL_C0
            rhs = _xp.exp(c * (const.RUEHL_A0**2 - (A_iso / f_surf) ** 2))
            return lhs - rhs

        lo = _float64_like(v_wet, (T, v_dry, f_org), 1e-16)
        hi = _float64_like(v_wet, (T, v_dry, f_org), 1.0)
        flo = minfun(lo)
        for _ in range(CompressedFilmRuehl.N_BISECT):
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid)
            go_lo = flo * fmid < 0
            hi = _xp.where(go_lo, mid, hi)
            lo = _xp.where(go_lo, lo, mid)
            flo = _xp.where(go_lo, flo, fmid)
        f_surf = 0.5 * (lo + hi)

        sgm = const.sgm_w - (const.RUEHL_A0 - A_iso / f_surf) * const.RUEHL_m_sigma
        sgm = _clip(sgm, const.RUEHL_sgm_min, const.sgm_w)
        return _xp.where(
            f_org == 0,
            const.sgm_w,
            _xp.where(f_org == 1, const.RUEHL_sgm_min, sgm),
        )


class SzyszkowskiLangmuir:
    """Szyszkowski-Langmuir equation of state; the partitioning quadratic is
    solved in closed form"""

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        Cb_iso, A_iso = _ruehl_iso(const, T, v_wet, v_dry, f_org)
        a = -const.RUEHL_A0 / A_iso
        b = (
            const.RUEHL_A0 / A_iso
            + (const.RUEHL_A0 / A_iso) * (const.RUEHL_C0 / Cb_iso)
            + 1.0
        )
        f_surf = (-b + _xp.sqrt(b**2 + 4 * a)) / (2 * a)  # c == -1
        sgm = const.sgm_w - (
            (const.R_str * T) / (const.RUEHL_A0 * const.N_A)
        ) * _xp.log1p(Cb_iso * (1 - f_surf) / const.RUEHL_C0)
        sgm = _clip(sgm, const.RUEHL_sgm_min, const.sgm_w)
        return _xp.where(f_org == 0, const.sgm_w, sgm)


VARIANTS = {
    "CompressedFilmOvadnevaite": CompressedFilmOvadnevaite,
    "CompressedFilmRuehl": CompressedFilmRuehl,
    "SzyszkowskiLangmuir": SzyszkowskiLangmuir,
}
