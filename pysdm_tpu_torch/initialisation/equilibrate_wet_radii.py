"""Koehler-curve equilibrium wet radii in unsaturated conditions (port of
``pysdm_tpu/initialisation/equilibrate_wet_radii.py``; reference
``PySDM/initialisation/equilibrate_wet_radii.py``).

Host-side, NumPy: a vectorized bisection over all particles at once between
the dry and the critical radius. Its host seconds add to the set-up phase
``setup.equilibrate`` of ``utils/profiling.py`` (``totals``).
"""

import numpy as np

from ..utils.profiling import timed

default_rtol = 1e-5
default_max_iters = 64


@timed("setup.equilibrate")
def equilibrate_wet_radii(
    *,
    r_dry: np.ndarray,
    environment,
    kappa_times_dry_volume: np.ndarray,
    f_org: np.ndarray = None,
    cell_id: np.ndarray = None,
    rtol=default_rtol,
    max_iters=default_max_iters,
):
    r_dry = np.asarray(r_dry, dtype=float)
    if cell_id is None:
        cell_id = np.zeros(r_dry.shape, dtype=int)
    if f_org is None:
        f_org = np.zeros_like(r_dry)

    formulae = environment.particulator.formulae
    const = formulae.constants
    T = np.asarray(environment["T"], dtype=float)[cell_id]
    RH = np.clip(np.asarray(environment["RH"], dtype=float), 0.0, 1.0)[cell_id]

    kappa = np.asarray(kappa_times_dry_volume) / np.asarray(
        formulae.trivia.volume(radius=r_dry)
    )
    rd3 = r_dry**3

    def minfun(r):
        sgm = np.asarray(
            formulae.surface_tension.sigma(
                T, formulae.trivia.volume(radius=r), const.PI_4_3 * rd3, f_org
            )
        )
        return RH - np.asarray(formulae.hygroscopicity.RH_eq(r, T, kappa, rd3, sgm))

    a = r_dry.copy()
    b = np.asarray(formulae.hygroscopicity.r_cr(kappa, rd3, T, const.sgm_w))
    degenerate = ~(a < b)
    b = np.where(degenerate, a, b)

    fa = minfun(a)
    # RH below the deliquescence branch -> stay at dry radius (reference: fa<0)
    frozen = degenerate | (fa < 0)

    lo, hi = a.copy(), b.copy()
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        fmid = minfun(mid)
        go_lo = fa * fmid < 0  # root in [lo, mid]
        hi = np.where(go_lo, mid, hi)
        lo = np.where(go_lo, lo, mid)
        if np.all((hi - lo) <= rtol * lo):
            break

    r_wet = np.where(frozen, r_dry, 0.5 * (lo + hi))
    if not (np.isfinite(r_wet).all() and (r_wet >= r_dry * (1 - 1e-12)).all()):
        raise ValueError("equilibrate_wet_radii: non-finite or sub-dry radius")
    return r_wet
