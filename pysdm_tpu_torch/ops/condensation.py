"""Implicit-in-particle-size condensation solver (port of
``pysdm_tpu/ops/condensation.py``; reference
``PySDM/backends/impl_numba/methods/condensation_methods.py``): trapezoidal
per-cell coupling of (thd, qv, rhod) with per-drop implicit mass solves and
Richardson-style per-cell substep adaptation, for one cell (the parcel) or
many (the kinematic grids). With many cells the drops arrive sorted by cell
and every per-cell sum is a difference of one prefix sum
(``ops/segments.py`` ``sorted_segment_sum``, K4 on CUDA tensors).

The per-drop solve runs where the tensors are:
- on CPU tensors, ``drop_solve`` with the JAX package's own plain
  formulation (``calculate_masses_new``): every drop bisects until all have
  converged (a global ``any``), so the float64 CPU backend follows the JAX
  package's f64 path step for step;
- on CUDA tensors, the Hopper kernel K3 (``ops/cuda/condensation.py``,
  ``csrc/condensation.cu``), and nothing else.
``drop_solve`` with ``per_drop=True`` is K3's plain twin (the same minfun,
bracket and bisection, each drop stopping on its own bracket).

Cell-to-drop broadcasts are gathers, ``row[cell_id]``, not the JAX
package's one-hot matmuls (which exist because TPU gathers are slow, and
which TF32 would make inexact on Hopper).

Host syncs: eager PyTorch decides each loop on the host. One step reads
``max(n_substeps)`` once (the lockstep loop's trip count); the adaptive
step reads one boolean per iteration of each of its two adaptation loops,
at least three reads in all. ``CondensationSolver.host_reads`` counts them.
"""

from collections import namedtuple

import torch

from .cuda import condensation as k3
from .segments import sorted_segment_sum

_FUSE = 32  # iteration cap of each adaptation loop (JAX ``fuse``)
_MULTIPLIER = 2

DropSolveSettings = namedtuple(
    "DropSolveSettings", ("rtol_x", "RH_rtol", "max_iters", "bisect_iters")
)


def _row(value, like):
    """a formula value (a constant of the Neglect variants, or a tensor) as
    a row shaped and typed like ``like``"""
    return torch.broadcast_to(
        torch.as_tensor(value, dtype=like.dtype, device=like.device), like.shape
    )


def thermo(formulae, thd, qv, rhod, air_density, air_viscosity):
    """T, p, RH, lv, pvs, D, K and the Schmidt number from the state
    triplet (JAX ``compute_cell_thermo``), at cell or drop granularity"""
    f = formulae
    T = f.state_variable_triplet.T(rhod, thd)
    p = f.state_variable_triplet.p(rhod, T, qv)
    pv = f.state_variable_triplet.pv(p, qv)
    lv = f.latent_heat_vapourisation.lv(T)
    pvs = f.saturation_vapour_pressure.pvs_water(T)
    DTp = _row(f.diffusion_thermics.D(T, p), T)
    KTp = _row(f.diffusion_thermics.K(T, p), T)
    RH = pv / pvs
    Sc = f.trivia.air_schmidt_number(
        dynamic_viscosity=air_viscosity, diffusivity=DTp, density=air_density
    )
    return T, p, RH, lv, pvs, DTp, KTp, Sc


def per_drop_minfun(formulae, *, x_old, dt_sub, kappa, rd3, T, RH, Fk, Fd):
    """K3's residual of the implicit step, ``x_old - x + dt dx/dt(x)``, as
    the kernel evaluates it: what does not depend on ``x`` is folded into
    per-drop constants once, the radius enters as its inverse, one
    ``(m / (rho_w 4 pi / 3)) ** (-1/3)``, and no division is left in the
    log coordinate with the leading-terms Koehler curve (there dx/dt =
    3 r dr/dt / r^2, the mass cancels). The supersaturation difference is
    formed as (RH - 1) - A / r + B / r^3, without rounding RH_eq to an ulp
    of 1 first. Only the variants K3 evaluates."""
    f = formulae
    const = f.constants
    k3.check_variants(f, families=(
        "diffusion_coordinate", "hygroscopicity", "drop_growth",
        "surface_tension", "particle_shape_and_density",
    ))
    log_coordinate = f.diffusion_coordinate.variant == "WaterMassLogarithm"
    leading_terms = f.hygroscopicity.variant == "KappaKoehlerLeadingTerms"
    x_max = f.diffusion_coordinate.x_max()
    inv_F = 1 / (Fd if f.drop_growth.variant == "Fick" else Fk + Fd)
    # r^3 = mass * per_mass
    per_mass = 1 / (const.rho_w * const.PI_4_3)
    A = 2 * const.sgm_w / const.Rv / T / const.rho_w
    if log_coordinate:
        rate = dt_sub * 3 * inv_F
    else:
        rate = dt_sub * (4 * const.PI * const.rho_w) * inv_F
    if leading_terms:
        RH_minus_1 = RH - 1
        B = kappa * rd3
    else:
        rd3_solute = rd3 * (1 - kappa)

    def minfun(x_new):
        r3 = (torch.exp(x_new) if log_coordinate else x_new) * per_mass
        inv_r = r3 ** (-1 / 3)
        inv_r2 = inv_r * inv_r
        if leading_terms:
            excess = RH_minus_1 - A * inv_r + B * (inv_r2 * inv_r)
        else:
            excess = RH - torch.exp(A * inv_r) * (r3 - rd3) / (r3 - rd3_solute)
        growth = rate * excess * inv_r2 if log_coordinate else rate * excess / inv_r
        return torch.where(x_new > x_max, x_old - x_new, x_old - x_new + growth)

    return minfun


def _interpolation_fraction(xa, fxa, xb, fxb, xc, fxc, tol, x_max):
    """where in the bracket [xa, xb] Chandrupatla's method evaluates next,
    as a fraction of the way from xa (the newest point) to xb; xc is the
    point the newest one replaced. Inverse quadratic interpolation through
    the three points where his criterion says it is safe, else the middle:
    the criterion fails on a degenerate triple (the first round, xc = xa; a
    round that did not move; equal values on the float32 plateau near the
    root), so those rounds bisect. A bracket that reaches past ``x_max``,
    where minfun continues on another branch, bisects too. The fraction
    keeps 3/4 of the tolerance away from both ends: when the interpolation
    points next to an end, the evaluation lands just across the root and
    the bracket closes to within the tolerance at once."""
    width = (xb - xa).abs()
    xi = (xa - xb) / (xc - xb)
    phi = (fxa - fxb) / (fxc - fxb)
    t = (
        fxa / (fxb - fxa) * (fxc / (fxb - fxc))
        + (xc - xa) / (xb - xa) * (fxa / (fxc - fxa)) * (fxb / (fxc - fxb))
    )
    safe = (
        (phi * phi < xi) & ((1 - phi) * (1 - phi) < 1 - xi)
        & (torch.maximum(xa, xb) <= x_max) & torch.isfinite(t)
    )
    t = torch.where(safe, t, 0.5)
    margin = torch.clamp(0.75 * tol / width, max=0.5)
    return torch.minimum(torch.maximum(t, margin), 1 - margin)


def drop_solve(
    formulae, settings, *, water_mass, vdry, kappa, f_org, reynolds,
    active_drop, dt_sub, T, p, RH, lv, pvs, DTp, KTp, Sc, per_drop,
    stats=None,
):
    """per-drop implicit solve over per-drop thermo rows (JAX
    ``calculate_masses_new``); returns (mass_new, success_per_drop).

    ``per_drop=False``: the JAX package's XLA formulation, bisecting every
    drop until none is outside ``rtol_x`` (at most ``bisect_iters``).
    ``per_drop=True``: K3's plain twin. Its minfun is ``per_drop_minfun``;
    each drop stops once its own bracket satisfies hi - lo <= rtol_x |x_old|
    + 1e-30, after at most min(bisect_iters, 40) rounds
    (``pysdm_tpu/ops/pallas/condensation.py`` ``:218-237`` stops per
    32768-drop block instead), or at a point where minfun is exactly 0; a
    round evaluates where Chandrupatla's method says
    (``_interpolation_fraction``: inverse quadratic interpolation with a
    bisection safeguard), not always the middle, and the result is the
    middle of the last bracket. A bracket that reaches past x_max is cut
    there first, or the drop fails as one with a non-finite root. All
    three rules land within rtol_x |x_old| of the same root, except where
    the JAX rules meet an exact zero: they take it for "root above" and
    end at the bracket's upper end.

    ``stats``: a dict that, when given, receives ``minfun_evaluations``,
    the per-drop evaluations of minfun that the per-drop rule needs (what
    K3 computes for these inputs; its operation count)."""
    f = formulae
    const = f.constants
    rtol_x, RH_rtol, max_iters, bisect_iters = settings
    x_max = f.diffusion_coordinate.x_max()

    def formula_minfun(x_new, x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd):
        mass_new = f.diffusion_coordinate.mass(x_new)
        volume_new = f.particle_shape_and_density.mass_to_volume(mass_new)
        r_new = f.trivia.radius(volume_new)
        sgm = f.surface_tension.sigma(T, volume_new, const.PI_4_3 * rd3, f_org)
        RH_eq = f.hygroscopicity.RH_eq(r_new, T, kappa, rd3, sgm)
        r_dr_dt = f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd)
        dm_dt = f.particle_shape_and_density.dm_dt(r=r_new, r_dr_dt=r_dr_dt)
        res = x_old - x_new + dt_sub * f.diffusion_coordinate.dx_dt(mass_new, dm_dt)
        return torch.where(x_new > x_max, x_old - x_new, res)

    ftype = water_mass.dtype
    active = (water_mass > 0) & active_drop
    safe_mass = torch.where(active, water_mass, 1e-18)
    v_drop = f.particle_shape_and_density.mass_to_volume(safe_mass)
    x_old = f.diffusion_coordinate.x(safe_mass)
    r_old = f.trivia.radius(v_drop)
    x_insane = f.diffusion_coordinate.x(
        f.particle_shape_and_density.volume_to_mass(vdry / 100)
    )
    rd3 = vdry / const.PI_4_3
    sgm = f.surface_tension.sigma(T, v_drop, vdry, f_org)
    RH_eq = f.hygroscopicity.RH_eq(r_old, T, kappa, rd3, sgm)

    lambdaK = f.diffusion_kinetics.lambdaK(T, p)
    lambdaD = f.diffusion_kinetics.lambdaD(DTp, T)
    Dr = f.diffusion_kinetics.D(DTp, r_old, lambdaD)
    Kr = f.diffusion_kinetics.K(KTp, r_old, lambdaK)
    vent = f.ventilation.ventilation_coefficient(
        sqrt_re_times_cbrt_sc=f.trivia.sqrt_re_times_cbrt_sc(Re=reynolds, Sc=Sc)
    )
    Fk = f.drop_growth.Fk(T=T, K=Kr * vent, lv=lv)
    Fd = f.drop_growth.Fd(T=T, D=Dr * vent, pvs=pvs)

    at_equilibrium = f.trivia.within_tolerance((RH - RH_eq).abs(), RH, RH_rtol)
    r_dr_dt_old = f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd)
    dm_dt_old = f.particle_shape_and_density.dm_dt(r=r_old, r_dr_dt=r_dr_dt_old)
    dx_old = dt_sub * f.diffusion_coordinate.dx_dt(safe_mass, dm_dt_old)
    dx_old = torch.where(at_equilibrium, 0.0, dx_old)
    need_solve = active & (dx_old != 0)

    if per_drop:
        minfun = per_drop_minfun(
            f, x_old=x_old, dt_sub=dt_sub, kappa=kappa, rd3=rd3, T=T, RH=RH,
            Fk=Fk, Fd=Fd,
        )
    else:
        margs = (x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd)

        def minfun(x_new):
            return formula_minfun(x_new, *margs)

    a = x_old
    fa = minfun(a)

    # f32-robust bracket (JAX ops/condensation.py:167-192): probe in the
    # direction of minfun's own sign, with the step floored at 8 ulps of
    # x_old; fa == 0 means x_old is the root. Without these, haze settled
    # at its f32 Koehler equilibrium reports "unbracketable" every step.
    dx_mag = torch.maximum(
        dx_old.abs(), 8 * torch.finfo(ftype).eps * x_old.abs()
    )
    dx_step = torch.where(fa > 0, dx_mag, -dx_mag)
    converged_at_a = need_solve & (fa == 0)

    b = torch.maximum(x_insane, a + dx_step)
    fb = minfun(b)
    evaluations = [2 * need_solve.sum()] if stats is not None else []
    # double the step until the sign changes; a bracketed drop stays
    # bracketed, so the loop ends once none is left
    for i in range(max_iters):
        not_bracketed = (fa * fb >= 0) & need_solve
        if not bool(not_bracketed.any()):
            break
        if stats is not None:
            evaluations.append(not_bracketed.sum())
        b_try = torch.maximum(x_insane, a + dx_step * 2.0 ** (i + 1))
        fb_try = minfun(b_try)
        b = torch.where(not_bracketed, b_try, b)
        fb = torch.where(not_bracketed, fb_try, fb)
    bracketed = (fa * fb < 0) | converged_at_a
    success_drop = ~need_solve | bracketed

    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    flo = torch.where(a <= b, fa, fb)
    solving = need_solve & bracketed & ~converged_at_a

    if per_drop:
        tol = rtol_x * x_old.abs() + 1e-30
        # xa is the newest point (first the bracket's far end), xb the other
        # end, xc the point xa replaced
        xa, fxa, xb, fxb = b, fb, a, fa
        # a bracket that reaches past x_max (minfun continues there on
        # another branch, below zero) is cut at x_max: minfun above zero
        # there means the root lies beyond the largest drop the coordinate
        # holds, and the drop fails as one with a non-finite root does
        # (halving such a bracket stays astride x_max for all its rounds
        # and ends on its last middle, whose mass overflows or, where the
        # far end is nearer, passes for a result)
        astride = solving & (xa > x_max) & (xb < x_max)
        beyond = torch.zeros_like(astride)
        if bool(astride.any()):
            if stats is not None:
                evaluations.append(astride.sum())
            x_top = torch.full_like(x_old, x_max)
            f_top = minfun(x_top)
            beyond = astride & (f_top > 0)
            xa = torch.where(astride, x_top, xa)
            fxa = torch.where(astride, f_top, fxa)
            xb = torch.where(astride & (f_top == 0), x_top, xb)
            solving = solving & ~beyond
        xc, fxc = xa, fxa
        for _ in range(min(bisect_iters, 40)):
            update = solving & ((xb - xa).abs() - tol > 0)
            if not bool(update.any()):
                break
            if stats is not None:
                evaluations.append(update.sum())
            t = _interpolation_fraction(xa, fxa, xb, fxb, xc, fxc, tol, x_max)
            xt = xa + t * (xb - xa)
            ft = minfun(xt)
            # xt replaces the end whose minfun has its sign; if that is xb,
            # the old xa becomes the other end
            same = (ft > 0) == (fxa > 0)
            # an exact zero is the root: the global rule below takes it for
            # "root above" and walks lo up to hi (ROADMAP queue 3)
            at_root = ft == 0
            xc = torch.where(update, torch.where(same, xa, xb), xc)
            fxc = torch.where(update, torch.where(same, fxa, fxb), fxc)
            xb = torch.where(update & (~same | at_root),
                             torch.where(at_root, xt, xa), xb)
            fxb = torch.where(update & ~same, fxa, fxb)
            xa = torch.where(update, xt, xa)
            fxa = torch.where(update, ft, fxa)
        lo = torch.where(beyond, torch.inf, xa)
        hi, solving = xb, solving | beyond
    else:
        scale = torch.where(x_old != 0, x_old, 1.0).abs()
        for _ in range(bisect_iters):
            unconverged = solving & ~f.trivia.within_tolerance(
                hi - lo, scale, rtol_x
            )
            if not bool(unconverged.any()):
                break
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid)
            go_lo = flo * fmid < 0
            hi = torch.where(go_lo, mid, hi)
            lo = torch.where(go_lo, lo, mid)
            flo = torch.where(go_lo, flo, fmid)

    x_new = torch.where(solving, 0.5 * (lo + hi), x_old)
    mass_new = f.diffusion_coordinate.mass(x_new)
    mass_new = torch.where(active, mass_new, water_mass)
    # a non-finite root keeps the old mass and counts as a failure (the
    # reference raises instead, condensation_methods.py:670-696)
    finite = torch.isfinite(mass_new)
    mass_new = torch.where(finite, mass_new, water_mass)
    if stats is not None:
        stats["minfun_evaluations"] = int(sum(int(e) for e in evaluations))
    return mass_new, (success_drop & finite) | ~active


class CondensationSolver:
    """the condensation step closed over formulae and configuration (JAX
    ``make_condensation_solver``), for one cell or many.
    ``substep_solves`` counts the per-drop solves (one per substep, fake or
    real; on CUDA tensors one K3 launch each), ``host_reads`` the values
    read back from the device to steer a loop."""

    def __init__(
        self,
        formulae,
        *,
        n_cell,
        dt,
        rtol_x=1e-6,
        rtol_thd=1e-6,
        dt_range=(1e-4, 1.0),
        adaptive=True,
        RH_rtol=1e-7,
        max_iters=16,
        bisect_iters=64,
        failure_doubling_cap=64,
    ):
        self.n_cell = n_cell
        self.formulae = formulae
        self.dt = dt
        self.rtol_thd = rtol_thd
        self.adaptive = adaptive
        self.failure_doubling_cap = failure_doubling_cap
        self.settings = DropSolveSettings(rtol_x, RH_rtol, max_iters, bisect_iters)
        if dt_range[1] > dt:
            dt_range = (dt_range[0], dt)
        self.n_substeps_max = int(dt // dt_range[0])
        self.n_substeps_min = max(1, int(-(-dt // dt_range[1])))  # ceil
        self.substep_solves = 0
        self.host_reads = 0
        self._zeros = {}

    def _percell_sum(self, values, cell_start):
        """per-cell sums over cell-sorted drops, of one row ``(n,)`` or of
        rows ``(R, n)`` at once (one prefix sum, K4 on CUDA tensors, for
        all of them; each row's sums equal its own call's bit for bit);
        one cell is one plain sum per row (JAX ``_percell_sum``)"""
        if self.n_cell == 1:
            if values.dim() == 1:
                return values.sum()[None]
            return torch.stack([row.sum() for row in values])[:, None]
        return sorted_segment_sum(values, cell_start, self.n_cell)

    def _zero(self, like):
        """a 0-d zero of ``like``'s dtype on its device (``torch.where``
        writes into ``out=`` only between tensors)"""
        key = (like.dtype, like.device)
        if key not in self._zeros:
            self._zeros[key] = like.new_zeros(())
        return self._zeros[key]

    def _read(self, tensor):
        """a device value the host branches on (counted)"""
        self.host_reads += 1
        return tensor.item()

    def substep(
        self, *, attrs, multiplicity, cell_of_drop, cell_start, cell_active,
        dt_sub_cell, thd, qv, rhod, ml_old, dthd_dt_pred, dqv_dt_pred,
        drhod_dt, m_d, air_density, air_viscosity, fake,
    ):
        """one trapezoidal substep (reference ``step_impl`` 256-356) on the
        cells where ``cell_active``; with many cells the drops are sorted by
        cell, with segment starts ``cell_start``"""
        f = self.formulae
        act = cell_active
        dt_sub = dt_sub_cell
        thd0, qv0, rhod0 = thd, qv, rhod  # rollback state on failure
        thd = torch.where(act, thd + dt_sub * dthd_dt_pred / 2, thd)
        qv = torch.where(act, qv + dt_sub * dqv_dt_pred / 2, qv)
        rhod = torch.where(act, rhod + dt_sub * drhod_dt / 2, rhod)

        T, p, RH, lv, pvs, DTp, KTp, Sc = thermo(
            f, thd, qv, rhod, air_density, air_viscosity
        )
        # dead drops (multiplicity 0) are inert
        act_d = act[cell_of_drop] & (multiplicity > 0)
        water_mass = attrs["water_mass"]
        self.substep_solves += 1
        if water_mass.device.type == "cpu":
            T_d, p_d, RH_d, lv_d, pvs_d, DTp_d, KTp_d, Sc_d = thermo(
                f, thd[cell_of_drop], qv[cell_of_drop], rhod[cell_of_drop],
                air_density[cell_of_drop], air_viscosity[cell_of_drop],
            )
            mass_new, success_drop = drop_solve(
                f, self.settings, water_mass=water_mass, vdry=attrs["vdry"],
                kappa=attrs["kappa"], f_org=attrs["f_org"],
                reynolds=attrs["reynolds_number"], active_drop=act_d,
                dt_sub=dt_sub[cell_of_drop], T=T_d, p=p_d, RH=RH_d, lv=lv_d,
                pvs=pvs_d, DTp=DTp_d, KTp=KTp_d, Sc=Sc_d, per_drop=False,
            )
        else:
            mass_new, success_drop = k3.masses_new(
                f, self.settings, water_mass, attrs["vdry"], attrs["kappa"],
                multiplicity, cell_of_drop, thd, qv, rhod, dt_sub, act,
                air_density, air_viscosity,
            )
        mult_f = multiplicity.to(water_mass.dtype)
        # the liquid and the failed solves depend on the solve alone: both
        # rows go through one prefix sum (the 0/1 failures sum exactly in
        # any float type)
        zero = self._zero(water_mass)
        rows = water_mass.new_empty((2,) + water_mass.shape)
        torch.where(mass_new > 0, mult_f * mass_new, zero, out=rows[0])
        rows[1] = ~success_drop
        ml_new, fails = self._percell_sum(rows, cell_start)
        dml_dt = (ml_new - ml_old) / torch.where(dt_sub > 0, dt_sub, 1.0)
        dqv_dt_corr = -dml_dt / m_d
        dthd_dt_corr = f.state_variable_triplet.dthd_dt(
            rhod=rhod, thd=thd, T=T,
            d_water_vapour_mixing_ratio__dt=dqv_dt_corr, lv=lv,
        )
        thd = torch.where(act, thd + dt_sub * (dthd_dt_pred / 2 + dthd_dt_corr), thd)
        qv = torch.where(act, qv + dt_sub * (dqv_dt_pred / 2 + dqv_dt_corr), qv)
        rhod = torch.where(act, rhod + dt_sub * drhod_dt / 2, rhod)

        # a non-finite thd/qv (the trapezoidal correction on a numerical
        # cliff) rolls the cell back to its substep-entry state, in full:
        # its drops keep their substep-entry masses too
        finite_cell = torch.isfinite(thd) & torch.isfinite(qv) & torch.isfinite(rhod)
        thd = torch.where(finite_cell, thd, thd0)
        qv = torch.where(finite_cell, qv, qv0)
        rhod = torch.where(finite_cell, rhod, rhod0)
        success_cell = ((fails == 0) & finite_cell) | ~act

        zeros_cell = torch.zeros_like(thd)
        if fake:
            attrs_out = attrs
            events = (zeros_cell, zeros_cell, zeros_cell)
        else:
            committed = act_d & finite_cell[cell_of_drop]
            attrs_out = {
                **attrs,
                "water_mass": torch.where(committed, mass_new, water_mass),
            }
            # activation events (reference ``calculate_ml_new``,
            # condensation_methods.py:149-161): multiplicity-weighted counts
            # of drops crossing the critical mass in this substep
            mass_cr = f.particle_shape_and_density.volume_to_mass(attrs["v_cr"])
            weight = torch.where(committed, mult_f, 0.0)
            # the three counts wait for ``finite_cell``, so they form a
            # second group of rows under one prefix sum
            crossings = (
                (mass_new > mass_cr) & (mass_cr > water_mass),
                (mass_new < mass_cr) & (mass_cr < water_mass),
                (mass_new > mass_cr) & (mass_new > water_mass),
            )
            rows = water_mass.new_empty((3,) + water_mass.shape)
            for row, crossed in zip(rows, crossings):
                torch.where(crossed, weight, zero, out=row)
            n_act, n_deact, n_act_growing = self._percell_sum(rows, cell_start)
            n_ripen = torch.where(n_deact > 0, n_act_growing, zeros_cell)
            events = (n_act, n_deact, n_ripen)
        ml_out = torch.where(act & finite_cell, ml_new, ml_old)
        return attrs_out, thd, qv, rhod, ml_out, RH, success_cell, events

    def _liquid(self, attrs, multiplicity, cell_start):
        water_mass = attrs["water_mass"]
        mult_f = multiplicity.to(water_mass.dtype)
        return self._percell_sum(
            torch.where(water_mass > 0, mult_f * water_mass, 0.0), cell_start
        )

    def run_substeps(
        self, *, attrs, multiplicity, n_substeps, thd, ml_old, **kwargs
    ):
        """advance every cell through its own n_substeps (JAX lockstep loop,
        spent cells masked; the trip count is read on the host); ``ml_old``
        is the liquid per cell at the step's entry"""
        dt_sub_cell = self.dt / n_substeps.to(thd.dtype)
        water_mass = attrs["water_mass"]
        qv, rhod = kwargs.pop("qv"), kwargs.pop("rhod")
        RH_max = torch.zeros_like(thd)
        success = torch.ones_like(thd, dtype=torch.bool)
        events = (RH_max, RH_max, RH_max)
        for s in range(int(self._read(n_substeps.max()))):
            cell_active = s < n_substeps
            (attrs_s, thd, qv, rhod, ml_old, RH, success_cell, ev) = self.substep(
                attrs={**attrs, "water_mass": water_mass},
                multiplicity=multiplicity, cell_active=cell_active,
                dt_sub_cell=dt_sub_cell, thd=thd, qv=qv, rhod=rhod,
                ml_old=ml_old, fake=False, **kwargs,
            )
            water_mass = attrs_s["water_mass"]
            RH_max = torch.where(cell_active, torch.maximum(RH_max, RH), RH_max)
            success = success & success_cell
            events = tuple(
                torch.where(cell_active, acc + e, acc)
                for acc, e in zip(events, ev)
            )
        return water_mass, thd, qv, rhod, RH_max, success, events

    def step_fake(self, *, attrs, multiplicity, n_substeps, thd, cell_mask, **kwargs):
        """one substep of length dt/n_substeps without committing attributes
        (reference ``make_step_fake``); returns (thd_new, success).
        ``kwargs["ml_old"]``: the liquid per cell of the uncommitted state,
        the same for every fake substep of a step"""
        _, thd_new, _, _, _, _, success, _ = self.substep(
            attrs=attrs, multiplicity=multiplicity, cell_active=cell_mask,
            dt_sub_cell=self.dt / n_substeps.to(thd.dtype), thd=thd,
            fake=True, **kwargs,
        )
        return thd_new, success

    def adapt_substeps(self, *, n_substeps_prev, thd, fake_kwargs):
        """per-cell Richardson adaptation (reference ``adapt_substeps``
        178-228): double n until the one-substep thd error estimate
        |dthd(dt/n) - 2 dthd(dt/2n)| is within rtol_thd.

        n is carried as a float: an int32 n doubled by a persistently
        failing cell wraps to 0 after 32 doublings and dt/0 is inf. A cell
        whose fake substep still fails at ``failure_doubling_cap`` keeps
        that n and lets the real substeps report the failure; on a GPU an
        uncapped doubling would run a lockstep loop of up to dt/1e-4
        substeps."""
        ftype = thd.dtype
        mult = _MULTIPLIER
        n_max_f = float(self.n_substeps_max)
        n_fail_cap = float(max(
            self.n_substeps_min,
            min(self.n_substeps_max, self.failure_doubling_cap),
        ))
        n = torch.clamp(
            (n_substeps_prev // mult).to(ftype), min=float(self.n_substeps_min)
        )

        # phase 1: double until the fake substep succeeds (or the cell hits
        # the failure cap); the attempt that succeeds is the cell's dt/n
        # trial, carried out as thd_long
        thd_long, ok = self.step_fake(
            n_substeps=n, thd=thd, cell_mask=torch.ones_like(thd, dtype=torch.bool),
            **fake_kwargs,
        )
        n = torch.where(ok, n, torch.clamp(n * mult, max=n_fail_cap))
        for _ in range(_FUSE):
            if not self._read((~ok).any()):
                break
            thd_new, success = self.step_fake(
                n_substeps=n, thd=thd, cell_mask=~ok, **fake_kwargs
            )
            thd_long = torch.where(~ok & success, thd_new, thd_long)
            newly_ok = ok | success | (n >= n_fail_cap)
            n = torch.where(newly_ok, n, torch.clamp(n * mult, max=n_fail_cap))
            ok = newly_ok
        n = torch.clamp(n, max=n_max_f)

        # the Richardson estimate cannot meaningfully drop below a few ulps
        # of thd; a tolerance below that floor would double n to the maximum
        rtol_eff = max(self.rtol_thd, 16 * float(torch.finfo(ftype).eps))

        # phase 2: Richardson comparison against mult * n
        done = torch.zeros_like(ok)
        for _ in range(_FUSE):
            if not self._read((~done).any()):
                break
            thd_short, _ = self.step_fake(
                n_substeps=n * mult, thd=thd, cell_mask=~done, **fake_kwargs
            )
            error_estimate = ((thd_long - thd) - mult * (thd_short - thd)).abs()
            within = self.formulae.trivia.within_tolerance(
                error_estimate, thd, rtol_eff
            )
            newly_done = done | within | (n * mult > n_max_f)
            n = torch.where(done | within, n, n * mult)
            thd_long = torch.where(done, thd_long, thd_short)
            done = newly_done
        return torch.clamp(n, max=n_max_f).to(torch.int32)

    def __call__(
        self, *, attrs, multiplicity, cell_of_drop, cell_start, n_substeps,
        thd, qv, rhod, pthd, pqv, prhod, m_d, air_density, air_viscosity,
    ):
        """full condensation step (reference ``solve``, 639-698); returns
        (water_mass, pthd, pqv, n_substeps, RH_max, success, events).
        ``cell_start``: the segment starts of the cell-sorted drops (None
        for one cell)"""
        dt = self.dt
        kwargs = dict(
            multiplicity=multiplicity, cell_of_drop=cell_of_drop,
            cell_start=cell_start,
            qv=qv, rhod=rhod,
            dthd_dt_pred=(pthd - thd) / dt, dqv_dt_pred=(pqv - qv) / dt,
            drhod_dt=(prhod - rhod) / dt, m_d=m_d,
            air_density=air_density, air_viscosity=air_viscosity,
        )
        # the liquid at the step's entry: every fake substep and the first
        # real one start from it
        kwargs["ml_old"] = self._liquid(attrs, multiplicity, cell_start)
        if self.adaptive:
            n_substeps = self.adapt_substeps(
                n_substeps_prev=n_substeps, thd=thd,
                fake_kwargs={"attrs": attrs, **kwargs},
            )
        water_mass, thd_new, qv_new, _, RH_max, success, events = (
            self.run_substeps(attrs=attrs, n_substeps=n_substeps, thd=thd, **kwargs)
        )
        return water_mass, thd_new, qv_new, n_substeps, RH_max, success, events
