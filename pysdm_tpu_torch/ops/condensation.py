"""Implicit-in-particle-size condensation solver (port of
``pysdm_tpu/ops/condensation.py``; reference
``PySDM/backends/impl_numba/methods/condensation_methods.py``): trapezoidal
per-cell coupling of (thd, qv, rhod) with per-drop implicit mass solves and
Richardson-style per-cell substep adaptation, single cell only (the parcel;
the multi-cell path comes with slice 3).

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


def drop_solve(
    formulae, settings, *, water_mass, vdry, kappa, f_org, reynolds,
    active_drop, dt_sub, T, p, RH, lv, pvs, DTp, KTp, Sc, per_drop,
):
    """per-drop implicit solve over per-drop thermo rows (JAX
    ``calculate_masses_new``); returns (mass_new, success_per_drop).

    ``per_drop=False``: the JAX package's XLA formulation, bisecting every
    drop until none is outside ``rtol_x`` (at most ``bisect_iters``).
    ``per_drop=True``: K3's rule, each drop stopping once its own bracket
    satisfies hi - lo <= rtol_x |x_old| + 1e-30, at most
    min(bisect_iters, 40) halvings (``pysdm_tpu/ops/pallas/condensation.py``
    ``:218-237`` stops per 32768-drop block instead), or at a midpoint where
    minfun is exactly 0. All three land within rtol_x |x_old| of the same
    root, except where the JAX rules meet an exact zero: they take it for
    "root above" and end at the bracket's upper end."""
    f = formulae
    const = f.constants
    rtol_x, RH_rtol, max_iters, bisect_iters = settings
    x_max = f.diffusion_coordinate.x_max()

    def minfun(x_new, x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd):
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

    margs = (x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd)
    a = x_old
    fa = minfun(a, *margs)

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
    fb = minfun(b, *margs)
    # double the step until the sign changes; a bracketed drop stays
    # bracketed, so the loop ends once none is left
    for i in range(max_iters):
        not_bracketed = (fa * fb >= 0) & need_solve
        if not bool(not_bracketed.any()):
            break
        b_try = torch.maximum(x_insane, a + dx_step * 2.0 ** (i + 1))
        fb_try = minfun(b_try, *margs)
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
        for _ in range(min(bisect_iters, 40)):
            update = solving & ((hi - lo) - tol > 0)
            if not bool(update.any()):
                break
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid, *margs)
            go_lo = flo * fmid < 0
            # an exact zero is the root: the global rule below takes it for
            # "root above" and walks lo up to hi (ROADMAP queue 3)
            at_root = update & (fmid == 0)
            hi = torch.where(update & go_lo | at_root, mid, hi)
            lo = torch.where(update & ~go_lo, mid, lo)
            flo = torch.where(update & ~go_lo, fmid, flo)
    else:
        scale = torch.where(x_old != 0, x_old, 1.0).abs()
        for _ in range(bisect_iters):
            unconverged = solving & ~f.trivia.within_tolerance(
                hi - lo, scale, rtol_x
            )
            if not bool(unconverged.any()):
                break
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid, *margs)
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
    return mass_new, (success_drop & finite) | ~active


class CondensationSolver:
    """the condensation step closed over formulae and configuration (JAX
    ``make_condensation_solver``), for one cell. ``substep_solves`` counts
    the per-drop solves (one per substep, fake or real; on CUDA tensors one
    K3 launch each), ``host_reads`` the values read back from the device to
    steer a loop."""

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
        if n_cell != 1:
            raise NotImplementedError(
                "multi-cell condensation is not ported yet: it comes with"
                " slice 3 (kernel K4 under the per-cell sums)"
            )
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

    def _read(self, tensor):
        """a device value the host branches on (counted)"""
        self.host_reads += 1
        return tensor.item()

    def substep(
        self, *, attrs, multiplicity, cell_of_drop, cell_active, dt_sub_cell,
        thd, qv, rhod, ml_old, dthd_dt_pred, dqv_dt_pred, drhod_dt, m_d,
        air_density, air_viscosity, fake,
    ):
        """one trapezoidal substep (reference ``step_impl`` 256-356) on the
        cells where ``cell_active``"""
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
        ml_new = torch.where(mass_new > 0, mult_f * mass_new, 0.0).sum()[None]
        dml_dt = (ml_new - ml_old) / torch.where(dt_sub > 0, dt_sub, 1.0)
        dqv_dt_corr = -dml_dt / m_d
        dthd_dt_corr = f.state_variable_triplet.dthd_dt(
            rhod=rhod, thd=thd, T=T,
            d_water_vapour_mixing_ratio__dt=dqv_dt_corr, lv=lv,
        )
        thd = torch.where(act, thd + dt_sub * (dthd_dt_pred / 2 + dthd_dt_corr), thd)
        qv = torch.where(act, qv + dt_sub * (dqv_dt_pred / 2 + dqv_dt_corr), qv)
        rhod = torch.where(act, rhod + dt_sub * drhod_dt / 2, rhod)

        fails = (~success_drop).to(torch.float32).sum()[None]
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

            def count(crossed):
                return torch.where(crossed, weight, 0.0).sum()[None]

            n_act = count((mass_new > mass_cr) & (mass_cr > water_mass))
            n_deact = count((mass_new < mass_cr) & (mass_cr < water_mass))
            n_act_growing = count((mass_new > mass_cr) & (mass_new > water_mass))
            n_ripen = torch.where(n_deact > 0, n_act_growing, zeros_cell)
            events = (n_act, n_deact, n_ripen)
        ml_out = torch.where(act & finite_cell, ml_new, ml_old)
        return attrs_out, thd, qv, rhod, ml_out, RH, success_cell, events

    @staticmethod
    def _liquid(attrs, multiplicity):
        water_mass = attrs["water_mass"]
        mult_f = multiplicity.to(water_mass.dtype)
        return torch.where(water_mass > 0, mult_f * water_mass, 0.0).sum()[None]

    def run_substeps(self, *, attrs, multiplicity, n_substeps, thd, **kwargs):
        """advance the cell through its n_substeps (JAX lockstep loop; the
        trip count is read on the host)"""
        dt_sub_cell = self.dt / n_substeps.to(thd.dtype)
        ml_old = self._liquid(attrs, multiplicity)
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
        (reference ``make_step_fake``); returns (thd_new, success)"""
        _, thd_new, _, _, _, _, success, _ = self.substep(
            attrs=attrs, multiplicity=multiplicity, cell_active=cell_mask,
            dt_sub_cell=self.dt / n_substeps.to(thd.dtype), thd=thd,
            ml_old=self._liquid(attrs, multiplicity), fake=True, **kwargs,
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
        self, *, attrs, multiplicity, cell_of_drop, n_substeps,
        thd, qv, rhod, pthd, pqv, prhod, m_d, air_density, air_viscosity,
    ):
        """full condensation step (reference ``solve``, 639-698); returns
        (water_mass, pthd, pqv, n_substeps, RH_max, success, events)"""
        dt = self.dt
        kwargs = dict(
            multiplicity=multiplicity, cell_of_drop=cell_of_drop,
            qv=qv, rhod=rhod,
            dthd_dt_pred=(pthd - thd) / dt, dqv_dt_pred=(pqv - qv) / dt,
            drhod_dt=(prhod - rhod) / dt, m_d=m_d,
            air_density=air_density, air_viscosity=air_viscosity,
        )
        if self.adaptive:
            n_substeps = self.adapt_substeps(
                n_substeps_prev=n_substeps, thd=thd,
                fake_kwargs={"attrs": attrs, **kwargs},
            )
        water_mass, thd_new, qv_new, _, RH_max, success, events = (
            self.run_substeps(attrs=attrs, n_substeps=n_substeps, thd=thd, **kwargs)
        )
        return water_mass, thd_new, qv_new, n_substeps, RH_max, success, events
