"""SciPy adaptive-timestep ODE condensation solver, a drop-in replacement
for the implicit solver, FOR USE IN TESTS ONLY: the cross-check of the
implicit solve (K3 on the card) against an integrator that shares none of
its code (port of ``pysdm_tpu/utils/scipy_ode_condensation_solver.py``;
parity: reference
``PySDM/backends/impl_numba/test_helpers/scipy_ode_condensation_solver.py``).

``patch_particulator`` replaces the Condensation stage of the composed step
with a host step: it reads the particles and the env to float64 NumPy,
integrates the coupled (thd, x_1..x_n) system with
``scipy.integrate.solve_ivp`` (LSODA, rtol 1e-6, atol 0), where x is the
diffusion coordinate of a drop's mass and the vapour mixing ratio follows
from total-water conservation (reference ``_odesys``, lines 169-225), and
writes the masses, ``pred_thd`` and ``pred_qv`` back in the state's dtype
and on its device. The right-hand side calls the port's ``Formulae`` on
NumPy arrays (``physics/_xp.py`` dispatches on the type). Single-cell
environments only (parcel, box), as the reference helper is used.
"""

import types

import numpy as np
import scipy.integrate
import torch

from ..environments.impl.moist import recalc_thermo

idx_thd = 0
idx_x = 1
rtol = 1e-6


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


def _make_host_step(particulator):
    f = particulator.formulae
    const = f.constants
    dt = particulator.dt
    resolver = particulator._resolver

    def odesys(
        t, y, kappa, f_org, dry_volume, n, reynolds_number,
        dthd_dt, dqv_dt, drhod_dt, m_d, air_density, air_viscosity,
        rhod0, qt,
    ):
        thd = y[idx_thd]
        x = y[idx_x:]
        mass = np.asarray(f.diffusion_coordinate.mass(x))
        qv = qt + dqv_dt * t - np.sum(n * mass) / m_d
        rhod = rhod0 + drhod_dt * t
        T = float(f.state_variable_triplet.T(rhod, thd))
        p = float(f.state_variable_triplet.p(rhod, T, qv))
        pv = float(f.state_variable_triplet.pv(p, qv))
        pvs = float(f.saturation_vapour_pressure.pvs_water(T))
        RH = pv / pvs
        lv = float(f.latent_heat_vapourisation.lv(T))

        DTp = f.diffusion_thermics.D(T, p)
        KTp = f.diffusion_thermics.K(T, p)
        lambdaD = f.diffusion_kinetics.lambdaD(DTp, T)
        lambdaK = f.diffusion_kinetics.lambdaK(T, p)
        Sc = f.trivia.air_schmidt_number(
            dynamic_viscosity=air_viscosity, diffusivity=DTp,
            density=air_density,
        )
        v = np.asarray(f.particle_shape_and_density.mass_to_volume(mass))
        r = np.asarray(f.trivia.radius(v))
        Dr = np.asarray(f.diffusion_kinetics.D(DTp, r, lambdaD))
        Kr = np.asarray(f.diffusion_kinetics.K(KTp, r, lambdaK))
        vent = np.asarray(
            f.ventilation.ventilation_coefficient(
                sqrt_re_times_cbrt_sc=f.trivia.sqrt_re_times_cbrt_sc(
                    Re=reynolds_number, Sc=Sc
                )
            )
        )
        sgm = np.asarray(f.surface_tension.sigma(T, v, dry_volume, f_org))
        Fk = np.asarray(f.drop_growth.Fk(T=T, lv=lv, K=vent * Kr))
        Fd = np.asarray(f.drop_growth.Fd(T=T, pvs=pvs, D=vent * Dr))
        RH_eq = np.asarray(
            f.hygroscopicity.RH_eq(
                r, T, kappa, dry_volume / const.PI_4_3, sgm
            )
        )
        r_dr_dt = np.asarray(
            f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd)
        )
        dm_dt = np.asarray(
            f.particle_shape_and_density.dm_dt(r=r, r_dr_dt=r_dr_dt)
        )
        dy_dt = np.empty_like(y)
        dy_dt[idx_x:] = np.asarray(f.diffusion_coordinate.dx_dt(mass, dm_dt))
        sum_n_dm_dt = np.sum(n * dm_dt)
        dy_dt[idx_thd] = dthd_dt + float(
            f.state_variable_triplet.dthd_dt(
                rhod, thd, T, dqv_dt - sum_n_dm_dt / m_d, lv
            )
        )
        return dy_dt

    def host_step(sim):
        particles = sim["particles"]
        env = dict(sim["env"])
        if int(particulator.mesh.n_cell) != 1:
            raise NotImplementedError(
                "scipy cross-check solver supports single-cell envs only"
            )
        n = _host(particles.multiplicity)
        alive = n > 0
        mass = _host(particles.ext("signed water mass"))
        dry_volume = _host(particles.ext("dry volume"))
        kappa = _host(resolver.get(particles, "kappa"))
        f_org = _host(resolver.get(particles, "dry volume organic fraction"))
        reynolds = _host(resolver.get(particles, "Reynolds number", env=env))

        def scalar(name):
            return float(_host(env[name])[0])

        thd, qv, rhod = scalar("thd"), scalar("qv"), scalar("rhod")
        pthd, pqv, prhod = (
            scalar("pred_thd"), scalar("pred_qv"), scalar("pred_rhod")
        )
        m_d = scalar("m_d")
        air_density = scalar("air_density")
        air_viscosity = scalar("air_viscosity")

        dthd_dt = (pthd - thd) / dt
        dqv_dt = (pqv - qv) / dt
        drhod_dt = (prhod - rhod) / dt

        mass_alive = np.where(alive, mass, 1e-18)
        y0 = np.empty(1 + int(alive.sum()))
        y0[idx_thd] = thd
        y0[idx_x:] = np.asarray(
            f.diffusion_coordinate.x(mass_alive[alive])
        )
        qt = qv + np.sum(n[alive] * mass_alive[alive]) / m_d

        integ = scipy.integrate.solve_ivp(
            fun=odesys,
            args=(
                kappa[alive], f_org[alive], dry_volume[alive], n[alive],
                reynolds[alive], dthd_dt, dqv_dt, drhod_dt, m_d,
                air_density, air_viscosity, rhod, qt,
            ),
            t_span=(0, dt),
            t_eval=(dt,),
            y0=y0,
            rtol=rtol,
            atol=0,
            method="LSODA",
        )
        assert integ.success, integ.message
        y1 = integ.y[:, 0]

        new_mass = mass.copy()
        new_mass[alive] = np.asarray(
            f.diffusion_coordinate.mass(y1[idx_x:])
        )
        new_thd = float(y1[idx_thd])
        new_qv = qt + dqv_dt * dt - np.sum(n[alive] * new_mass[alive]) / m_d

        dtype, device = particulator.dtype, particulator.device
        particles = particles.set_ext(
            "signed water mass",
            torch.as_tensor(new_mass, dtype=dtype, device=device),
        )
        env["pred_thd"] = torch.tensor([new_thd], dtype=dtype, device=device)
        env["pred_qv"] = torch.tensor([new_qv], dtype=dtype, device=device)
        (env["T"], env["p"], env["RH"], env["air_density"],
         env["air_viscosity"]) = recalc_thermo(
            particulator.formulae, env["pred_thd"], env["pred_qv"],
            env["pred_rhod"],
        )
        counters = dict(sim["counters"])
        counters["condensation_RH_max"] = torch.maximum(
            counters["condensation_RH_max"],
            env["RH"].to(counters["condensation_RH_max"].dtype),
        )
        return {**sim, "particles": particles, "env": env,
                "counters": counters}

    return host_step


def patch_particulator(particulator):
    """swap the Condensation stage of the composed step for the SciPy host
    step; the composed step is rebuilt from ``_named_step_fns``, so that
    ``run``, ``enable_per_dynamic_timing`` and ``profile_run`` all run the
    patched chain"""
    assert "Condensation" in particulator.dynamics
    host_step = _make_host_step(particulator)
    particulator._named_step_fns = tuple(
        (name, host_step if name == "Condensation" else fn)
        for name, fn in particulator._named_step_fns
    )
    particulator._compose()
    particulator.condensation_solver_patched = types.SimpleNamespace(
        kind="scipy_ode"
    )
    return particulator
