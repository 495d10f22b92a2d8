"""Plain float64 reference of one step of the Arabas et al. 2015 warm rain.

Written from the case's published semantics, not from the program: upstream
PySDM's ``Arabas_et_al_2015`` setup with its default formulae (libcloudph++
state triplet, Flatau-Walko-Cotton saturation pressure, Kirchhoff latent
heat, leading-terms kappa-Koehler curve, Mason 1971 growth with
Fuchs-Sutugin corrections, the log-mass coordinate, implicit-in-space
particle advection, Gunn & Kinzer 1949 fall speeds, the geometric kernel).
One step is, in upstream's order of dynamics:

1. ambient thermodynamics: the advected fields become the step's predicted
   state;
2. condensation: per cell, trapezoidal coupling of the cell's dry potential
   temperature and vapour to an implicit per-drop mass solve, with each
   cell's substep count found by Richardson doubling (dt/n against two
   dt/2n) from the configuration's smallest count;
3. Eulerian advection: two-pass MPDATA with the infinite gauge and
   flux-corrected transport, periodic, g-factor the dry-air density;
4. displacement: each drop by the courant field interpolated in its cell
   and by its fall speed, in the smallest power of two of substeps that the
   courant field's differences allow; drops that leave the column die;
5. coalescence: the sort croupier (a stable sort by cell and random bits,
   neighbours in a cell pair up), each cell's adaptive substep, gamma from
   the u01 draws, the Shima et al. 2009 update;
6. the predicted state is committed.

It starts from the program's state before the step (the drops and the
four evolving cell fields, ``STATE_ENV``), and takes the collision's random
draws from a device generator set to the state the program's was in when
the step began, in the order the program draws them (per substep the
shuffle's bits, then one u01 row). What the program derived from the
configuration (density profile, advector, courant fields, cell masses) is
worked out here again from the configuration.
"""

import functools

import numpy as np
import torch

F64 = torch.float64

# physical constants (SI), as upstream PySDM states them
RD = 287.0421396862956  # R / Md, Md = 28.966 g/mol
RV = 461.523055858115  # R / Mv, Mv the VSMOW water molar mass
EPS = 0.6219453958862249  # Mv / Md
C_PD, C_PV, C_PW = 1005.0, 1850.0, 4218.0
L_TRI, T_TRI, T0 = 2500711.849262262, 273.16, 273.15
P1000, G_STD = 100000.0, 9.80665
RHO_W, SGM_W = 1000.0, 0.072
D0, K0, MAC, HAC = 2.26e-5, 2.4e-2, 1.0, 1.0
PI_4_3 = 4 / 3 * np.pi
FWC = (611.583699, 44.460689599999995, 1.43177157, 0.026422432099999997,
       0.000299291081, 2.03154182e-06, 7.02620698e-09, 3.7953431e-12,
       -3.2158239300000003e-14)  # Flatau et al. 1992, Pa, in T - T0

# the cell fields of the program's state the step starts from: the current
# state and the advected fields of the step before
STATE_ENV = ("thd", "qv", "mpdata_thd", "mpdata_qv")

# condensation (upstream Condensation defaults)
RTOL_THD, RH_RTOL = 1e-6, 1e-7
DT_COND_RANGE = (1e-4, 1.0)
# coalescence (upstream Collision defaults) and displacement
DT_COAL_RANGE = (0.1, 100.0)
DISPLACEMENT_RTOL = 1e-2


class Domain:
    """the grid, the dry-air density, the advector and the particle courant
    fields of the configuration, float64 on ``device``"""

    def __init__(self, config, device):
        self.nx, self.nz = (int(n) for n in config["grid"])
        X, Z = (float(s) for s in config["size"])
        self.dx, self.dz = X / self.nx, Z / self.nz
        self.dv = self.dx * self.dz
        self.dt = float(config["dt"])
        self.p0 = float(config["p0"])
        self.th_std0 = float(config["th_std0"])
        self.qv0 = float(config["initial_water_vapour_mixing_ratio"])
        self.rhod_w_max = float(config["rhod_w_max"])
        self.X = X
        nx, nz = self.nx, self.nz
        zc = (np.arange(nz) + 0.5) / nz  # cell centres, in units of Z
        xc = (np.arange(nx) + 0.5) / nx
        xf = np.arange(nx + 1) / nx  # faces
        zf = np.arange(nz + 1) / nz
        rhod = np.repeat(self.rhod_of(zc)[None, :], nx, axis=0)
        # the stream function's differences between cell corners: a
        # discretely nondivergent mass flux times dt / dx (G x courant)
        dzZ, dxX = 1 / nz, 1 / nx
        xX, zZ = np.meshgrid(xf, zc, indexing="ij")
        gc_x = -(self.psi(xX, zZ + dzZ / 2) - self.psi(xX, zZ - dzZ / 2)) / self.dz
        gc_x = gc_x * self.dt / self.dx
        xX, zZ = np.meshgrid(xc, zf, indexing="ij")
        gc_z = (self.psi(xX + dxX / 2, zZ) - self.psi(xX - dxX / 2, zZ)) / self.dx
        gc_z = gc_z * self.dt / self.dz
        courant_x = gc_x / self.rhod_of(zc)[None, :]
        courant_z = gc_z / self.rhod_of(zf)[None, :]

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=F64, device=device)

        self.rhod = t(rhod)  # (nx, nz)
        self.gc = (t(gc_x), t(gc_z))
        self.courant = (t(courant_x), t(courant_z))
        self.m_d = self.rhod.reshape(-1) * self.dv

    def psi(self, xX, zZ):
        """the single eddy's stream function (Arabas et al. 2015, eq. 36)"""
        return (-self.rhod_w_max * self.X / np.pi * np.sin(np.pi * zZ)
                * np.cos(2 * np.pi * xX))

    def rhod_of(self, zZ):
        """dry-air density of the hydrostatic profile at constant th_std and
        vapour"""
        qv, k = self.qv0, RD / C_PD
        Rq = RV / (1 / qv + 1) + RD / (1 + qv)
        z = np.asarray(zZ) * self.dz * self.nz
        arg = (self.p0 / P1000) ** k - z * k * G_STD / self.th_std0 / Rq
        p = P1000 * arg ** (1 / k)
        return p * (1 - 1 / (1 + EPS / qv)) / ((p / P1000) ** k * RD * self.th_std0)


# --- thermodynamics ----------------------------------------------------------


def temperature(rhod, thd):
    k = RD / C_PD
    return thd * (rhod * thd / P1000 * RD) ** (k / (1 - k))


def pressure(rhod, T, qv):
    return rhod * (1 + qv) * (RV / (1 / qv + 1) + RD / (1 + qv)) * T


def saturation_pressure(T):
    acc = torch.full_like(T, FWC[-1])
    for c in FWC[-2::-1]:
        acc = c + (T - T0) * acc
    return acc


def cell_thermo(thd, qv, rhod):
    """T, p, RH, lv and pvs of each cell"""
    T = temperature(rhod, thd)
    p = pressure(rhod, T, qv)
    pvs = saturation_pressure(T)
    RH = p * qv / (qv + EPS) / pvs
    lv = L_TRI + (C_PV - C_PW) * (T - T_TRI)
    return T, p, RH, lv, pvs


# --- condensation --------------------------------------------------------------


def radius_of_mass(m):
    return (m / RHO_W / PI_4_3) ** (1 / 3)


class DropGrowth:
    """the implicit step of every drop in the cells of one substep: x = ln m,
    x_new = x_old + dt dx/dt(x_new), the diffusion and conduction terms at
    the old radius"""

    def __init__(self, mass, rd3, kappa, T, p, RH, lv, pvs, dt_sub):
        self.x_old = torch.log(mass)
        r = radius_of_mass(mass)
        self.A = 2 * SGM_W / RV / T / RHO_W
        self.B = kappa * rd3
        lam_d = D0 / torch.sqrt(2 * RV * T)
        lam_k = 0.8 * K0 * T / p / torch.sqrt(2 * RD * T)

        def fuchs_sutugin(coeff, lam, alpha):
            q = lam / r
            return coeff * (1 + q) / (1 + (4 / 3 / alpha + 0.377) * q + 4 / 3 / alpha * q * q)

        K = fuchs_sutugin(K0, lam_k, HAC)
        D = fuchs_sutugin(D0, lam_d, MAC)
        Fk = RHO_W * lv / T / K * (lv / T / RV - 1)
        Fd = RHO_W * RV * T / D / pvs
        self.inv_F = 1 / (Fk + Fd)
        self.RH, self.dt = RH, dt_sub
        self.RH_eq_old = self.RH_eq(r)

    def RH_eq(self, r):
        return 1 + self.A / r - self.B / r**3

    def residual(self, x):
        m = torch.exp(x)
        r = radius_of_mass(m)
        r_dr_dt = (self.RH - self.RH_eq(r)) * self.inv_F
        dx_dt = 4 * np.pi * RHO_W * r * r_dr_dt / m
        return torch.where(x > 0, self.x_old - x, self.x_old - x + self.dt * dx_dt)


def solve_masses(mass, rd3, kappa, active, T, p, RH, lv, pvs, dt_sub):
    """each active drop's new mass after one implicit substep: the root of
    the residual, bracketed by doubling steps from the old size and bisected
    to float64's precision; returns (mass_new, ok)"""
    g = DropGrowth(mass.clamp_min(1e-30), rd3, kappa, T, p, RH, lv, pvs, dt_sub)
    a = g.x_old
    fa = g.residual(a)
    at_equilibrium = (RH - g.RH_eq_old).abs() < RH_RTOL * RH.abs()
    solve = active & ~at_equilibrium & (fa != 0)
    x_floor = torch.log(RHO_W * rd3 * PI_4_3 / 100)
    step = torch.where(fa > 0, 1.0, -1.0) * torch.maximum(
        fa.abs(), 8 * torch.finfo(F64).eps * a.abs())
    b = torch.maximum(x_floor, a + step)
    fb = g.residual(b)
    for i in range(64):
        open_ = solve & (fa * fb > 0)
        if not bool(open_.any()):
            break
        b_try = torch.maximum(x_floor, a + step * 2.0 ** (i + 1))
        b = torch.where(open_, b_try, b)
        fb = torch.where(open_, g.residual(b_try), fb)
    ok = ~solve | (fa * fb <= 0)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    f_lo = torch.where(a <= b, fa, fb)
    bisect = solve & ok
    for _ in range(200):
        wide = bisect & (hi - lo > 4 * torch.finfo(F64).eps * a.abs())
        if not bool(wide.any()):
            break
        mid = 0.5 * (lo + hi)
        f_mid = g.residual(mid)
        below = f_lo * f_mid > 0  # the root lies above mid
        lo = torch.where(wide & below, mid, lo)
        f_lo = torch.where(wide & below, f_mid, f_lo)
        hi = torch.where(wide & ~below, mid, hi)
    x_new = torch.where(bisect, 0.5 * (lo + hi), a)
    mass_new = torch.where(bisect, torch.exp(x_new), mass)
    return mass_new, ok & torch.isfinite(mass_new)


class CondensationStep:
    """one condensation step over every cell (upstream ``Condensation``)"""

    def __init__(self, domain, drops, thd, qv, pthd, pqv):
        self.domain, self.drops = domain, drops
        self.cell = drops["cell"]
        self.n_cell = domain.nx * domain.nz
        self.rhod = domain.rhod.reshape(-1)
        self.thd, self.qv = thd, qv
        self.dthd_pred = (pthd - thd) / domain.dt
        self.dqv_pred = (pqv - qv) / domain.dt
        self.ml_entry = self.liquid(drops["mass"])

    def liquid(self, mass):
        w = self.drops["xi"] * torch.where(mass > 0, mass, 0.0)
        return torch.zeros(self.n_cell, dtype=F64, device=mass.device).index_add_(0, self.cell, w)

    def substep(self, mass, thd, qv, ml_old, dt_sub, active_cell):
        """one trapezoidal substep of length ``dt_sub`` (per cell) in the
        cells where ``active_cell``; returns (mass, thd, qv, ml, ok)"""
        act = active_cell
        thd_mid = torch.where(act, thd + dt_sub * self.dthd_pred / 2, thd)
        qv_mid = torch.where(act, qv + dt_sub * self.dqv_pred / 2, qv)
        T, p, RH, lv, pvs = cell_thermo(thd_mid, qv_mid, self.rhod)
        c = self.cell
        d = self.drops
        active = act[c] & (d["xi"] > 0) & (mass > 0)
        mass_new, ok_drop = solve_masses(
            mass, d["rd3"], d["kappa"], active, T[c], p[c], RH[c], lv[c], pvs[c],
            dt_sub[c])
        mass_new = torch.where(active & ok_drop, mass_new, mass)
        ml_new = self.liquid(mass_new)
        dml_dt = (ml_new - ml_old) / dt_sub
        dqv_corr = -dml_dt / self.domain.m_d
        dthd_corr = -lv * dqv_corr / C_PD / T * thd_mid * self.rhod
        thd_new = torch.where(act, thd_mid + dt_sub * (self.dthd_pred / 2 + dthd_corr), thd)
        qv_new = torch.where(act, qv_mid + dt_sub * (self.dqv_pred / 2 + dqv_corr), qv)
        fails = torch.zeros(self.n_cell, dtype=F64, device=mass.device).index_add_(
            0, c, (~ok_drop & active).to(F64))
        ok_cell = (fails == 0) | ~act
        return mass_new, thd_new, qv_new, torch.where(act, ml_new, ml_old), ok_cell

    def substeps(self):
        """each cell's substep count: doubled until the one-substep thd
        increment at dt/n is within rtol of twice that at dt/2n"""
        dt = self.domain.dt
        n_min = max(1, int(np.ceil(dt / min(DT_COND_RANGE[1], dt))))
        n_max = int(dt // DT_COND_RANGE[0])
        mass = self.drops["mass"]
        n = torch.full((self.n_cell,), float(n_min), dtype=F64, device=mass.device)
        all_cells = torch.ones_like(n, dtype=torch.bool)

        def fake(n, cells):
            _, thd_new, _, _, ok = self.substep(
                mass, self.thd, self.qv, self.ml_entry, dt / n, cells)
            return thd_new, ok

        thd_long, ok = fake(n, all_cells)
        for _ in range(32):
            if bool(ok.all()):
                break
            n = torch.where(ok, n, (2 * n).clamp_max(64.0))
            thd_try, ok_try = fake(n, ~ok)
            thd_long = torch.where(ok, thd_long, thd_try)
            ok = ok | ok_try | (n >= 64)
        done = torch.zeros_like(all_cells)
        for _ in range(32):
            if bool(done.all()):
                break
            thd_short, _ = fake(2 * n, ~done)
            error = ((thd_long - self.thd) - 2 * (thd_short - self.thd)).abs()
            within = error < RTOL_THD * self.thd.abs()
            n = torch.where(done | within, n, 2 * n)
            thd_long = torch.where(done, thd_long, thd_short)
            done = done | within | (2 * n > n_max)
        return n.clamp_max(n_max)

    def run(self):
        """the drops' new masses and the cells' new thd and qv, and whether
        every solve converged"""
        n = self.substeps()
        dt_sub = self.domain.dt / n
        mass, thd, qv, ml = self.drops["mass"], self.thd, self.qv, self.ml_entry
        ok = torch.ones_like(n, dtype=torch.bool)
        for s in range(int(n.max())):
            mass, thd, qv, ml, ok_s = self.substep(mass, thd, qv, ml, dt_sub, s < n)
            ok = ok & ok_s
        return mass, thd, qv, bool(ok.all())


# --- MPDATA ----------------------------------------------------------------------


def _pad(a, axis):
    """one periodic halo cell on each side along ``axis``"""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, n - 1, 1), a, a.narrow(axis, 0, 1)], dim=axis)


def _cells_at_faces(psi_px, axis):
    """(left, right) cell values at the n + 1 faces along ``axis`` of a
    field padded along it"""
    n = psi_px.shape[axis] - 2
    return psi_px.narrow(axis, 0, n + 1), psi_px.narrow(axis, 1, n + 1)


def _divergence(fx, fz):
    return (fx[1:, :] - fx[:-1, :]) + (fz[:, 1:] - fz[:, :-1])


def mpdata(psi0, gc, G):
    """two MPDATA passes (Smolarkiewicz and Margolin 1998) with the infinite
    gauge and flux-corrected transport (libmpdata++ conventions) on a
    periodic (nx, nz) grid; ``gc`` = (G courant at the x faces (nx+1, nz),
    at the z faces (nx, nz+1)), ``G`` the g-factor at the cells"""
    U, W = gc
    # donor-cell pass
    lx, rx = _cells_at_faces(_pad(psi0, 0), 0)
    lz, rz = _cells_at_faces(_pad(psi0, 1), 1)
    fx = U.clamp_min(0) * lx + U.clamp_max(0) * rx
    fz = W.clamp_min(0) * lz + W.clamp_max(0) * rz
    psi = psi0 - _divergence(fx, fz) / G

    # the antidiffusive pseudo-velocities from the first pass's field
    pp = _pad(_pad(psi, 0), 1)  # (nx+2, nz+2)
    nx, nz = psi.shape
    # x faces i = 0..nx between cells i-1 and i (padded index i and i+1)
    xl, xr = pp[0:nx + 1, 1:nz + 1], pp[1:nx + 2, 1:nz + 1]
    xlu, xru = pp[0:nx + 1, 2:nz + 2], pp[1:nx + 2, 2:nz + 2]
    xld, xrd = pp[0:nx + 1, 0:nz], pp[1:nx + 2, 0:nz]
    Gx = 0.5 * (_pad(G, 0)[0:nx + 1] + _pad(G, 0)[1:nx + 2])
    Wp = _pad(W, 0)  # (nx+2, nz+1)
    W_at_x = 0.25 * (Wp[0:nx + 1, 0:nz] + Wp[0:nx + 1, 1:nz + 1]
                     + Wp[1:nx + 2, 0:nz] + Wp[1:nx + 2, 1:nz + 1])
    Ux = ((U.abs() - U**2 / Gx) * 0.5 * (xr - xl)
          - U * W_at_x / Gx * 0.5 * (xlu + xru - xld - xrd) / 4)
    # z faces k = 0..nz between cells k-1 and k
    zl, zr = pp[1:nx + 1, 0:nz + 1], pp[1:nx + 1, 1:nz + 2]
    zlu, zru = pp[2:nx + 2, 0:nz + 1], pp[2:nx + 2, 1:nz + 2]
    zld, zrd = pp[0:nx, 0:nz + 1], pp[0:nx, 1:nz + 2]
    Gz = 0.5 * (_pad(G, 1)[:, 0:nz + 1] + _pad(G, 1)[:, 1:nz + 2])
    Up = _pad(U, 1)  # (nx+1, nz+2)
    U_at_z = 0.25 * (Up[0:nx, 0:nz + 1] + Up[0:nx, 1:nz + 2]
                     + Up[1:nx + 1, 0:nz + 1] + Up[1:nx + 1, 1:nz + 2])
    Wz = ((W.abs() - W**2 / Gz) * 0.5 * (zr - zl)
          - W * U_at_z / Gz * 0.5 * (zlu + zru - zld - zrd) / 4)

    # flux-corrected transport: the local extrema of both passes' fields
    def extremum(reduce):
        out = None
        for field in (psi, psi0):
            q = _pad(_pad(field, 0), 1)
            c = q[1:nx + 1, 1:nz + 1]
            for other in (q[0:nx, 1:nz + 1], q[2:nx + 2, 1:nz + 1],
                          q[1:nx + 1, 0:nz], q[1:nx + 1, 2:nz + 2]):
                c = reduce(c, other)
            out = c if out is None else reduce(out, c)
        return out

    psi_max, psi_min = extremum(torch.maximum), extremum(torch.minimum)
    tiny = 1e-15
    inflow = (Ux[:-1].clamp_min(0) - Ux[1:].clamp_max(0)
              + Wz[:, :-1].clamp_min(0) - Wz[:, 1:].clamp_max(0))
    outflow = (Ux[1:].clamp_min(0) - Ux[:-1].clamp_max(0)
               + Wz[:, 1:].clamp_min(0) - Wz[:, :-1].clamp_max(0))
    beta_up = (psi_max - psi) * G / (inflow + tiny)
    beta_dn = (psi - psi_min) * G / (outflow + tiny)

    def limited(V, axis):
        up_l, up_r = _cells_at_faces(_pad(beta_up, axis), axis)
        dn_l, dn_r = _cells_at_faces(_pad(beta_dn, axis), axis)
        pos = torch.minimum(dn_l, up_r).clamp_max(1.0)
        neg = torch.minimum(up_l, dn_r).clamp_max(1.0)
        return V.clamp_min(0) * pos + V.clamp_max(0) * neg

    return psi - _divergence(limited(Ux, 0), limited(Wz, 1)) / G


# --- displacement ------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _gunn_kinzer():
    """fall speed [m/s] at radii 0, 1e-5, ..., 6e-3 m and the slope to the
    next: Gunn & Kinzer 1949 Table 2 through a radial-basis interpolant,
    Beard's small-drop formula below 40 um (upstream ``GunnKinzer1949``)"""
    from scipy.interpolate import Rbf

    diameters_mm = np.array([
        0.078, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.2, 1.4, 1.6,
        1.8, 2.0, 2.2, 2.4, 2.6, 2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0, 4.2, 4.4,
        4.6, 4.8, 5.0, 5.2, 5.4, 5.6, 5.8])
    speeds_cm_s = np.array([
        18, 27, 72, 117, 162, 206, 247, 287, 327, 367, 403, 464, 517, 565, 609,
        649, 690, 727, 757, 782, 806, 826, 844, 860, 872, 883, 892, 898, 903,
        907, 909, 912, 914, 916, 917])
    r = np.linspace(0.0, 6e-3, 601)
    u = Rbf(diameters_mm * 1e-3 / 2, speeds_cm_s / 100)(r)
    u[0] = 0.0
    small = (r > 0) & (r < 40e-6)
    # Beard 1976, small drops, at 293.15 K and 1000 hPa
    T, p, p0, rho0, eta, eta0 = 293.15, 1000e2, 1013.25e2, 1.204, 1.832e-5, 1.818e-5
    l0 = 6.62e-8
    mfp = l0 * (eta / eta0) * (p0 * rho0 / p * (0.348 * p / T)) ** 0.5
    r_cm = r[small] * 100
    c = np.array([10.5035, 1.08750, -0.133245, -0.00659969])
    f = (eta0 / eta) * (1 + 1.255 * mfp / r_cm) / (1 + 1.255 * l0 / r_cm)
    u[small] = f * np.exp(sum(c[j] * np.log(2 * r_cm) ** j for j in range(4))) / 100
    slope = np.append(np.diff(u), u[-1] - u[-2]) / (r[1] - r[0])
    return u, slope


def fall_speed(mass):
    """terminal velocity [m/s] of drops of ``mass``: the table read
    linearly between its radii"""
    u, slope = (torch.as_tensor(a, dtype=F64, device=mass.device) for a in _gunn_kinzer())
    r = radius_of_mass(mass.clamp_min(0)).clamp_max(6e-3)
    scaled = r * 1e5
    i = scaled.long().clamp(0, 600)
    return u[i] + (scaled - i) / 1e5 * slope[i]


def displace(domain, drops, mass):
    """the drops moved through one step; those that leave the column die"""
    cx, cz = domain.courant
    d_max = max(float(cx.diff(dim=0).abs().max()), float(cz.diff(dim=1).abs().max()))
    n = 1
    while (d_max / n) / (1 - d_max / n) >= DISPLACEMENT_RTOL:
        n *= 2
    dt_sub = domain.dt / n
    v_fall = fall_speed(mass)
    ox, oz = drops["origin"][0].clone(), drops["origin"][1].clone()
    px, pz = drops["position"][0].clone(), drops["position"][1].clone()
    xi = drops["xi"].clone()
    nx, nz = domain.nx, domain.nz
    for _ in range(n):
        ix, iz = ox.clamp(0, nx - 1), oz.clamp(0, nz - 1)
        cl, cr = cx[ix, iz] / n, cx[ix + 1, iz] / n
        dx = (cl * (1 - px) + cr * px) / (1 - cr + cl)
        cl, cr = cz[ix, iz] / n, cz[ix, iz + 1] / n
        dz = (cl * (1 - pz) + cr * pz) / (1 - cr + cl) - v_fall * dt_sub / domain.dz
        px, pz = px + dx, pz + dz
        z = oz + pz
        xi = torch.where((z < 0) | (z > nz), 0, xi)
        fx, fz = torch.floor(px), torch.floor(pz)
        ox, oz = ox + fx.long(), oz + fz.long()
        px, pz = px - fx, pz - fz
        ox, oz = torch.remainder(ox, nx), torch.remainder(oz, nz)
    return {**drops, "xi": xi, "origin": torch.stack([ox, oz]),
            "position": torch.stack([px, pz]), "cell": ox * nz + oz}


# --- coalescence ---------------------------------------------------------------


def shuffle_bits_for(n_cell):
    """random bits of the sort key below the cell's (dead drops included)"""
    return 32 - max(1, int(np.ceil(np.log2(n_cell + 1))))


def coalesce(domain, drops, mass_row, ext, draw):
    """the drops after one step of the sort-croupier coalescence; ``ext``:
    every extensive row (float64, (R, n)), ``mass_row`` its water mass's;
    ``draw(n_bits)``: one substep's shuffle bits and u01 row"""
    dt, dv = domain.dt, domain.dv
    n_cell = domain.nx * domain.nz
    n_bits = shuffle_bits_for(n_cell)
    xi, cell = drops["xi"], drops["cell"]
    dt_left = torch.full((n_cell,), dt, dtype=F64, device=xi.device)
    slots = torch.arange(xi.shape[0], device=xi.device)
    while bool((dt_left > 0).any()):
        bits, u01 = draw(n_bits)
        key_cell = torch.where(xi > 0, cell, n_cell)
        order = torch.sort((key_cell << n_bits) | bits, stable=True).indices
        xi, cell, ext, key_cell = xi[order], cell[order], ext[:, order], key_cell[order]
        start = torch.searchsorted(key_cell, torch.arange(n_cell + 1, device=xi.device))
        n_in = (start[1:] - start[:-1]).to(F64)
        norm = torch.where(
            n_in < 2, 0.0, dt / dv * n_in * (n_in - 1) / 2 / torch.floor(n_in / 2))
        live = key_cell < n_cell
        offset = slots - start[key_cell.clamp_max(n_cell - 1)]
        lead = torch.zeros_like(live)
        lead[:-1] = live[:-1] & (key_cell[1:] == key_cell[:-1]) & (offset[:-1] % 2 == 0)
        a = torch.nonzero(lead).squeeze(1)
        b = a + 1
        r = radius_of_mass(ext[mass_row].clamp_min(0))
        v = fall_speed(ext[mass_row])
        kernel = np.pi * (r[a] + r[b]) ** 2 * (v[a] - v[b]).abs()
        c = key_cell[a]
        j_is_a = xi[a] >= xi[b]
        j = torch.where(j_is_a, a, b)
        k = torch.where(j_is_a, b, a)
        mj, mk = xi[j], xi[k]
        prob = mj.to(F64) * kernel * norm[c]
        ratio = torch.floor(mj.to(F64) / mk.to(F64))
        dt_opt = torch.where(
            prob > 0, (dt * ratio / torch.where(prob > 0, prob, 1.0)).clamp_min(DT_COAL_RANGE[0]),
            torch.inf)
        per_cell = torch.full((n_cell,), torch.inf, dtype=F64, device=xi.device)
        per_cell = per_cell.scatter_reduce(0, c, dt_opt, reduce="amin")
        dt_todo = torch.minimum(dt_left.clamp_max(min(DT_COAL_RANGE[1], dt)), per_cell)
        dt_left = dt_left - dt_todo
        gamma = torch.ceil(prob * dt_todo[c] / dt - u01[a]).clamp(0, 2.0**62)
        gamma = torch.minimum(gamma.long(), mj // mk)
        left = mj - gamma * mk
        split = (left == 0) & (gamma > 0)
        merged = ext[:, k] + gamma.to(F64) * ext[:, j]
        xi = xi.clone()
        xi[j] = torch.where(split, mk // 2, left)
        xi[k] = torch.where(split, mk - mk // 2, mk)
        ext = ext.clone()
        ext[:, k] = merged
        ext[:, j] = torch.where(split, merged, ext[:, j])
    return {**drops, "xi": xi, "cell": cell}, ext


# --- the step ---------------------------------------------------------------------


class Replay:
    """the collision's draws as the program takes them: per substep the
    shuffle's random bits (int64), then one u01 row in the program's float
    type, from a device generator set to the state the program's was in"""

    def __init__(self, gen_state, n_sd, device, program_dtype):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(gen_state)
        self.n_sd, self.device, self.program_dtype = n_sd, device, program_dtype

    def __call__(self, n_bits):
        bits = torch.randint(0, 2**n_bits, (self.n_sd,), generator=self.gen,
                             device=self.device, dtype=torch.int64)
        u01 = torch.rand(self.n_sd, generator=self.gen, device=self.device,
                         dtype=self.program_dtype)
        return bits, u01.to(F64)


def step(config, before, gen_state, program_dtype, device, store=None):
    """the reference's step from ``before`` (host arrays of the program's
    state: ``xi``, ``origin`` (2, n), ``position`` (2, n), ``ext`` (R, n)
    with ``ext_names``, and the cell fields of ``STATE_ENV``), with the
    collision's draws from ``gen_state``; ``store`` rounds every floating
    value of that state, and of the result, to that precision (the
    control). Returns the cell fields after the step (``fields``) and
    whether every condensation solve converged."""

    def t(a, dtype=F64):
        a = torch.as_tensor(np.asarray(a)).to(device)
        if dtype is F64 and store is not None:
            a = a.to(store)
        return a.to(dtype)

    domain = Domain(config, device)
    names = list(before["ext_names"])
    ext = t(before["ext"])
    row = {name: i for i, name in enumerate(names)}
    origin = t(before["origin"], torch.int64)
    drops = {
        "xi": t(before["xi"], torch.int64),
        "origin": origin,
        "position": t(before["position"]),
        "cell": origin[0] * domain.nz + origin[1],
    }
    env = {name: t(before["env"][name]) for name in STATE_ENV}
    vdry = ext[row["dry volume"]]
    drops["rd3"] = vdry / PI_4_3
    drops["kappa"] = ext[row["kappa times dry volume"]] / vdry
    drops["mass"] = ext[row["signed water mass"]]

    # 1. the advected fields are the step's predicted state
    pthd, pqv = env["mpdata_thd"], env["mpdata_qv"]
    # 2. condensation
    mass, pthd, pqv, converged = CondensationStep(
        domain, drops, env["thd"], env["qv"], pthd, pqv).run()
    ext = ext.clone()
    ext[row["signed water mass"]] = mass
    # 3. advection of the predicted fields
    shape = (domain.nx, domain.nz)
    adv_thd = mpdata(pthd.reshape(shape), domain.gc, domain.rhod).reshape(-1)
    adv_qv = mpdata(pqv.reshape(shape), domain.gc, domain.rhod).reshape(-1)
    # 4. displacement, 5. coalescence
    drops = displace(domain, drops, mass)
    replay = Replay(gen_state, drops["xi"].shape[0], device, program_dtype)
    drops, ext = coalesce(domain, drops, row["signed water mass"], ext, replay)
    # 6. commit
    fields = cell_fields(drops["xi"], drops["cell"], ext[row["signed water mass"]],
                         pthd, pqv, adv_thd, adv_qv, domain.nx * domain.nz)
    if store is not None:
        fields = {k: v.to(store).to(F64) for k, v in fields.items()}
    return {k: v.cpu().numpy() for k, v in fields.items()}, converged


def cell_fields(xi, cell, mass, thd, qv, adv_thd, adv_qv, n_cell):
    """per cell, float64: th (the dry potential temperature) and qv after
    the step, the advected th and qv the next step starts from, the droplet
    number (sum of multiplicities) and the liquid water (sum of
    multiplicity x water mass)"""
    xi = xi.to(F64)
    cell = cell.long()

    def per_cell(values):
        out = torch.zeros(n_cell, dtype=F64, device=values.device)
        return out.index_add_(0, cell, values.to(F64))

    return {
        "th": thd.to(F64), "qv": qv.to(F64),
        "th_adv": adv_thd.to(F64), "qv_adv": adv_qv.to(F64),
        "number": per_cell(xi), "liquid": per_cell(xi * mass.to(F64)),
    }


def gaps(got, want):
    """the largest per-cell gap of each field: th (after the step and
    advected) against each cell's th, the droplet number against each
    cell's, qv (after the step and advected) and the liquid water against
    the domain's largest"""
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}

    def rel_each(name):
        g, w = got[name], want[name]
        return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)))

    def rel_max(name):
        g, w = got[name], want[name]
        return float(np.max(np.abs(g - w)) / np.max(np.abs(w)))

    return {
        "th_gap": max(rel_each("th"), rel_each("th_adv")),
        "qv_gap": max(rel_max("qv"), rel_max("qv_adv")),
        "number_gap": rel_each("number"),
        "liquid_gap": rel_max("liquid"),
    }
