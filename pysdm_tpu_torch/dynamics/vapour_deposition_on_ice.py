"""Vapour deposition on ice (port of
``pysdm_tpu/dynamics/vapour_deposition_on_ice.py``; reference
``PySDM/dynamics/vapour_deposition_on_ice.py`` and
``backends/impl_numba/methods/deposition_methods.py``): capacitance-based
depositional growth and sublimation of the frozen particles (the Howell
form), one explicit Euler step in the diffusion coordinate, with the
vapour and heat fed back into the cell's predicted qv and thd.

The per-cell vapour demand and vapour change are sums over the cell's
drops: in float64 in a fixed order (``ops/moments.py`` ``cell_sums``,
or one sum for a single cell), never by a float atomic add, so a step is
deterministic on the card. As in the JAX package, a NaN increment is
zeroed, a growth beyond the cell's whole vapour excess over ice
saturation is capped to it before the sum (so that a huge demand cannot
overflow it), and the cell's growth is scaled down to that excess. A step
reads nothing back from the device.
"""

import torch

from ..ops.moments import cell_sums


class VapourDepositionOnIce:
    def __init__(self):
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        if not builder.formulae.particle_shape_and_density.supports_mixed_phase():
            raise ValueError(
                "VapourDepositionOnIce needs a mixed-phase"
                " particle_shape_and_density"
            )
        builder.request_attribute("Reynolds number")

    def make_step(self, particulator):
        f = particulator.formulae
        const = f.constants
        dt = particulator.dt
        n_cell = particulator.mesh.n_cell
        dv = particulator.mesh.dv

        def step(sim):
            particles = sim["particles"]
            env = dict(sim["env"])
            signed_mass = particles.ext("signed water mass")
            mult_f = particles.multiplicity.to(signed_mass.dtype)
            cell = particles.cell_id.long()

            frozen = signed_mass < 0
            ice_mass = torch.where(frozen, -signed_mass, 1e-18)

            T = env["T"][cell]
            p = env["p"][cell]
            RH = env["RH"][cell]
            rhod = env["rhod"][cell]
            pvs_w = f.saturation_vapour_pressure.pvs_water(T)
            pvs_i = f.saturation_vapour_pressure.pvs_ice(T)
            saturation_ratio_ice = RH / (pvs_i / pvs_w)

            radius = f.particle_shape_and_density.mass_to_radius(signed_mass)
            radius = torch.where(frozen, radius, 1e-9)
            ls = f.latent_heat_sublimation.ls(T)
            capacity = f.diffusion_ice_capacity.capacity(ice_mass)

            Dv = torch.broadcast_to(
                torch.as_tensor(f.diffusion_thermics.D(T, p), dtype=T.dtype,
                                device=T.device),
                T.shape,
            )
            D = f.diffusion_ice_kinetics.D(
                Dv, radius, f.diffusion_ice_kinetics.lambdaD(T, p), T
            )
            Ka = torch.broadcast_to(
                torch.as_tensor(f.diffusion_thermics.K(T, p), dtype=T.dtype,
                                device=T.device),
                T.shape,
            )
            K = f.diffusion_ice_kinetics.K(
                Ka, radius, f.diffusion_ice_kinetics.lambdaK(T, p), T, rhod
            )

            # ventilation factors 1 (reference deposition_methods.py TODO #1655)
            Fk = f.drop_growth.Fk(T=T, K=K, lv=ls)
            Fd = f.drop_growth.Fd(T=T, D=D, pvs=pvs_i)
            r_dr_dt = f.drop_growth.r_dr_dt(
                RH_eq=1.0, RH=saturation_ratio_ice, Fk=Fk, Fd=Fd
            )
            dm_dt = 4 * const.PI * capacity * r_dr_dt * const.rho_w

            active = frozen & (saturation_ratio_ice != 1.0) & (mult_f > 0)
            dm_dt = torch.where(active, dm_dt, 0.0)

            # explicit Euler in the diffusion coordinate; sublimation stops
            # at a tiny positive ice mass
            x_old = f.diffusion_coordinate.x(ice_mass)
            dx_dt = f.diffusion_coordinate.dx_dt(ice_mass, dm_dt)
            mass_tentative = f.diffusion_coordinate.mass(x_old + dt * dx_dt)
            mass_tentative = mass_tentative.clamp(min=1e-21)
            dm = torch.where(active, mass_tentative - ice_mass, 0.0)

            # the cell's vapour excess over ice saturation bounds its growth
            pvs_i_cell = f.saturation_vapour_pressure.pvs_ice(env["T"])
            qv_sat_ice = const.eps * pvs_i_cell / (env["p"] - pvs_i_cell)
            # the dry-air mass: constant in a parcel, dv * rhod on a grid
            m_d_cell = env["m_d"] if "m_d" in env else dv * env["rhod"]
            avail = (env["qv"] - qv_sat_ice).clamp(min=0.0)
            cap = (avail * m_d_cell)[cell]
            dm = torch.where(dm.isnan(), 0.0, dm)
            dm = torch.minimum(dm, cap)
            demand = cell_sums(dm.clamp(min=0.0) * mult_f, cell, n_cell) / m_d_cell
            scale = torch.where(
                demand > avail, avail / demand.clamp(min=1e-300), 1.0
            )
            dm = torch.where(dm > 0, dm * scale[cell], dm)
            new_mass = (ice_mass + dm).clamp(min=1e-21)

            # the vapour and heat fed back into the predicted fields
            delta_rv = cell_sums(-dm * mult_f, cell, n_cell) / m_d_cell
            env["pred_qv"] = env["pred_qv"] + delta_rv
            dthd = f.state_variable_triplet.dthd_dt(
                rhod=env["rhod"],
                thd=env["pred_thd"],
                T=env["T"],
                d_water_vapour_mixing_ratio__dt=delta_rv / dt,
                lv=f.latent_heat_sublimation.ls(env["T"]),
            ) * dt
            env["pred_thd"] = env["pred_thd"] + dthd

            signed_mass = torch.where(active, -new_mass, signed_mass)
            particles = particles.set_ext("signed water mass", signed_mass)
            return {**sim, "particles": particles, "env": env}

        return step
