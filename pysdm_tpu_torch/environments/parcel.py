"""Adiabatic parcel environment (port of ``pysdm_tpu/environments/parcel.py``;
reference ``PySDM/environments/parcel.py``): hydrostatic dry-air density
driven by a prescribed vertical velocity w(t), displacement-defined dv, and
wet radii equilibrated at initialisation.

The env state is a dict of tensors of shape (1,) in the sim-state;
``make_sync_step`` is the AmbientThermodynamics stage (advance z and rhod,
recompute the predicted T, p, RH), ``make_commit_step`` the end-of-step
predicted-to-current swap.

``mixed_phase`` is stored only, as in the JAX package: the freezing and
deposition steps compute the water activity of ice and the RH over ice
from the cell's T and RH themselves.

The parcel's clock lives on the host, in ``sim["host"]["t"]``: w(t) is a
Python callable evaluated there, so a step never reads the device to learn
t (the JAX package traces w, or falls back to ``jax.pure_callback``). The
tensor ``env["t"]`` advances beside it so that ``get_env("t")`` reads it.
"""

import numpy as np
import torch

from ..impl.mesh import Mesh
from .impl.moist import moist_commit, recalc_thermo


class Parcel:
    def __init__(
        self,
        *,
        dt,
        mass_of_dry_air: float,
        p0: float,
        initial_water_vapour_mixing_ratio: float,
        T0: float,
        w,
        z0: float = 0.0,
        mixed_phase=False,
    ):
        self.dt = dt
        self.mass_of_dry_air = mass_of_dry_air
        self.p0 = p0
        self.initial_water_vapour_mixing_ratio = initial_water_vapour_mixing_ratio
        self.T0 = T0
        self.w = w if callable(w) else (lambda t: w)
        self.z0 = z0
        self.mixed_phase = mixed_phase
        self.particulator = None
        self.formulae = None
        self._initial = {}

    def register(self, builder):
        self.particulator = builder.particulator
        self.formulae = builder.particulator.formulae
        f = self.formulae
        pd0 = float(f.trivia.p_d(self.p0, self.initial_water_vapour_mixing_ratio))
        rhod0 = float(f.state_variable_triplet.rhod_of_pd_T(pd0, self.T0))
        thd0 = float(f.trivia.th_std(pd0, self.T0))
        dv0 = float(f.trivia.volume_of_density_mass(rhod0, self.mass_of_dry_air))
        builder.particulator.mesh = Mesh.mesh_0d(dv0)
        builder.particulator.dt = self.dt
        builder.particulator.environment = self

        qv0 = self.initial_water_vapour_mixing_ratio
        T, p, RH, air_density, air_viscosity = (
            float(x) for x in recalc_thermo(f, thd0, qv0, rhod0)
        )
        self._initial = {
            "thd": thd0, "qv": qv0, "rhod": rhod0, "z": self.z0,
            "T": T, "p": p, "RH": RH,
            "air_density": air_density, "air_viscosity": air_viscosity,
        }

    def __getitem__(self, key):
        """host access for initialisation (pre-build values; post-build
        reads go through ``particulator.get_env``)"""
        if self.particulator is not None and self.particulator.sim_state:
            return (
                self.particulator.sim_state["env"][key].cpu().numpy().reshape(1)
            )
        return np.asarray([self._initial[key]])

    def init_env_state(self, dtype, device):
        def one(value):
            return torch.full((1,), value, dtype=dtype, device=device)

        i = self._initial
        return {
            "thd": one(i["thd"]), "qv": one(i["qv"]), "rhod": one(i["rhod"]),
            "z": one(self.z0),
            "t": torch.zeros((), dtype=dtype, device=device),
            "T": one(i["T"]), "p": one(i["p"]), "RH": one(i["RH"]),
            "air_density": one(i["air_density"]),
            "air_viscosity": one(i["air_viscosity"]),
            "pred_thd": one(i["thd"]), "pred_qv": one(i["qv"]),
            "pred_rhod": one(i["rhod"]),
            "delta_qv_cond": one(0.0),
            "dv": one(float(self.formulae.trivia.volume_of_density_mass(
                i["rhod"], self.mass_of_dry_air
            ))),
            "m_d": one(self.mass_of_dry_air),
        }

    @staticmethod
    def init_host_state(env=None):
        """host-side scalars of the sim-state: the parcel's clock, zero at
        the start or read once from ``env["t"]`` of a carried-in state"""
        return {"t": 0.0 if env is None else float(np.asarray(env["t"]))}

    def make_sync_step(self, particulator):
        """reference ``Parcel.sync`` = sync_parcel_vars + advance_parcel_vars
        + Moist.sync: hydrostatic rhod/z advance at mid-point w, predicted
        T/p/RH recomputed from (pred_rhod, thd, qv)"""
        f = particulator.formulae
        dt = self.dt
        w = self.w
        m_d = self.mass_of_dry_air

        def sync(sim):
            env = dict(sim["env"])
            host = dict(sim["host"])
            dz_dt = float(w(host["t"] + dt / 2))
            delta_liquid = env["delta_qv_cond"]
            qv_mid = env["qv"] - delta_liquid / 2
            lv = f.latent_heat_vapourisation.lv(env["T"])
            if dz_dt != 0:
                dql_dz = delta_liquid / dz_dt / dt
            else:
                dql_dz = torch.zeros_like(delta_liquid)
            drho_dz = f.hydrostatics.drho_dz(
                p=env["p"], T=env["T"],
                water_vapour_mixing_ratio=qv_mid, lv=lv,
                d_liquid_water_mixing_ratio__dz=dql_dz,
            )
            env["z"] = env["z"] + dt * dz_dt
            env["pred_rhod"] = env["rhod"] + dt * dz_dt * drho_dz
            env["t"] = env["t"] + dt
            host["t"] = host["t"] + dt
            env["dv"] = f.trivia.volume_of_density_mass(
                (env["pred_rhod"] + env["rhod"]) / 2, m_d
            )
            env["pred_thd"] = env["thd"]
            env["pred_qv"] = env["qv"]
            (env["T"], env["p"], env["RH"], env["air_density"],
             env["air_viscosity"]) = recalc_thermo(
                f, env["pred_thd"], env["pred_qv"], env["pred_rhod"]
            )
            return {**sim, "env": env, "host": host}

        return sync

    def make_commit_step(self, particulator):
        def commit(sim):
            return {**sim, "env": moist_commit(sim["env"])}

        return commit

    def init_attributes(
        self, *, n_in_dv, kappa, r_dry, rtol=1e-5,
        include_dry_volume_in_attribute=True,
    ):
        from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii

        r_dry = np.atleast_1d(np.asarray(r_dry, dtype=float))
        n_in_dv = np.atleast_1d(np.asarray(n_in_dv, dtype=float))
        f = self.particulator.formulae
        attributes = {}
        dry_volume = np.asarray(f.trivia.volume(radius=r_dry))
        attributes["kappa times dry volume"] = dry_volume * kappa
        attributes["multiplicity"] = n_in_dv
        r_wet = equilibrate_wet_radii(
            r_dry=r_dry,
            environment=self,
            kappa_times_dry_volume=attributes["kappa times dry volume"],
            rtol=rtol,
        )
        attributes["volume"] = np.asarray(f.trivia.volume(radius=r_wet))
        if include_dry_volume_in_attribute:
            attributes["dry volume"] = dry_volume
        return attributes
