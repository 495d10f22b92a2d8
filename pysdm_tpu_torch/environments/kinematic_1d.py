"""Single-column prescribed-flow environment (port of
``pysdm_tpu/environments/kinematic_1d.py``; reference
``PySDM/environments/kinematic_1d.py``, the Shipway and Hill 2012 column).

thd and rhod are fixed profiles of z (thd changes only through
condensational heating, it is not advected); the water-vapour mixing ratio
is the MPDATA advectee. Every env field is a tensor of one value per cell.

The column's clock lives on the host, in ``sim["host"]["t"]``, as the
parcel's does: the updraft rho*w(t) is a Python callable that the
``MPDATA_1D`` coupling evaluates there, so a step never reads the device to
learn t. The tensor ``env["t"]`` advances beside it so that ``get_env("t")``
reads it and a state carried to the JAX package has it.
"""

import numpy as np
import torch

from .impl.moist import (
    moist_commit, moist_env_state, moist_sync, recalc_thermo,
)


class Kinematic1D:
    def __init__(
        self, *, dt, mesh, thd_of_z, rhod_of_z, water_vapour_mixing_ratio_of_z, z0=0
    ):
        self.dt = dt
        self.mesh = mesh
        self.z0 = z0
        nz = mesh.grid[-1]
        z_centres = z0 + mesh.dz * (np.arange(nz) + 0.5)
        self.thd0 = np.asarray(thd_of_z(z_centres), dtype=float)
        self.rhod0 = np.asarray(rhod_of_z(z_centres), dtype=float)
        self.qv0 = np.asarray(water_vapour_mixing_ratio_of_z(z_centres), dtype=float)
        self.particulator = None
        self.formulae = None
        self._initial = {}

    def register(self, builder):
        self.particulator = builder.particulator
        self.formulae = builder.particulator.formulae
        builder.particulator.mesh = self.mesh
        builder.particulator.dt = self.dt
        builder.particulator.environment = self
        T, p, RH, air_density, air_viscosity = (
            np.asarray(x)
            for x in recalc_thermo(self.formulae, self.thd0, self.qv0, self.rhod0)
        )
        self._initial = {
            "thd": self.thd0, "rhod": self.rhod0, "qv": self.qv0,
            "T": T, "p": p, "RH": RH,
            "air_density": air_density, "air_viscosity": air_viscosity,
        }

    @property
    def dv(self):
        return self.mesh.dv

    def __getitem__(self, key):
        """host access: the env state after build, the initial profiles
        before (wet-radius equilibration)"""
        if self.particulator is not None and self.particulator.sim_state:
            return self.particulator.sim_state["env"][key].cpu().numpy()
        return self._initial[key]

    def init_env_state(self, dtype, device):
        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        nz = self.mesh.grid[-1]
        return moist_env_state(
            self.formulae, tensor(self.thd0), tensor(self.qv0),
            tensor(self.rhod0), self.mesh.dv,
            courant_0=torch.zeros(nz + 1, dtype=dtype, device=device),
        )

    @staticmethod
    def init_host_state(env=None):
        """host-side scalars of the sim-state: the column's clock, zero at
        the start or read once from ``env["t"]`` of a carried-in state"""
        return {"t": 0.0 if env is None else float(np.asarray(env["t"]))}

    def make_sync_step(self, particulator):
        f = particulator.formulae

        def sync(sim):
            return {**sim, "env": moist_sync(f, sim["env"])}

        return sync

    def make_commit_step(self, particulator):
        dt = self.dt

        def commit(sim):
            env = moist_commit(sim["env"])
            env["t"] = env["t"] + dt
            host = dict(sim["host"])
            host["t"] = host["t"] + dt
            return {**sim, "env": env, "host": host}

        return commit

    def init_attributes(
        self,
        *,
        spatial_discretisation,
        spectral_discretisation,
        kappa,
        z_part=None,
        collisions_only=False,
        seed=None,
    ):
        """positions, sizes and multiplicities as host arrays (the JAX
        package's ``init_attributes``, the same numbers for the same seed):
        pseudo-random positions, the per-kg spectrum's multiplicity times
        rhod(cell) times the domain volume, wet radii equilibrated unless
        ``collisions_only``"""
        f = self.formulae
        n_sd = self.particulator.n_sd
        positions = spatial_discretisation.sample(
            grid=self.mesh.grid,
            n_sd=n_sd,
            z_part=z_part,
            seed=seed if seed is not None else f.seed,
        )
        attributes = {}
        (
            attributes["cell id"],
            attributes["cell origin"],
            attributes["position in cell"],
        ) = self.mesh.cellular_attributes(positions)

        if collisions_only:
            v_wet, n_per_kg = spectral_discretisation.sample(n_sd=n_sd)
            attributes["volume"] = v_wet
        else:
            from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii

            r_dry, n_per_kg = spectral_discretisation.sample(n_sd=n_sd)
            attributes["dry volume"] = np.asarray(f.trivia.volume(radius=r_dry))
            attributes["kappa times dry volume"] = attributes["dry volume"] * kappa
            r_wet = equilibrate_wet_radii(
                r_dry=r_dry,
                environment=self,
                cell_id=attributes["cell id"],
                kappa_times_dry_volume=attributes["kappa times dry volume"],
            )
            attributes["volume"] = np.asarray(f.trivia.volume(radius=r_wet))

        cell_id = attributes["cell id"]
        domain_volume = float(np.prod(np.asarray(self.mesh.size)))
        attributes["multiplicity"] = n_per_kg * self.rhod0[cell_id] * domain_volume
        return attributes
