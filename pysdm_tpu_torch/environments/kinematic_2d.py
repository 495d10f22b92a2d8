"""2D single-eddy prescribed-flow environment (port of
``pysdm_tpu/environments/kinematic_2d.py``; reference
``PySDM/environments/kinematic_2d.py``, the Arabas et al. 2015 setup).

thd and the water-vapour mixing ratio are MPDATA advectees; rhod is a fixed
hydrostatic profile. The initial advectee fields live in the MPDATA_2D
solver (the reference's API) and enter the env state at build. Every env
field is a flat tensor of one value per cell, in row-major (x, z) order.
"""

import numpy as np
import torch

from ..impl import arakawa_c
from ..impl.mesh import Mesh
from .impl.moist import moist_commit, recalc_thermo


class Kinematic2D:
    def __init__(self, *, dt, grid, size, rhod_of, mixed_phase=False):
        if mixed_phase:
            raise NotImplementedError(
                "the mixed-phase kinematic grid comes with slice 5"
            )
        self.dt = dt
        self.mesh = Mesh(grid, size)
        self.rhod_of = rhod_of
        self.mixed_phase = mixed_phase
        self.rhod0 = arakawa_c.make_rhod(self.mesh.grid, rhod_of)  # (nx, nz)
        self.particulator = None
        self.formulae = None

    def register(self, builder):
        self.particulator = builder.particulator
        self.formulae = builder.particulator.formulae
        builder.particulator.mesh = self.mesh
        builder.particulator.dt = self.dt
        builder.particulator.environment = self

    @property
    def dv(self):
        return self.mesh.dv

    def _initial_fields(self):
        solver = self.particulator.dynamics["EulerianAdvection"].solvers
        thd0 = np.asarray(solver.advectees["th"], dtype=float).ravel()
        qv0 = np.asarray(
            solver.advectees["water_vapour_mixing_ratio"], dtype=float
        ).ravel()
        return thd0, qv0

    def __getitem__(self, key):
        """host access: the env state after build, the initial fields before
        (wet-radius equilibration)"""
        if self.particulator is not None and self.particulator.sim_state:
            return self.particulator.sim_state["env"][key].cpu().numpy()
        thd0, qv0 = self._initial_fields()
        rhod = self.rhod0.ravel()
        if key == "rhod":
            return rhod
        T, p, RH, air_density, air_viscosity = (
            np.asarray(x) for x in recalc_thermo(self.formulae, thd0, qv0, rhod)
        )
        return {
            "thd": thd0, "qv": qv0, "T": T, "p": p, "RH": RH,
            "air_density": air_density, "air_viscosity": air_viscosity,
        }[key]

    def init_env_state(self, dtype, device):
        thd0, qv0 = self._initial_fields()

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        thd, qv, rhod = tensor(thd0), tensor(qv0), tensor(self.rhod0.ravel())
        T, p, RH, air_density, air_viscosity = recalc_thermo(
            self.formulae, thd, qv, rhod
        )
        nx, nz = self.mesh.grid
        return {
            "thd": thd, "qv": qv, "rhod": rhod,
            "pred_thd": thd, "pred_qv": qv, "pred_rhod": rhod,
            "mpdata_thd": thd, "mpdata_qv": qv,
            "T": T, "p": p, "RH": RH,
            "air_density": air_density, "air_viscosity": air_viscosity,
            "m_d": rhod * self.mesh.dv,
            "delta_qv_cond": torch.zeros_like(qv),
            "courant_0": torch.zeros((nx + 1) * nz, dtype=dtype, device=device),
            "courant_1": torch.zeros(nx * (nz + 1), dtype=dtype, device=device),
            "t": torch.zeros((), dtype=dtype, device=device),
        }

    def make_sync_step(self, particulator):
        f = particulator.formulae

        def sync(sim):
            env = dict(sim["env"])
            env["pred_qv"] = env["mpdata_qv"]
            env["pred_thd"] = env["mpdata_thd"]
            env["pred_rhod"] = env["rhod"]
            (env["T"], env["p"], env["RH"], env["air_density"],
             env["air_viscosity"]) = recalc_thermo(
                f, env["pred_thd"], env["pred_qv"], env["pred_rhod"]
            )
            return {**sim, "env": env}

        return sync

    def make_commit_step(self, particulator):
        dt = self.dt

        def commit(sim):
            env = moist_commit(sim["env"])
            env["t"] = env["t"] + dt
            return {**sim, "env": env}

        return commit

    def init_attributes(
        self,
        *,
        spatial_discretisation,
        kappa,
        dry_radius_spectrum,
        rtol=1e-5,
        n_sd=None,
        spectral_sampling=None,
        seed=None,
    ):
        """positions, dry and wet sizes and multiplicities as host arrays
        (the JAX package's ``init_attributes``, the same numbers for the
        same seed)"""
        from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
        from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity

        f = self.formulae
        spectral_sampling = spectral_sampling or ConstantMultiplicity
        n_sd = n_sd or self.particulator.n_sd
        positions = spatial_discretisation.sample(
            grid=self.mesh.grid,
            n_sd=n_sd,
            seed=seed if seed is not None else f.seed,
        )
        attributes = {}
        (
            attributes["cell id"],
            attributes["cell origin"],
            attributes["position in cell"],
        ) = self.mesh.cellular_attributes(positions)

        r_dry, n_per_kg = spectral_sampling(spectrum=dry_radius_spectrum).sample(
            n_sd=n_sd
        )
        attributes["dry volume"] = np.asarray(f.trivia.volume(radius=r_dry))
        attributes["kappa times dry volume"] = kappa * attributes["dry volume"]
        if kappa == 0:
            r_wet = r_dry
        else:
            r_wet = equilibrate_wet_radii(
                r_dry=r_dry,
                environment=self,
                kappa_times_dry_volume=attributes["kappa times dry volume"],
                rtol=rtol,
                cell_id=attributes["cell id"],
            )
        rhod = self.rhod0.ravel()
        cell_id = attributes["cell id"]
        domain_volume = float(np.prod(np.asarray(self.mesh.size)))
        attributes["multiplicity"] = n_per_kg * rhod[cell_id] * domain_volume
        attributes["water mass"] = np.asarray(
            f.particle_shape_and_density.radius_to_mass(r_wet)
        )
        return attributes
