"""Particle state: a fixed-size structure of tensors (port of
``pysdm_tpu/impl/state.py``).

There is no permutation index and no compaction: particle death is
multiplicity 0, masked out of every reduction. The port keeps the JAX
package's layout (extensive rows ``(n_ext, n_sd)``, the spatial rows
``(n_dims, n_sd)``) so that states cross between the two packages as NumPy
arrays (``from_numpy`` / ``to_numpy``).
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ParticleState:
    multiplicity: torch.Tensor  # (n_sd,) int64
    extensive: torch.Tensor  # (n_ext, n_sd) float, conserved under coalescence
    cell_id: torch.Tensor  # (n_sd,) int32
    cell_origin: torch.Tensor  # (n_dims, n_sd) int32, (0, n_sd) for 0D
    position_in_cell: torch.Tensor  # (n_dims, n_sd) float, (0, n_sd) for 0D
    ext_names: tuple = ()

    @property
    def n_sd(self):
        return self.multiplicity.shape[0]

    @property
    def alive(self):
        return self.multiplicity > 0

    def ext(self, name):
        return self.extensive[self.ext_names.index(name)]

    def has_ext(self, name):
        return name in self.ext_names

    def set_ext(self, name, value):
        """a copy with extensive row ``name`` replaced by ``value``"""
        extensive = self.extensive.clone()
        extensive[self.ext_names.index(name)] = value
        return self.replace(extensive=extensive)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_numpy(
        cls, *, multiplicity, extensive, ext_names, cell_id=None,
        cell_origin=None, position_in_cell=None, dtype=torch.float64,
        mult_dtype=torch.int64, device="cpu",
    ):
        """build a state from host arrays, e.g. ``np.asarray`` of the JAX
        package's ``ParticleState`` fields"""
        # copies: the arrays may be read-only views of another package's
        # buffers
        multiplicity = np.array(multiplicity)
        n_sd = multiplicity.shape[0]
        extensive = np.array(extensive).reshape(len(ext_names), n_sd)
        if cell_id is None:
            cell_id = np.zeros(n_sd, np.int32)
        if cell_origin is None:
            cell_origin = np.zeros((0, n_sd), np.int32)
        if position_in_cell is None:
            position_in_cell = np.zeros((0, n_sd))
        return cls(
            multiplicity=torch.as_tensor(
                multiplicity, dtype=mult_dtype, device=device
            ),
            extensive=torch.as_tensor(extensive, dtype=dtype, device=device),
            cell_id=torch.as_tensor(
                np.array(cell_id), dtype=torch.int32, device=device
            ),
            cell_origin=torch.as_tensor(
                np.array(cell_origin), dtype=torch.int32, device=device
            ),
            position_in_cell=torch.as_tensor(
                np.array(position_in_cell), dtype=dtype, device=device
            ),
            ext_names=tuple(ext_names),
        )

    def to_numpy(self):
        """host copies of every field, keyed as ``from_numpy`` takes them"""
        return {
            "multiplicity": self.multiplicity.cpu().numpy(),
            "extensive": self.extensive.cpu().numpy(),
            "ext_names": self.ext_names,
            "cell_id": self.cell_id.cpu().numpy(),
            "cell_origin": self.cell_origin.cpu().numpy(),
            "position_in_cell": self.position_in_cell.cpu().numpy(),
        }


def sim_state_from_numpy(sim, particulator):
    """the port's sim-state from the JAX package's whole ``sim_state`` as
    host arrays (e.g. ``jax.device_get(jax_particulator.sim_state)``):
    particles, env, counters and flags, on the particulator's device, with
    its float dtype for particles and env and each counter in the dtype the
    port registered it with (the JAX package's dtype for a counter the port
    has not registered); the environment's host-side scalars are read from
    the env, and the injected u01 rows, if any, stay the port's."""
    dtype, device = particulator.dtype, particulator.device
    counters = particulator.sim_state["counters"]
    particles = sim["particles"]
    state = {
        "particles": ParticleState.from_numpy(
            multiplicity=particles.multiplicity,
            extensive=particles.extensive,
            ext_names=particles.ext_names,
            cell_id=particles.cell_id,
            cell_origin=particles.cell_origin,
            position_in_cell=particles.position_in_cell,
            dtype=dtype,
            mult_dtype=particulator.mult_dtype,
            device=device,
        ),
        "env": {
            name: torch.as_tensor(np.array(value), dtype=dtype, device=device)
            for name, value in sim["env"].items()
        },
        "counters": {
            name: torch.as_tensor(
                np.array(value),
                dtype=counters[name].dtype if name in counters else None,
                device=device,
            )
            for name, value in sim["counters"].items()
        },
        "flags": {name: bool(value) for name, value in sim["flags"].items()},
    }
    if "u01" in particulator.sim_state:
        state["u01"] = particulator.sim_state["u01"]
    init_host_state = getattr(particulator.environment, "init_host_state", None)
    state["host"] = init_host_state(sim["env"]) if init_host_state else {}
    return state
