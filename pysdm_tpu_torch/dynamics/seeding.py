"""Seeding dynamic (port of ``pysdm_tpu/dynamics/seeding.py``; reference
``PySDM/dynamics/seeding.py`` + ``backends/impl_numba/methods/
seeding_methods.py``): time-dependent injection of super-particles into
multiplicity-0 (grave) slots. The simulation must be built with enough
NaN-multiplicity particles (discretised to zeros) to hold the injections.

The injection-rate callable runs on the host, at the environment's host
clock (``sim["host"]["t"]``, the parcel's; 0 where the environment keeps
none), so a step reads nothing back from the device. The free slots come
first in a stable sort, the count to place is masked on the device by the
number of free slots, and the seeds are a permutation of the pool drawn
from ``particulator.device_rng``. A step that injects nothing does no
device work.
"""

import numpy as np
import torch

from ..impl.attributes import canonical_ext_name
from ..initialisation.discretise_multiplicities import discretise_multiplicities


class Seeding:
    # injecting particles into grave slots breaks cell-sorted order
    breaks_cell_sort = True

    def __init__(
        self,
        *,
        super_droplet_injection_rate: callable,
        seeded_particle_extensive_attributes: dict,
        seeded_particle_multiplicity,
    ):
        self.particulator = None
        self.super_droplet_injection_rate = super_droplet_injection_rate
        self.seeded_particle_extensive_attributes = (
            seeded_particle_extensive_attributes
        )
        self.seeded_particle_multiplicity = np.asarray(
            seeded_particle_multiplicity
        )

    def register(self, builder):
        self.particulator = builder.particulator
        for name in self.seeded_particle_extensive_attributes:
            builder.request_attribute(name)

    def make_step(self, particulator):
        rate_fn = self.super_droplet_injection_rate
        device = particulator.device
        seed_mult = torch.as_tensor(
            discretise_multiplicities(self.seeded_particle_multiplicity),
            dtype=particulator.mult_dtype, device=device,
        )
        ext_names = particulator.sim_state["particles"].ext_names
        seed_ext = torch.as_tensor(
            np.stack([
                np.asarray(
                    self.seeded_particle_extensive_attributes[
                        _orig_name(name, self.seeded_particle_extensive_attributes)
                    ],
                    dtype=float,
                )
                for name in ext_names
            ]),
            dtype=particulator.dtype, device=device,
        )
        n_pool = seed_mult.shape[0]

        def step(sim):
            n_inject = int(np.asarray(rate_fn(sim["host"].get("t", 0.0))))
            if n_inject <= 0:
                return sim
            particles = sim["particles"]
            perm = torch.randperm(
                n_pool, generator=particulator.device_rng, device=device
            )
            mult = particles.multiplicity
            free = mult <= 0
            # free slots first, each group in slot order
            free_order = torch.argsort((~free).to(torch.uint8), stable=True)
            slots = free_order[:n_pool]
            k = slots.shape[0]
            rank = torch.arange(k, device=device)
            ok = (rank < n_inject) & (rank < free.sum())
            src = perm[:k]
            mult = mult.clone()
            mult[slots] = torch.where(ok, seed_mult[src], mult[slots])
            ext = particles.extensive.clone()
            ext[:, slots] = torch.where(ok, seed_ext[:, src], ext[:, slots])
            particles = particles.replace(multiplicity=mult, extensive=ext)
            return {**sim, "particles": particles}

        return step


def _orig_name(canonical, mapping):
    """the user-supplied key of a canonical extensive name"""
    for k in mapping:
        if canonical_ext_name(k) == canonical:
            return k
    raise KeyError(
        f"seeded_particle_extensive_attributes missing {canonical!r}"
        f" (got {list(mapping)})"
    )
