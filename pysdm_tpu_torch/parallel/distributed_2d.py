"""The 2D kinematic warm rain decomposed over ranks (port of
``pysdm_tpu/parallel/distributed_2d.py``).

The (x, z) domain is cut into x-slabs, or (x, z) tiles, one per rank of
the default process group (``multihost.initialize``). Eulerian fields
advect by MPDATA with ring halo exchanges (``halo.py``); super-droplets
belong to their slab and migrate through fixed-capacity buffers after
displacement (``migration.py``); condensation and collision are
cell-local and exchange nothing. Each rank runs the ordinary composed
step of its own particulator, built by the standard Builder against its
tile's mesh; where the JAX package wraps that step in ``shard_map``, here
every rank runs it in its own process, and the collectives inside it come
in the same order on every rank. The one global decision of a step is
displacement's substep count.

Rank r holds tile (r // sz, r % sz) of an (sx, sz) mesh, the JAX
package's shard order. Every rank samples the global initial attributes
on the host from the settings' seed, as every JAX process does, and keeps
its own block; its generators are seeded from (seed, rank).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..backends import CPU, GPU
from ..builder import Builder
from ..dynamics import (
    AmbientThermodynamics,
    Coalescence,
    Condensation,
    Displacement,
    EulerianAdvection,
)
from ..dynamics.eulerian_advection import MPDATA_2D
from ..environments.kinematic_2d import Kinematic2D
from ..initialisation.sampling.spatial_sampling import Pseudorandom
from ..ops.mpdata import PERIODIC, mpdata_step
from . import multihost


class DistributedMPDATA_2D(MPDATA_2D):
    """MPDATA_2D on one tile: the advector, built once for the global
    grid, is sliced to the tile, and a decomposed axis pads by ring halo
    exchange over its group (``groups``: the x ring's and, with z tiles,
    the z ring's)"""

    def __init__(self, *, tile, shards, groups, **kwargs):
        super().__init__(**kwargs)
        self.tile = tuple(tile)
        self.shards = tuple(shards)
        group_x, group_z = groups
        self.opts["bcs"] = (
            ("shard", group_x),
            ("shard", group_z) if self.shards[1] > 1 else PERIODIC,
        )

    def _tile_origin(self, x_idx, z_idx):
        nxl, nzl = (n // s for n, s in zip(self.grid, self.shards))
        return x_idx * nxl, z_idx * nzl, nxl, nzl

    def local_gc(self, x_idx, z_idx):
        """the tile's slices of the global advector: the x faces
        (nxl + 1, nzl) overlap between x neighbours, the z faces
        (nxl, nzl + 1) between z neighbours"""
        return self._local_faces(self.gc, x_idx, z_idx)

    def _local_faces(self, faces, x_idx, z_idx):
        x0, z0, nxl, nzl = self._tile_origin(x_idx, z_idx)
        return (
            faces[0][x0:x0 + nxl + 1, z0:z0 + nzl],
            faces[1][x0:x0 + nxl, z0:z0 + nzl + 1],
        )

    def make_step(self, particulator):
        x0, z0, nxl, nzl = self._tile_origin(*self.tile)
        opts = self.opts

        def tensor(a):
            return torch.as_tensor(
                np.ascontiguousarray(a), dtype=particulator.dtype,
                device=particulator.device,
            )

        gc = tuple(tensor(c) for c in self.local_gc(*self.tile))
        g = tensor(self.g_factor[x0:x0 + nxl, z0:z0 + nzl])
        courant = tuple(
            tensor(c).reshape(-1)
            for c in self._local_faces(self.courant, *self.tile)
        )

        def step(sim):
            env = dict(sim["env"])
            for name in ("thd", "qv"):
                env[f"mpdata_{name}"] = mpdata_step(
                    env[f"pred_{name}"].reshape(nxl, nzl), gc, g, **opts
                ).reshape(-1)
            env["courant_0"], env["courant_1"] = courant
            return {**sim, "env": env}

        return step


def _assign_particles_to_shards(
    attributes, n_shards, nx_local, capacity, nz_local=None, sz=1
):
    """the globally sampled particles as per-tile blocks of ``capacity``
    slots, cell origins made tile-local (shard = x_tile * sz + z_tile);
    dead padding gets multiplicity 0, dry volumes of 1e-25 (derived
    attributes stay finite) and water mass 0 (inert in the implicit
    solve)"""
    cell_origin = np.asarray(attributes["cell origin"])
    shard_of = (cell_origin[0] // nx_local) * sz
    if sz > 1:
        shard_of = shard_of + cell_origin[1] // nz_local
    out = {k: [] for k in attributes}
    for s in range(n_shards):
        sel = np.nonzero(shard_of == s)[0]
        if len(sel) > capacity:
            raise ValueError(
                f"shard {s}: {len(sel)} particles > capacity {capacity}"
            )
        pad = capacity - len(sel)
        for key, value in attributes.items():
            v = np.asarray(value)
            taken = v[..., sel]
            if key in ("dry volume", "kappa times dry volume"):
                filler = np.full((pad,), 1e-25)
            else:
                filler = np.zeros(taken.shape[:-1] + (pad,), dtype=v.dtype)
            if key == "cell origin":
                taken = taken.copy()
                taken[0] -= (s // sz) * nx_local
                if sz > 1:
                    taken[1] -= (s % sz) * nz_local
            out[key].append(np.concatenate([taken, filler], axis=-1))
    return {k: np.concatenate(v, axis=-1) for k, v in out.items()}


class _Precomputed:
    """spatial sampling that returns positions sampled beforehand"""

    def __init__(self, positions):
        self.positions = positions

    def sample(self, **_):
        return self.positions


def _rank_seed(seed, rank):
    """a generator seed of its own for each rank, from (seed, rank)"""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _ring_groups(sx, sz):
    """the x ring of every z index and, with z tiles, the z ring of every x
    index; every rank creates every group, in the same order"""
    x_rings = [
        dist.new_group([i * sz + j for i in range(sx)]) for j in range(sz)
    ]
    z_rings = [
        dist.new_group([i * sz + j for j in range(sz)]) for i in range(sx)
    ] if sz > 1 else None
    return x_rings, z_rings


class DistributedSimulation2D:
    """the Arabas-2015-style 2D warm rain decomposed over the ranks of the
    default process group. ``n_shards`` (default: the world size) x-slabs,
    or ``mesh_shape`` (x, z) tiles, one per rank. Every accessor but
    ``run`` and ``particulator`` is a collective: every rank calls it."""

    def __init__(
        self,
        settings,
        *,
        n_shards=None,
        mesh_shape=None,
        backend_class=GPU,
        capacity_factor=2.0,
        migration_capacity=None,
        migration_overlap=True,
    ):
        world = dist.get_world_size()
        rank = dist.get_rank()
        if mesh_shape is not None:
            sx, sz = mesh_shape
            n_shards = sx * sz
        else:
            n_shards = n_shards or world
            sx, sz = n_shards, 1
        if n_shards != world:
            raise ValueError(f"{n_shards} shards over {world} ranks")
        nx, nz = settings.grid
        if nx % sx or nz % sz:
            raise ValueError(f"grid {settings.grid} over tiles {(sx, sz)}")
        nxl, nzl = nx // sx, nz // sz
        self.settings = settings
        self.n_shards = n_shards
        self.mesh_shape = (sx, sz)
        self.rank = rank
        self.tile = (rank // sz, rank % sz)
        self.n_cell_local = nxl * nzl
        x_rings, z_rings = _ring_groups(sx, sz)
        self.group_x = x_rings[self.tile[1]]
        self.group_z = z_rings[self.tile[0]] if z_rings else None

        n_sd_global = settings.n_sd
        capacity = int(capacity_factor * n_sd_global / n_shards)
        migration_capacity = migration_capacity or max(64, capacity // 8)

        # ---- this tile's particulator ---------------------------------
        backend = backend_class(formulae=settings.formulae)
        environment = Kinematic2D(
            dt=settings.dt,
            grid=(nxl, nzl),
            size=(settings.size[0] / sx, settings.size[1] / sz),
            rhod_of=settings.rhod_of_zZ,
        )
        builder = Builder(n_sd=capacity, backend=backend, environment=environment)
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation(adaptive=settings.condensation_adaptive))
        x0, z0 = self.tile[0] * nxl, self.tile[1] * nzl
        advectees = {
            "th": np.repeat(
                settings.initial_dry_potential_temperature_profile[z0:z0 + nzl]
                .reshape(1, -1), nxl, axis=0,
            ),
            "water_vapour_mixing_ratio": np.repeat(
                settings.initial_vapour_mixing_ratio_profile[z0:z0 + nzl]
                .reshape(1, -1), nxl, axis=0,
            ),
        }
        solver = DistributedMPDATA_2D(
            tile=self.tile,
            shards=(sx, sz),
            groups=(self.group_x, self.group_z),
            advectees=advectees,
            stream_function=settings.stream_function,
            rhod_of_zZ=settings.rhod_of_zZ,
            dt=settings.dt,
            grid=settings.grid,  # global: the advector is sliced per tile
            size=settings.size,
            n_iters=settings.mpdata_iters,
            infinite_gauge=settings.mpdata_iga,
            nonoscillatory=settings.mpdata_fct,
        )
        builder.add_dynamic(EulerianAdvection(solver))
        builder.add_dynamic(
            Displacement(
                enable_sedimentation=True,
                distributed_x=dict(
                    group=self.group_x,
                    capacity=migration_capacity,
                    overlap=migration_overlap,
                    group_z=self.group_z,
                    z_shards=sz,
                ),
            )
        )
        builder.add_dynamic(
            Coalescence(
                collision_kernel=settings.kernel,
                adaptive=settings.coalescence_adaptive,
            )
        )

        # ---- the global initial attributes, this rank's block ---------
        seed = settings.formulae.seed
        positions = Pseudorandom.sample(
            grid=settings.grid, n_sd=n_sd_global, seed=seed
        )
        global_env = Kinematic2D(
            dt=settings.dt, grid=settings.grid, size=settings.size,
            rhod_of=settings.rhod_of_zZ,
        )
        global_env.particulator = builder.particulator
        global_env.formulae = settings.formulae
        thd_glob = np.repeat(
            settings.initial_dry_potential_temperature_profile.reshape(1, -1),
            nx, axis=0,
        ).ravel()
        qv_glob = np.repeat(
            settings.initial_vapour_mixing_ratio_profile.reshape(1, -1),
            nx, axis=0,
        ).ravel()
        global_env._initial_fields = lambda: (thd_glob, qv_glob)
        global_attrs = global_env.init_attributes(
            spatial_discretisation=_Precomputed(positions),
            dry_radius_spectrum=settings.spectrum_per_mass_of_dry_air,
            kappa=settings.kappa,
            n_sd=n_sd_global,
            seed=seed,
        )
        own = multihost.host_replicated_to_local(
            _assign_particles_to_shards(
                global_attrs, n_shards, nxl, capacity, nz_local=nzl, sz=sz
            ),
            rank, n_shards,
        )
        self.particulator = builder.build(
            self._sorted_block(own, environment.mesh.strides.ravel())
        )
        p = self.particulator

        # z tiles start from other profiles than tile (0, 0): every cell
        # field of the env is the global field's tile (face fields are
        # written by the advection step before displacement reads them)
        genv = global_env.init_env_state(p.dtype, p.device)
        env = p.sim_state["env"]
        for key, value in genv.items():
            if value.dim() == 1 and value.shape[0] == nx * nz:
                env[key] = value.reshape(nx, nz)[
                    x0:x0 + nxl, z0:z0 + nzl
                ].reshape(-1).clone()
        p.rng.manual_seed(_rank_seed(seed, rank))
        p.device_rng.manual_seed(_rank_seed(seed, rank))

    def _sorted_block(self, block, local_strides):
        """the rank's block with tile-local cell ids, sorted stably by cell
        with dead padding last and at cell ``n_cell_local - 1`` (the
        sorted state the shared-sort analysis may assume: searchsorted on
        a cell-id row out of order gives wrong segment starts)"""
        mult = np.asarray(block["multiplicity"]).round().astype(np.int64)
        alive = mult > 0
        cell_id = (
            local_strides[:, None] * np.asarray(block["cell origin"])
        ).sum(axis=0)
        order = np.argsort(
            np.where(alive, cell_id, self.n_cell_local), kind="stable"
        )
        out = {
            key: np.asarray(value)[..., order]
            for key, value in block.items()
            if key not in ("multiplicity", "cell id")
        }
        out["multiplicity"] = mult[order]
        out["cell id"] = np.where(
            alive, cell_id, self.n_cell_local - 1
        )[order].astype(np.int32)
        return out

    # ---- collectives -------------------------------------------------
    def _gather(self, tensor):
        """every rank's ``tensor`` (one shape on all ranks), in rank order"""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.n_shards)]
        dist.all_gather(parts, tensor)
        return parts

    def run(self, steps):
        self.particulator.run(steps)

    def get_env(self, key):
        """the global field (nx, nz) from every tile's block; a field that
        is not one value per cell comes back stacked by rank"""
        parts = [
            x.cpu().numpy()
            for x in self._gather(self.particulator.sim_state["env"][key])
        ]
        if parts[0].ndim != 1 or parts[0].size != self.n_cell_local:
            return np.stack(parts)
        sx, sz = self.mesh_shape
        nx, nz = self.settings.grid
        return (
            np.stack(parts).reshape(sx, sz, nx // sx, nz // sz)
            .transpose(0, 2, 1, 3).reshape(nx, nz)
        )

    def get_counter(self, name):
        """every rank's counter, concatenated in rank order (the JAX
        package's global counter)"""
        counter = self.particulator.sim_state["counters"][name]
        return torch.cat(self._gather(counter)).cpu().numpy()

    @property
    def attributes(self):
        """the global attributes, every rank's slots in rank order"""
        return _GatheredAttributes(self)

    def global_diagnostics(self):
        """global scalars from one ``all_reduce``, the same on every rank:
        the water budget (vapour + liquid + precipitated = the conserved
        total), the alive count, the dropped migrations and whether every
        rank's condensation succeeded"""
        p = self.particulator
        env = p.sim_state["env"]
        counters = p.sim_state["counters"]
        parts = p.particles
        sums = torch.stack([
            (env["rhod"].double() * env["qv"].double()).sum() * p.mesh.dv,
            (
                parts.multiplicity.double()
                * parts.ext("signed water mass").double().abs()
            ).sum(),
            counters["precipitated_mass"].double().sum(),
            (parts.multiplicity > 0).sum().double(),
            counters["migration_dropped"].sum().double(),
            (~counters["condensation_success"]).sum().double(),
        ])
        dist.all_reduce(sums)
        vapour, liquid, precip, n_alive, dropped, failed = sums.tolist()
        return {
            "water_vapour": vapour,
            "water_liquid": liquid,
            "water_precipitated": precip,
            "water_total": vapour + liquid + precip,
            "n_alive": n_alive,
            "migration_dropped": dropped,
            "condensation_ok": float(failed == 0),
        }

    def global_cell_id(self):
        """every rank's cell ids in global flat (x-major) coordinates,
        concatenated in rank order"""
        sx, sz = self.mesh_shape
        nx, nz = self.settings.grid
        nxl, nzl = nx // sx, nz // sz
        local = self.particulator.particles.cell_id.to(torch.int64)
        out = []
        for rank, cells in enumerate(self._gather(local)):
            gx = (rank // sz) * nxl + cells // nzl
            gz = (rank % sz) * nzl + cells % nzl
            out.append(gx * nz + gz)
        return torch.cat(out).cpu().numpy()


class _GatheredAttributes:
    """``sim.attributes[name]``: every rank's attribute in rank order (a
    collective)"""

    def __init__(self, sim):
        self._sim = sim

    def __getitem__(self, name):
        local = self._sim.particulator.get_attribute(name)
        return torch.cat(self._sim._gather(local), dim=-1).cpu().numpy()


def _dryrun_rank(backend_class):
    """one rank of ``dryrun_multichip``: one full step (collisions and
    sedimentation on) of a 4-cell-per-rank-wide warm rain; returns the
    diagnostics before and after"""
    from ..models.arabas_et_al_2015 import Settings
    from ..physics import Formulae

    n = dist.get_world_size()
    settings = Settings(
        Formulae(seed=44), grid=(max(32, 4 * n), 16),
        size=(1500.0, 1500.0), n_sd_per_gridbox=8,
    )
    sim = DistributedSimulation2D(settings, backend_class=backend_class)
    before = sim.global_diagnostics()
    sim.run(1)
    after = sim.global_diagnostics()
    mult = sim.particulator.particles.multiplicity
    return {"before": before, "after": after,
            "mult_nonnegative": bool((mult >= 0).all())}


def dryrun_multichip(n_ranks, backend_class=GPU, timeout=600.0):
    """one full step of the decomposed warm rain over ``n_ranks`` spawned
    ranks (NCCL where each has a GPU of its own, else gloo; ``CPU`` runs
    them on the CPU): condensation succeeds everywhere, multiplicities stay
    >= 0, nothing is dropped and the water budget closes to 1e-3. Returns
    rank 0's diagnostics."""
    device = "cpu" if backend_class is CPU else "cuda"
    results = multihost.spawn(
        _dryrun_rank, n_ranks, backend_class,
        backend=multihost.backend_for(n_ranks, device), timeout=timeout,
    )
    for out in results:
        before, after = out["before"], out["after"]
        if not (
            out["mult_nonnegative"] and after["condensation_ok"] == 1.0
            and after["migration_dropped"] == 0.0
            and abs(after["water_total"] / before["water_total"] - 1) < 1e-3
            and after == results[0]["after"]
        ):
            raise AssertionError(f"dryrun over {n_ranks} ranks: {out}")
    return results[0]
