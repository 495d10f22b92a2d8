"""Displacement dynamic: particle advection by the flow and sedimentation
(port of ``pysdm_tpu/dynamics/displacement.py``; reference
``PySDM/dynamics/displacement.py``).

The adaptive substep count (reference ``upload_courant_field``: the
smallest power of two n with (d/n)/(1 - d/n) < rtol, d the largest courant
difference between neighbouring faces, Arabas et al. 2015 eqs. 13-16) is
decided on the host: one device read per step, counted in ``host_reads``.
Courant fields come from the env state (``courant_0..courant_{D-1}``),
written there by the EulerianAdvection dynamic.

With ``distributed_x`` the grid is one rank's slab (or tile) of a
decomposed domain (``parallel/distributed_2d.py``): the courant fields get
halos from the ring neighbours, the substep count is the largest over all
ranks (an ``all_reduce(MAX)`` before the host reads it, the one global
decision of the step), the decomposed axes stay unwrapped through the
substeps, and the particles that left the slab migrate to the neighbour
(``parallel/migration.py``). With ``overlap`` the exchange is started here
and committed by ``make_commit_step``'s step after the last physics
dynamic, so that collision runs while it is in flight.

``substeps_run`` counts the substeps. Spans (while a profiler records,
``utils/profiling.py``): ``Displacement.prepare`` (the courant fields, the
fall velocity), inside it ``Displacement.read`` (the substep count),
``Displacement.substep`` (each substep) and ``Displacement.commit`` (the
counters, the new cell ids, and decomposed the migration).
"""

from collections import namedtuple

import torch
import torch.distributed as dist

from ..ops import displacement as disp_ops
from ..utils.profiling import span

DEFAULTS = namedtuple("_", ("rtol", "adaptive"))(rtol=1e-2, adaptive=True)


def _particle_arrays(particles, multiplicity, cell_origin, position_in_cell):
    """the per-particle rows migration carries, multiplicity first"""
    return [
        multiplicity, particles.extensive, particles.maximum, cell_origin,
        position_in_cell,
    ]


def _with_arrays(particles, arrays, strides):
    multiplicity, extensive, maximum, cell_origin, position_in_cell = arrays
    return particles.replace(
        multiplicity=multiplicity,
        extensive=extensive,
        maximum=maximum,
        cell_origin=cell_origin,
        position_in_cell=position_in_cell,
        cell_id=disp_ops.recalculate_cell_id(cell_origin, strides),
    )


def _migrate_z_phase(arrays, distributed, nz_local):
    """second exchange of a 2D (x, z) tile decomposition: classify the
    still-unwrapped z origin, wrap it tile-local and migrate along the z
    ring (diagonal movers hop x first, then z)"""
    from ..parallel import migration

    multiplicity, cell_origin = arrays[0], arrays[3]
    dest_z, far_z = migration.classify_dest_shift(
        cell_origin[-1], nz_local, multiplicity
    )
    cell_origin = cell_origin.clone()
    cell_origin[-1] = torch.remainder(cell_origin[-1], nz_local)
    arrays = [torch.where(far_z, 0, multiplicity), *arrays[1:3], cell_origin,
              arrays[4]]
    return migration.migrate_ring(
        arrays=arrays,
        multiplicity_index=0,
        dest_shift=dest_z,
        group=distributed["group_z"],
        capacity=distributed["capacity"],
        rounds=distributed.get("rounds", 2),
    )


class Displacement:
    # moving particles between cells breaks the cell-sorted state the
    # builder's shared sort tracks
    breaks_cell_sort = True
    # the host counters ``Particulator.counts`` gives
    COUNTERS = ("host_reads", "substeps_run")

    def __init__(
        self,
        enable_sedimentation=False,
        precipitation_counting_level_index: int = 0,
        adaptive=DEFAULTS.adaptive,
        rtol=DEFAULTS.rtol,
        distributed_x: dict = None,
    ):
        """``distributed_x`` (decomposed mode): dict(group=<the x ring's
        process group, None for the default group>, capacity=<migrations per step and direction>,
        overlap=<start the exchange here, commit it after the physics>
        (default True), rounds=<exchange rounds> (default 2), and on a tile
        decomposition group_z=<the z ring's group>, z_shards=<its size>)"""
        self.particulator = None
        self.enable_sedimentation = enable_sedimentation
        self.precipitation_counting_level_index = precipitation_counting_level_index
        self.adaptive = adaptive
        self.rtol = rtol
        self.distributed_x = distributed_x
        self.host_reads = 0
        self.substeps_run = 0

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("relative fall velocity")
        builder.add_flag("sedimentation_enable", self.enable_sedimentation)
        builder.add_counter("precipitated_mass", 1, None)
        builder.add_counter("max_n_substeps_displacement", 1, torch.int32, fill=1)
        if self.distributed_x is not None:
            # [send_overflow, placement_overflow] (parallel/migration.py)
            builder.add_counter("migration_dropped", 2, torch.int64)
            builder.add_counter("migration_far_moves", 1, torch.int64)

    @property
    def precipitation_mass_in_last_step(self):
        return float(self.particulator.get_counter("precipitated_mass")[0])

    def n_substeps(self, courant):
        """smallest power of two n with (d/n)/(1 - d/n) < rtol, d = max
        |delta courant| (one host read); decomposed, d is the largest over
        the ranks, so that every slab takes the same substeps"""
        with span("Displacement.read"):
            d_max = max(c.diff(dim=d).abs().max() for d, c in enumerate(courant))
            if self.distributed_x is not None:
                groups = [self.distributed_x["group"]]
                if self.distributed_x.get("group_z") is not None:
                    groups.append(self.distributed_x["group_z"])
                for group in groups:
                    dist.all_reduce(d_max, op=dist.ReduceOp.MAX, group=group)
            self.host_reads += 1
            d_max = d_max.item()
        n = 1.0
        while (d_max / n) / (1.0 - d_max / n) >= self.rtol:
            n *= 2.0
        return int(n)

    def make_step(self, particulator):
        mesh = particulator.mesh
        grid = mesh.grid
        n_dims = mesh.n_dims
        strides = mesh.strides.ravel()
        dt = particulator.dt
        dz = mesh.dz
        formulae = particulator.formulae
        resolver = particulator._resolver
        enable_sedimentation = self.enable_sedimentation
        precip_level = self.precipitation_counting_level_index
        distributed = self.distributed_x
        # imported here: the parallel package imports the dynamics
        from ..parallel import migration
        from ..parallel.halo import ring_halo_pad

        # decomposed, the courant fields get a one-cell halo on each
        # decomposed side, and a tile's z origins are offset to the column's
        gather_offset = [0] * n_dims
        z_off, z_shards = 0, 1
        if distributed is not None:
            if n_dims != 2:
                raise ValueError("distributed displacement: 2D (x, z) only")
            group_z = distributed.get("group_z")
            gather_offset = [1, 1 if group_z is not None else 0]
            if group_z is not None:
                z_shards = distributed["z_shards"]
                z_off = dist.get_rank(group_z) * grid[-1]
        halo_grid = tuple(g + 2 * h for g, h in zip(grid, gather_offset))
        courant_strides = tuple(
            disp_ops.face_strides(halo_grid, d) for d in range(n_dims)
        )
        domain_top = grid[-1] * z_shards

        def step(sim):
            with span("Displacement.prepare"):
                particles = sim["particles"]
                env = sim["env"]
                counters = dict(sim["counters"])
                courant = tuple(
                    env[f"courant_{d}"].reshape(
                        tuple(g + (1 if ax == d else 0) for ax, g in enumerate(grid))
                    )
                    for d in range(n_dims)
                )
                if distributed is not None:
                    # courant_d holds faces along d: its halo along d takes the
                    # faces beyond the shared ones (the JAX package pads with
                    # the shared face, so a particle that crosses a slab within
                    # a step reads it twice)
                    courant = tuple(
                        ring_halo_pad(c, 0, distributed["group"], staggered=d == 0)
                        for d, c in enumerate(courant)
                    )
                    if distributed.get("group_z") is not None:
                        courant = tuple(
                            ring_halo_pad(
                                c, 1, distributed["group_z"], staggered=d == 1
                            )
                            for d, c in enumerate(courant)
                        )
                n_sub = self.n_substeps(courant) if self.adaptive else 1
                ftype = courant[0].dtype
                # the JAX package divides in the working dtype
                n_sub_f = torch.tensor(float(n_sub), dtype=ftype)
                dt_sub = dt / n_sub_f
                sedimenting = sim["flags"]["sedimentation_enable"]
                if enable_sedimentation and sedimenting:
                    v_fall = resolver.get(particles, "relative fall velocity")
                water_mass = particles.ext("signed water mass")

                cell_origin = particles.cell_origin
                position_in_cell = particles.position_in_cell
                multiplicity = particles.multiplicity
                if distributed is not None:
                    offset = torch.tensor(
                        gather_offset, dtype=cell_origin.dtype,
                        device=cell_origin.device,
                    ).reshape(n_dims, 1)
                rainfall = torch.zeros((), dtype=ftype, device=multiplicity.device)
            self.substeps_run += n_sub
            for _ in range(n_sub):
                with span("Displacement.substep"):
                    displacement = disp_ops.calculate_displacement(
                        formulae, courant, courant_strides,
                        cell_origin if distributed is None else cell_origin + offset,
                        position_in_cell, n_sub_f,
                    )
                    if enable_sedimentation and sedimenting:
                        # reference Displacement.calculate_displacement tail:
                        # the fall speed in grid units
                        displacement[-1] = displacement[-1] + -v_fall * dt_sub / dz
                    position_in_cell = position_in_cell + displacement
                    if enable_sedimentation:
                        rain, multiplicity = disp_ops.flag_precipitated(
                            cell_origin=cell_origin,
                            position_in_cell=position_in_cell,
                            displacement=displacement,
                            multiplicity=multiplicity,
                            water_mass=water_mass,
                            precipitation_counting_level_index=precip_level,
                            z_offset=z_off,
                        )
                        # with sedimentation gated off, particles crossing the
                        # bottom still die but do not count as precipitation
                        if sedimenting:
                            rainfall = rainfall + rain
                    multiplicity = disp_ops.flag_out_of_column(
                        cell_origin=cell_origin,
                        position_in_cell=position_in_cell,
                        multiplicity=multiplicity,
                        domain_top_level_index=domain_top,
                        z_offset=z_off,
                    )
                    cell_origin, position_in_cell = disp_ops.update_cell_origin(
                        cell_origin, position_in_cell
                    )
                    if distributed is None:
                        cell_origin = disp_ops.periodic_boundary(cell_origin, grid)
                    elif distributed.get("group_z") is None:
                        # x stays unwrapped (migration resolves slab crossings
                        # after the substeps); z wraps as in the reference
                        cell_origin = torch.stack([
                            cell_origin[0],
                            torch.remainder(cell_origin[-1], grid[-1]),
                        ])
                    # on a tile decomposition z stays unwrapped too: migration
                    # classifies the tile crossing (out-of-column crossers died
                    # above by the column's z)

            with span("Displacement.commit"):
                counters["precipitated_mass"] = rainfall.reshape(1)
                counters["max_n_substeps_displacement"] = torch.clamp_min(
                    counters["max_n_substeps_displacement"], n_sub
                )
                if distributed is None:
                    particles = particles.replace(
                        cell_origin=cell_origin,
                        position_in_cell=position_in_cell,
                        multiplicity=multiplicity,
                        cell_id=disp_ops.recalculate_cell_id(cell_origin, strides),
                    )
                    return {**sim, "particles": particles, "counters": counters}

                out = {}
                dest_shift, far = migration.classify_dest_shift(
                    cell_origin[0], grid[0], multiplicity
                )
                if distributed.get("group_z") is not None:
                    _, far_z = migration.classify_dest_shift(
                        cell_origin[-1], grid[-1], multiplicity
                    )
                    far = far | far_z
                # movers beyond the neighbour cannot ride the ring: kill, count
                multiplicity = torch.where(far, 0, multiplicity)
                counters["migration_far_moves"] = (
                    counters["migration_far_moves"] + far.sum().reshape(1)
                )
                # on a tile decomposition the z origin stays unwrapped through
                # the x exchange (it encodes the z destination); the z phase
                # classifies and wraps it after the x arrivals are placed
                cell_origin = torch.cat([
                    torch.remainder(cell_origin[:1], grid[0]), cell_origin[1:]
                ])
                arrays = _particle_arrays(
                    particles, multiplicity, cell_origin, position_in_cell
                )
                n_dropped = 0
                if distributed.get("overlap", True):
                    # the x exchange flies while the cell-local physics after
                    # this dynamic runs; the commit step places the arrivals
                    arrays, out["migration_inflight"] = migration.migrate_ring_start(
                        arrays=arrays,
                        multiplicity_index=0,
                        dest_shift=dest_shift,
                        group=distributed["group"],
                        capacity=distributed["capacity"],
                    )
                else:
                    arrays, n_dropped = migration.migrate_ring(
                        arrays=arrays,
                        multiplicity_index=0,
                        dest_shift=dest_shift,
                        group=distributed["group"],
                        capacity=distributed["capacity"],
                        rounds=distributed.get("rounds", 2),
                    )
                if distributed.get("group_z") is not None:
                    # with overlap, the residents' z phase runs now, so that no
                    # resident enters collision with an unwrapped z (its cell id
                    # would leave the tile); the x arrivals take theirs at commit
                    arrays, n_dropped_z = _migrate_z_phase(
                        arrays, distributed, grid[-1]
                    )
                    n_dropped = n_dropped + n_dropped_z
                counters["migration_dropped"] = (
                    counters["migration_dropped"] + n_dropped
                )
                particles = _with_arrays(particles, arrays, strides)
                return {**sim, "particles": particles, "counters": counters, **out}

        return step

    def make_commit_step(self, particulator):
        """overlap mode: place the migration arrivals this dynamic's step
        started (the builder runs it after the last physics dynamic, so
        that the exchange overlaps collision). Arrivals land in grave
        slots, so the step breaks the cell-sorted state; the builder's
        shared-sort analysis counts it. None when there is nothing to
        commit."""
        distributed = self.distributed_x
        if distributed is None or not distributed.get("overlap", True):
            return None
        strides = particulator.mesh.strides.ravel()
        nz_local = particulator.mesh.grid[-1]
        from ..parallel import migration

        def commit(sim):
            sim = dict(sim)
            inflight = sim.pop("migration_inflight")
            particles = sim["particles"]
            counters = dict(sim["counters"])
            arrays = _particle_arrays(
                particles, particles.multiplicity, particles.cell_origin,
                particles.position_in_cell,
            )
            arrays, n_dropped = migration.migrate_ring_commit(
                arrays=arrays,
                inflight=inflight,
                multiplicity_index=0,
                group=distributed["group"],
                capacity=distributed["capacity"],
                rounds=distributed.get("rounds", 2),
            )
            if distributed.get("group_z") is not None:
                arrays, n_dropped_z = _migrate_z_phase(
                    arrays, distributed, nz_local
                )
                n_dropped = n_dropped + n_dropped_z
            counters["migration_dropped"] = (
                counters["migration_dropped"] + n_dropped
            )
            particles = _with_arrays(particles, arrays, strides)
            return {**sim, "particles": particles, "counters": counters}

        return commit
