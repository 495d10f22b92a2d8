"""Displacement dynamic: particle advection by the flow and sedimentation
(port of the single-device path of ``pysdm_tpu/dynamics/displacement.py``;
reference ``PySDM/dynamics/displacement.py``).

The adaptive substep count (reference ``upload_courant_field``: the
smallest power of two n with (d/n)/(1 - d/n) < rtol, d the largest courant
difference between neighbouring faces, Arabas et al. 2015 eqs. 13-16) is
decided on the host: one device read per step, counted in ``host_reads``.
Courant fields come from the env state (``courant_0..courant_{D-1}``),
written there by the EulerianAdvection dynamic.

Multi-device displacement (``distributed_x``, particle migration between
slabs) comes with slice 6.
"""

from collections import namedtuple

import torch

from ..ops import displacement as disp_ops

DEFAULTS = namedtuple("_", ("rtol", "adaptive"))(rtol=1e-2, adaptive=True)


class Displacement:
    # moving particles between cells breaks the cell-sorted state the
    # builder's shared sort tracks
    breaks_cell_sort = True

    def __init__(
        self,
        enable_sedimentation=False,
        precipitation_counting_level_index: int = 0,
        adaptive=DEFAULTS.adaptive,
        rtol=DEFAULTS.rtol,
        distributed_x: dict = None,
    ):
        if distributed_x is not None:
            raise NotImplementedError(
                "distributed_x: multi-device displacement comes with slice 6"
            )
        self.particulator = None
        self.enable_sedimentation = enable_sedimentation
        self.precipitation_counting_level_index = precipitation_counting_level_index
        self.adaptive = adaptive
        self.rtol = rtol
        self.host_reads = 0

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("relative fall velocity")
        builder.add_flag("sedimentation_enable", self.enable_sedimentation)
        builder.add_counter("precipitated_mass", 1, None)
        builder.add_counter("max_n_substeps_displacement", 1, torch.int32, fill=1)

    @property
    def precipitation_mass_in_last_step(self):
        return float(self.particulator.get_counter("precipitated_mass")[0])

    def n_substeps(self, courant):
        """smallest power of two n with (d/n)/(1 - d/n) < rtol, d = max
        |delta courant| (one host read)"""
        d_max = max(c.diff(dim=d).abs().max() for d, c in enumerate(courant))
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
        courant_strides = tuple(
            disp_ops.face_strides(grid, d) for d in range(n_dims)
        )
        domain_top = grid[-1]

        def step(sim):
            particles = sim["particles"]
            env = sim["env"]
            counters = dict(sim["counters"])
            courant = tuple(
                env[f"courant_{d}"].reshape(
                    tuple(g + (1 if ax == d else 0) for ax, g in enumerate(grid))
                )
                for d in range(n_dims)
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
            rainfall = torch.zeros((), dtype=ftype, device=multiplicity.device)
            for _ in range(n_sub):
                displacement = disp_ops.calculate_displacement(
                    formulae, courant, courant_strides, cell_origin,
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
                )
                cell_origin, position_in_cell = disp_ops.update_cell_origin(
                    cell_origin, position_in_cell
                )
                cell_origin = disp_ops.periodic_boundary(cell_origin, grid)

            particles = particles.replace(
                cell_origin=cell_origin,
                position_in_cell=position_in_cell,
                multiplicity=multiplicity,
                cell_id=disp_ops.recalculate_cell_id(cell_origin, strides),
            )
            counters["precipitated_mass"] = rainfall.reshape(1)
            counters["max_n_substeps_displacement"] = torch.clamp_min(
                counters["max_n_substeps_displacement"], n_sub
            )
            return {**sim, "particles": particles, "counters": counters}

        return step
