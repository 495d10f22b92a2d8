"""Particle displacement ops: advection by the flow and sedimentation (port of
``pysdm_tpu/ops/displacement.py``; reference
``PySDM/backends/impl_numba/methods/displacement_methods.py``).

Per-particle Arakawa-C courant interpolation, precipitation flagging at the
bottom boundary and out-of-column flagging; a flagged particle dies
(multiplicity 0) instead of leaving an index. The courant table is read by
a gather at each particle's face (the JAX package's one-hot matmul exists
because TPU gathers are slow).
"""

import numpy as np
import torch


def _dot(strides, cell_origin):
    """sum_ax strides[ax] * cell_origin[ax], the strides as host integers
    (no host-to-device copy in the step)"""
    return sum(int(s) * cell_origin[ax] for ax, s in enumerate(strides))


def face_strides(grid, d):
    """row-major strides of the d-face array (grid with +1 along axis d)"""
    shape = list(grid)
    shape[d] += 1
    strides = np.ones(len(grid), dtype=np.int64)
    for ax in range(len(grid) - 2, -1, -1):
        strides[ax] = strides[ax + 1] * shape[ax + 1]
    return strides


def courant_at_particles(courant_d, strides_d, cell_origin, d):
    """(c_left, c_right) of each particle's cell along axis d (reference
    ``calculate_displacement_body_1d/2d/3d``). Indices are clamped to the
    table, as the JAX package's lookup clamps them: only a dead particle's
    stale origin can fall outside it."""
    base = _dot(strides_d, cell_origin)
    flat = courant_d.reshape(-1)
    m = flat.shape[0]
    left = base.clamp(0, m - 1)
    right = (left + int(strides_d[d])).clamp_max(m - 1)
    return flat[left], flat[right]


def calculate_displacement(
    formulae, courant, courant_strides, cell_origin, position_in_cell, n_substeps
):
    """in-cell displacement (grid units) for every dim; courant fields are
    divided by n_substeps (reference ``calculate_displacement_body_common``)"""
    disp = []
    for d, courant_d in enumerate(courant):
        c_l, c_r = courant_at_particles(
            courant_d, courant_strides[d], cell_origin, d
        )
        disp.append(
            formulae.particle_advection.displacement(
                position_in_cell[d], c_l / n_substeps, c_r / n_substeps
            )
        )
    return torch.stack(disp)


def flag_precipitated(
    *, cell_origin, position_in_cell, displacement, multiplicity, water_mass,
    precipitation_counting_level_index, z_offset=0,
):
    """mass flux through the bottom counting level; flagged particles die
    (reference ``_flag_precipitated_body``). ``z_offset`` shifts a tile's
    local z origins to the column's (the counting level is a column
    index). Returns (rainfall_mass, new_multiplicity)."""
    z_abs = z_offset + cell_origin[-1] + position_in_cell[-1]
    flagged = (
        (displacement[-1] < 0)
        & (z_abs < precipitation_counting_level_index)
        & (multiplicity > 0)
    )
    rainfall_mass = torch.where(
        flagged, water_mass.abs() * multiplicity.to(water_mass.dtype), 0.0
    ).sum()
    return rainfall_mass, torch.where(flagged, 0, multiplicity)


def flag_out_of_column(
    *, cell_origin, position_in_cell, multiplicity, domain_top_level_index,
    z_offset=0,
):
    """particles leaving the column vertically die (reference
    ``_flag_out_of_column_body``); ``domain_top_level_index`` and
    ``z_offset`` are column indices on a z-decomposed mesh"""
    z_abs = z_offset + cell_origin[-1] + position_in_cell[-1]
    out = (z_abs < 0) | (z_abs > domain_top_level_index)
    return torch.where(out, 0, multiplicity)


def update_cell_origin(cell_origin, position_in_cell):
    """integer-part carry from position to origin"""
    floor = torch.floor(position_in_cell)
    return cell_origin + floor.to(cell_origin.dtype), position_in_cell - floor


def periodic_boundary(cell_origin, grid):
    return torch.stack([
        torch.remainder(cell_origin[ax], int(n)) for ax, n in enumerate(grid)
    ])


def recalculate_cell_id(cell_origin, strides):
    return _dot(np.asarray(strides).ravel(), cell_origin).to(torch.int32)
