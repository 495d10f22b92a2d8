"""Arakawa-C staggered-grid helpers (a NumPy-only copy of
``pysdm_tpu/impl/arakawa_c.py``; reference ``PySDM/impl/arakawa_c.py`` and
``examples/.../kinematic_2d/fields.py``): scalar and vector coordinate
fields and the discretely nondivergent advector built from a stream
function. Host-side, at set-up."""

import numpy as np


def z_scalar_coord(grid):
    return np.linspace(1 / 2, grid[-1] - 1 / 2, grid[-1])


def make_rhod(grid, rhod_of_zZ):
    """dry-air density on scalar points, constant along x"""
    return np.repeat(
        rhod_of_zZ(z_scalar_coord(grid) / grid[-1]).reshape((1, grid[-1])),
        grid[0],
        axis=0,
    )


def x_vec_coord(grid):
    """dimensionless (xX, zZ) of x-face points, shapes (nx+1, nz)"""
    nx, nz = grid[0] + 1, grid[1]
    xX = np.repeat(np.linspace(0, grid[0], nx).reshape((nx, 1)), nz, axis=1) / grid[0]
    zZ = np.repeat(z_scalar_coord(grid).reshape((1, nz)), nx, axis=0) / grid[1]
    return xX, zZ


def z_vec_coord(grid):
    """dimensionless (xX, zZ) of z-face points, shapes (nx, nz+1)"""
    nx, nz = grid[0], grid[1] + 1
    xX = (
        np.repeat(
            np.linspace(1 / 2, grid[0] - 1 / 2, nx).reshape((nx, 1)), nz, axis=1
        )
        / grid[0]
    )
    zZ = np.repeat(np.linspace(0, grid[1], nz).reshape((1, nz)), nx, axis=0) / grid[1]
    return xX, zZ


def nondivergent_vector_field_2d(grid, size, dt, stream_function, t=0.0):
    """face-staggered (G*courant) components from a stream function —
    discretely divergence-free by construction (finite differences of the
    stream function between cell corners)"""
    dx = size[0] / grid[0]
    dz = size[1] / grid[1]
    dxX = 1 / grid[0]
    dzZ = 1 / grid[1]
    xX, zZ = x_vec_coord(grid)
    rho_velocity_x = (
        -(stream_function(xX, zZ + dzZ / 2, t) - stream_function(xX, zZ - dzZ / 2, t))
        / dz
    )
    xX, zZ = z_vec_coord(grid)
    rho_velocity_z = (
        stream_function(xX + dxX / 2, zZ, t) - stream_function(xX - dxX / 2, zZ, t)
    ) / dx
    return [rho_velocity_x * dt / dx, rho_velocity_z * dt / dz]
