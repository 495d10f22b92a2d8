"""Shard-count invariance of the port's decomposed 2D warm rain, the
counterpart of ``tests/smoke/test_shard_invariance.py``: with collisions
off the chain is deterministic, so the global state after the steps
agrees between 1, 2, 4 and 8 x-slabs, and between the (x, z) tilings
(2, 4), (4, 2) and (2, 2) and one tile, at that test's bounds (float64;
positions 1e-3 grid units, water masses 1e-13 kg, fields 1e-6 relative).
Then the full-physics tile run, collisions on. Each decomposition runs in
spawned gloo ranks (``parallel/verification.py``)."""

import functools

import numpy as np
import pytest

from pysdm_tpu_torch.parallel import multihost, verification
from pysdm_tpu_torch.parallel.verification import shard_invariance_report

MESH_SHAPES = ((2, 4), (4, 2), (2, 2))
TILE_STEPS = 8
SETTINGS = functools.partial(
    verification.warm_rain_settings, seed=21, grid=(8, 8),
    n_sd_per_gridbox=16,
)
# fixed condensation substeps for the tilings, as the JAX test has them
TILE_SETTINGS = functools.partial(SETTINGS, condensation_adaptive=False)


def _check(key, val):
    if key.startswith("position_max_abs"):
        assert val < 1e-3, f"{key} = {val:.3e}"
    elif key.startswith("water_mass_max_abs"):
        assert val < 1e-13, f"{key} = {val:.3e}"
    else:  # env fields, relative
        assert val < 1e-6, f"{key} = {val:.3e}"


def test_shard_count_invariance():
    report = shard_invariance_report(
        SETTINGS, shard_counts=(1, 2, 4, 8), steps=12
    )
    assert len(report) == 3 * 5
    for key, val in report.items():
        _check(key, val)


def _tile_case(mesh_shape, settings=TILE_SETTINGS, steps=TILE_STEPS,
               collisions=False):
    return (verification.rank_warm_rain, (
        settings, (steps,), dict(mesh_shape=mesh_shape), collisions, True,
    ))


@pytest.fixture(scope="module")
def tiles():
    """rank 0's records of one tile, of each tiling and of the
    full-physics (2, 4) run (seed 9, 6 steps, collisions on)"""
    one = multihost.spawn(verification.rank_cases, 1, [_tile_case((1, 1))])
    four = multihost.spawn(verification.rank_cases, 4, [_tile_case((2, 2))])
    full = functools.partial(SETTINGS, seed=9)
    eight = multihost.spawn(verification.rank_cases, 8, [
        _tile_case((2, 4)), _tile_case((4, 2)),
        _tile_case((2, 4), full, 6, True),
    ])
    return {
        (1, 1): one[0][0], (2, 2): four[0][0], (2, 4): eight[0][0],
        (4, 2): eight[0][1], "full": eight[0][2],
    }


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_2d_tile_invariance(tiles, mesh_shape):
    """two-axis halos, two-phase (x, then z) migration with diagonal
    movers, per-tile advector and g-factor slices and the column-offset
    precipitation and out-of-column checks, against one tile"""
    ref = tiles[(1, 1)]["snapshots"][-1]
    got = tiles[mesh_shape]["snapshots"][-1]
    r0, r1 = ref["rows"], got["rows"]
    assert r1.shape == r0.shape
    np.testing.assert_array_equal(r1[:, 0], r0[:, 0])
    np.testing.assert_array_equal(r1[:, 4], r0[:, 4])
    _check("position_max_abs", np.max(np.abs(r1[:, 1:3] - r0[:, 1:3])))
    _check("water_mass_max_abs", np.max(np.abs(r1[:, 3] - r0[:, 3])))
    for name in ("thd", "qv"):
        f0, f1 = ref["fields"][name], got["fields"][name]
        _check(name, np.max(np.abs(f1 - f0) / np.abs(f0)))


def test_2d_tile_full_physics_runs(tiles):
    """tiles with stochastic collisions: runs, closes the global water
    budget, keeps condensation clean, drops nothing"""
    start, end = tiles["full"]["snapshots"]
    assert end["diagnostics"]["condensation_ok"] == 1.0
    np.testing.assert_allclose(
        end["diagnostics"]["water_total"], start["diagnostics"]["water_total"],
        rtol=1e-9,
    )
    assert end["diagnostics"]["migration_dropped"] == 0.0
