"""The port's decomposed 2D warm rain (``pysdm_tpu_torch/parallel/
distributed_2d.py``) in spawned gloo ranks on the CPU, float64: the five
tests of ``tests/smoke/test_distributed_2d.py`` at their bounds, then the
slice against the JAX package.

One spawn of 8 ranks runs the first three scenarios (the eddy, the
crosswind and the undersized buffers, ``verification.rank_warm_rain``
recording a snapshot at each checkpoint); one of 4 ranks runs the overlap
pair and the case compared with the JAX package, whose side runs under
``shard_map`` on the emulated 8-device CPU mesh in this process:
``DistributedSimulation2D`` at 4 shards, 8 x 8 x 16, ``Formulae(seed=21)``,
collisions off, 12 steps in both packages; the canonical particle rows
(multiplicities equal; the dry volume identities within 1e-15, an ulp,
as the two packages' samplings round them; positions within 1e-3 grid
units, water masses within 1e-13 kg) and the global thd, qv and RH
(relative 1e-6), ``tests/smoke/test_shard_invariance.py``'s bounds.
"""

import functools

import numpy as np
import pytest

from pysdm_tpu.models.arabas_et_al_2015 import Settings as JaxSettings
from pysdm_tpu.parallel import DistributedSimulation2D as JaxDistributed
from pysdm_tpu.parallel.verification import (
    _global_field as jax_global_field,
    canonical_particles as jax_canonical_particles,
)
from pysdm_tpu.physics import Formulae as JaxFormulae
from pysdm_tpu_torch.parallel import multihost, verification

N_DEV = 8
N_SMALL = 4
EDDY = functools.partial(
    verification.warm_rain_settings, seed=17, grid=(16, 8),
    n_sd_per_gridbox=8,
)
CROSSWIND_CHECKPOINTS = (11, 22, 33, 44, 55)
JAX_CASE = dict(seed=21, grid=(8, 8), n_sd_per_gridbox=16)
JAX_STEPS = 12


def _crosswind(seed):
    return functools.partial(
        verification.warm_rain_settings, seed=seed, grid=(16, 8),
        n_sd_per_gridbox=8, crosswind=True,
    )


@pytest.fixture(scope="module")
def eight():
    """rank 0's records of the eddy (24 steps, then 36 more), the
    crosswind (55 steps) and the undersized buffers (12 steps)"""
    cases = [
        (verification.rank_warm_rain, (EDDY, (24, 60))),
        (verification.rank_warm_rain, (_crosswind(23), CROSSWIND_CHECKPOINTS)),
        (verification.rank_warm_rain, (
            _crosswind(29), (12,), dict(migration_capacity=4),
        )),
    ]
    eddy, crosswind, overflow = multihost.spawn(
        verification.rank_cases, N_DEV, cases
    )[0]
    return {"eddy": eddy, "crosswind": crosswind, "overflow": overflow}


@pytest.fixture(scope="module")
def four():
    """rank 0's records of the overlap pair (8 x 8 x 8, seed 5, capacity
    64, 8 steps each) and of the case held to the JAX package"""
    overlap_case = functools.partial(
        verification.warm_rain_settings, seed=5, grid=(8, 8),
        n_sd_per_gridbox=8,
    )
    cases = [
        (verification.rank_warm_rain, (
            overlap_case, (8,),
            dict(migration_capacity=64, migration_overlap=overlap),
            False, True,
        ))
        for overlap in (True, False)
    ]
    cases.append((verification.rank_warm_rain, (
        functools.partial(verification.warm_rain_settings, **JAX_CASE),
        (JAX_STEPS,), None, False, True,
    )))
    overlapped, inline, jax_case = multihost.spawn(
        verification.rank_cases, N_SMALL, cases
    )[0]
    return {"overlap": overlapped, "inline": inline, "jax_case": jax_case}


def _water(snapshot):
    return snapshot["diagnostics"]["water_total"]


def test_distributed_step_runs_and_conserves_water(eight):
    start, after = eight["eddy"]["snapshots"][:2]
    assert after["steps"] == 24
    assert after["diagnostics"]["condensation_ok"] == 1.0
    assert after["migration_dropped"] == 0
    np.testing.assert_allclose(_water(after), _water(start), rtol=1e-3)
    assert after["rh_finite"] and after["rh_max"] < 1.2
    # particles still tracked (out-of-column deaths aside)
    assert after["diagnostics"]["n_alive"] > 0.9 * start["diagnostics"]["n_alive"]


def test_particles_migrate_between_shards(eight):
    before, after = eight["eddy"]["snapshots"][1:]
    assert after["steps"] == 60
    assert after["migration_dropped"] == 0
    assert before["alive_per_rank"] != after["alive_per_rank"], (
        "the eddy must move particles across slabs"
    )
    low, high = after["cell_id_range"]
    assert low >= 0 and high < 16 * 8


def test_migration_under_sustained_crosswind(eight):
    """55 steps at courant_x ~ 0.85: the ring exchange delivers every mover
    (no drops, no far moves) and the water budget stays closed"""
    record = eight["crosswind"]
    snaps = record["snapshots"]
    end = snaps[-1]
    assert end["steps"] == CROSSWIND_CHECKPOINTS[-1]
    assert end["migration_dropped"] == 0
    assert end["migration_far_moves"] == 0
    np.testing.assert_allclose(_water(end), _water(snaps[0]), rtol=1e-3)
    occupancy = np.array([s["alive_per_rank"] for s in snaps])
    assert (occupancy[1:] != occupancy[0]).any(axis=1).all()
    assert occupancy.max() <= record["capacity"]
    # the crosswind only relocates: deaths are precipitation only
    assert (end["diagnostics"]["n_alive"]
            >= 0.95 * snaps[0]["diagnostics"]["n_alive"])


def test_migration_capacity_overflow_is_counted_not_silent(eight):
    end = eight["overflow"]["snapshots"][-1]
    assert end["migration_dropped"] > 0
    assert end["water_mass_nonfinite"] == 0
    assert end["multiplicity_min"] >= 0


def test_overlap_migration_equals_inline_when_deterministic(four):
    """with collisions off the overlap changes only when in-flight
    particles become visible, which nothing observes"""
    rows_a = four["overlap"]["snapshots"][-1]["rows"]
    rows_b = four["inline"]["snapshots"][-1]["rows"]
    np.testing.assert_array_equal(rows_a[:, 0], rows_b[:, 0])
    np.testing.assert_allclose(rows_a, rows_b, rtol=1e-9, atol=1e-18)


def test_decomposed_warm_rain_matches_jax(four):
    settings = JaxSettings(
        JaxFormulae(seed=JAX_CASE["seed"]), grid=JAX_CASE["grid"],
        size=(1500.0, 1500.0), dt=5.0,
        n_sd_per_gridbox=JAX_CASE["n_sd_per_gridbox"],
    )
    sim = JaxDistributed(settings, n_shards=N_SMALL)
    sim.particulator.set_flag("collision_enable", False)
    sim.run(JAX_STEPS)
    sim.particulator.block_until_ready()
    want = jax_canonical_particles(sim, settings)
    got = four["jax_case"]["snapshots"][-1]
    rows = got["rows"]
    assert rows.shape == want.shape
    # the identity: the two packages' samplings round the dry volumes
    # apart by an ulp (r^3 taken in another order), the decomposition
    # moves none of them
    np.testing.assert_allclose(rows[:, 0], want[:, 0], rtol=1e-15, atol=0)
    np.testing.assert_array_equal(rows[:, 4], want[:, 4])
    assert np.max(np.abs(rows[:, 1:3] - want[:, 1:3])) < 1e-3
    assert np.max(np.abs(rows[:, 3] - want[:, 3])) < 1e-13
    for name in verification.FIELDS:
        field = jax_global_field(sim, settings, name)
        assert np.max(np.abs(got["fields"][name] - field) / np.abs(field)) < 1e-6
