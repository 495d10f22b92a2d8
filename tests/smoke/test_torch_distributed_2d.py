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
# the staleness runs: steps, and the draws of the inline runs (None: the
# rank's own seed, as the overlapped run's; others reseed the generators
# after the build, from the same start)
STALENESS_STEPS = 40
STALENESS_DRAWS = (None, 1, 2)


# a capacity at which the first round overflows on every rank and the
# second takes the rest (the crosswind brings up to ~70 movers a step)
TWO_ROUND_CAPACITY = 40


def _crosswind(seed, **kwargs):
    return functools.partial(
        verification.warm_rain_settings, seed=seed, grid=(16, 8),
        n_sd_per_gridbox=8, crosswind=True, **kwargs,
    )


@pytest.fixture(scope="module")
def eight():
    """rank 0's records of the eddy (24 steps, then 36 more), the
    crosswind (55 steps), the undersized buffers (12 steps, every rank's
    ``migration_probe`` summaries under ``"overflow_probes"``) and the
    never-merging crosswind at ``TWO_ROUND_CAPACITY`` with overlap and
    inline (12 steps each; the overlapped one's probes under
    ``"two_round_probes"``)"""
    never_merging = _crosswind(29, collection_efficiency=0.0)
    cases = [
        (verification.rank_warm_rain, (EDDY, (24, 60))),
        (verification.rank_warm_rain, (_crosswind(23), CROSSWIND_CHECKPOINTS)),
        (verification.rank_warm_rain, (
            _crosswind(29), (12,), dict(migration_capacity=4), True, False,
            None, True,
        )),
    ] + [
        (verification.rank_warm_rain, (
            never_merging, (12,),
            dict(migration_capacity=TWO_ROUND_CAPACITY,
                 migration_overlap=overlap),
            True, True, None, overlap,
        ))
        for overlap in (True, False)
    ]
    per_rank = multihost.spawn(verification.rank_cases, N_DEV, cases)
    eddy, crosswind, overflow, two_round, two_round_inline = per_rank[0]
    return {
        "eddy": eddy, "crosswind": crosswind, "overflow": overflow,
        "overflow_probes": [r[2]["probe"] for r in per_rank],
        "two_round": two_round, "two_round_inline": two_round_inline,
        "two_round_probes": [r[3]["probe"] for r in per_rank],
    }


@pytest.fixture(scope="module")
def four():
    """rank 0's records of the overlap pair (8 x 8 x 8, seed 5, capacity
    64, 8 steps each), of the case held to the JAX package and of the
    staleness runs (the overlap pair's case with collisions and
    sedimentation on at the default capacity, ``STALENESS_STEPS`` steps:
    overlap, then inline with the draws of each of ``STALENESS_DRAWS``)"""
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
    cases += [
        (verification.rank_warm_rain, (
            overlap_case, (STALENESS_STEPS,),
            dict(migration_overlap=overlap), True, True, None, False, draws,
        ))
        for overlap, draws in (
            (True, None), *((False, d) for d in STALENESS_DRAWS)
        )
    ]
    overlapped, inline, jax_case, *staleness = multihost.spawn(
        verification.rank_cases, N_SMALL, cases
    )[0]
    return {"overlap": overlapped, "inline": inline, "jax_case": jax_case,
            "staleness": staleness}


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


def test_overflow_with_overlap_ships_only_the_stash(eight):
    """the undersized buffers (capacity 4, overlap, collisions on): at
    every commit of every rank the later round ships exactly the first
    ``capacity`` leftovers of each direction that the start stashed (by
    every row), the rest die as send drops, and the drops of all commits
    are the counter's. Some leftovers go back into another slot than
    their own, which the collision's sort gave to a resident"""
    probes = [s for rank in eight["overflow_probes"] for s in rank]
    assert len(probes) == N_DEV * 12
    for s in probes:
        assert s["selected"] == s["matched"] == s["expected"], s
        assert s["dropped"][0] == s["stashed"] - s["expected"], s
    assert sum(s["stashed"] for s in probes) > 0
    assert sum(s["away"] for s in probes) > 0
    dropped = sum(sum(s["dropped"]) for s in probes)
    assert dropped == eight["overflow"]["snapshots"][-1]["migration_dropped"]


def test_two_round_overlap_with_a_sorting_collision_equals_inline(eight):
    """the crosswind at a capacity where the first round overflows and
    the second delivers the rest, overlap against inline, with a collision
    that sorts the cells every step and merges nothing (``Geometric`` with
    collection efficiency 0): the same particles, as a multiset, at the
    same places (the parent's per-slot pending flags shipped residents
    here: positions 14 grid units apart). With drops the two runs would
    choose different movers to kill, since the slots' order differs"""
    probes = [s for rank in eight["two_round_probes"] for s in rank]
    assert sum(s["stashed"] for s in probes) > 0
    for s in probes:
        assert s["selected"] == s["matched"] == s["expected"], s
        assert s["dropped"] == [0, 0], s
    over = eight["two_round"]["snapshots"][-1]
    inline = eight["two_round_inline"]["snapshots"][-1]
    assert over["migration_dropped"] == inline["migration_dropped"] == 0
    rows_a, rows_b = over["rows"], inline["rows"]
    np.testing.assert_array_equal(rows_a[:, 0], rows_b[:, 0])
    np.testing.assert_array_equal(rows_a[:, 4], rows_b[:, 4])
    np.testing.assert_allclose(rows_a, rows_b, rtol=1e-9, atol=1e-18)


def test_overlap_migration_equals_inline_when_deterministic(four):
    """with collisions off the overlap changes only when in-flight
    particles become visible, which nothing observes"""
    rows_a = four["overlap"]["snapshots"][-1]["rows"]
    rows_b = four["inline"]["snapshots"][-1]["rows"]
    np.testing.assert_array_equal(rows_a[:, 0], rows_b[:, 0])
    np.testing.assert_allclose(rows_a, rows_b, rtol=1e-9, atol=1e-18)


def _rain_quantities(record):
    """what rain depends on, from the last snapshot: the domain's liquid
    water (kg), its alive super-droplets, its real droplets, the liquid in
    drops above 40 um radius (kg) and the largest drop's mass (kg)"""
    end = record["snapshots"][-1]
    rows = end["rows"]
    mass_40um = 4 / 3 * np.pi * (40e-6) ** 3 * 1000.0
    big = rows[:, 3] > mass_40um
    return {
        "liquid": end["diagnostics"]["water_liquid"],
        "alive": end["diagnostics"]["n_alive"],
        "droplets": rows[:, 4].sum(),
        "liquid_above_40um": (rows[big, 3] * rows[big, 4]).sum(),
        "largest_drop": rows[:, 3].max(),
    }


def test_overlap_staleness_within_the_draws_spread(four):
    """with collisions and sedimentation on, overlap against inline on the
    same start and draws: each quantity of ``_rain_quantities`` differs by
    at most the spread (largest minus least) of the inline run over three
    draws (``STALENESS_DRAWS``) from that start, the noise a collision
    realization brings. The bound comes from the inline runs alone.

    Measured (CPU float64, 4 ranks, 8 x 8 x 8, 40 steps): liquid 390.8933
    kg overlapped against 390.8909 inline, the draws spanning 390.8810 to
    391.2481 (spread 0.3671); real droplets 2.05047e14 against 2.05825e14,
    spread 2.27e12; the largest drop 2.49655e-11 kg in both, spread
    8.9e-12 kg; 512 alive in every run. No drop reaches 40 um in 200 s, so
    that quantity is 0 in every run; a 21-draw ensemble of 60-step runs at
    seeds 5 and 6 found the liquid's upper tail (rare merges of two
    super-droplets of ~4e11 droplets each) in both modes (ROADMAP queue
    3)."""
    overlapped, *inline = (_rain_quantities(r) for r in four["staleness"])
    for name, value in overlapped.items():
        runs = [q[name] for q in inline]
        spread = max(runs) - min(runs)
        assert abs(value - runs[0]) <= spread, (name, value, runs)


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
