"""The port's Displacement (``pysdm_tpu_torch/dynamics/displacement.py`` and
``ops/displacement.py``) against the JAX package's on the cases of
``tests/unit/test_displacement.py``, on the 2D grid of the warm rain: a
uniform updraft, particles leaving the column through the top,
sedimentation with precipitation accounting, and adaptive substepping in a
sheared flow. Both packages start from the same state (the same seed), get
the same courant fields and run the dynamic's step alone; positions agree
to rtol 1e-12 and multiplicities, cell ids and substep counts exactly
(float64 on both sides, the same operations in the same order)."""

import datetime

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
from pysdm_tpu.models import arabas_et_al_2015 as jax_model
import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.models import arabas_et_al_2015 as port_model
from pysdm_tpu_torch.ops import displacement as port_ops
from pysdm_tpu.ops import displacement as jax_ops

GRID = (4, 6)


@pytest.fixture(scope="module", name="sims")
def _sims():
    kwargs = dict(grid=GRID, n_sd_per_gridbox=8)
    jp, _ = jax_model.make_simulation(
        jax_model.Settings(pysdm_tpu.Formulae(seed=3), **kwargs)
    )
    tp, _ = port_model.make_simulation(
        port_model.Settings(pysdm_tpu_torch.Formulae(seed=3), **kwargs),
        backend_class=CPU,
    )
    return jp, tp


def _run(sims, courant, steps, sedimentation, water_mass_scale=1.0, z=None):
    """the Displacement step alone, ``steps`` times, in both packages from
    their (equal) built states with the given courant fields"""
    out = []
    for p, xp in ((sims[0], np), (sims[1], torch)):
        sim = dict(p.sim_state)
        sim["env"] = dict(sim["env"])
        sim["flags"] = dict(sim["flags"])
        sim["flags"]["sedimentation_enable"] = sedimentation
        for d, c in enumerate(courant):
            sim["env"][f"courant_{d}"] = (
                torch.from_numpy(c.ravel()) if xp is torch
                else jax.numpy.asarray(c.ravel())
            )
        particles = sim["particles"]
        names = particles.ext_names
        ext = np.array(particles.extensive)
        ext[names.index("signed water mass")] *= water_mass_scale
        origin = np.array(particles.cell_origin)
        pic = np.array(particles.position_in_cell)
        if z is not None:
            origin[-1] = np.floor(z)
            pic[-1] = z - np.floor(z)
        if xp is torch:
            particles = particles.replace(
                extensive=torch.from_numpy(ext),
                cell_origin=torch.from_numpy(origin).int(),
                position_in_cell=torch.from_numpy(pic),
            )
        else:
            particles = particles.replace(
                extensive=jax.numpy.asarray(ext),
                cell_origin=jax.numpy.asarray(origin, dtype=jax.numpy.int32),
                position_in_cell=jax.numpy.asarray(pic),
            )
        sim["particles"] = particles
        step = p.dynamics["Displacement"].make_step(p)
        rain = 0.0
        for _ in range(steps):
            sim = step(sim)
            rain += float(np.asarray(sim["counters"]["precipitated_mass"])[0])
        out.append((sim, rain))
    return out


def _compare(out):
    (j, j_rain), (t, t_rain) = out
    jp, tp = j["particles"], t["particles"]
    np.testing.assert_array_equal(tp.multiplicity.numpy(), np.asarray(jp.multiplicity))
    np.testing.assert_array_equal(tp.cell_id.numpy(), np.asarray(jp.cell_id))
    np.testing.assert_array_equal(tp.cell_origin.numpy(), np.asarray(jp.cell_origin))
    np.testing.assert_allclose(
        tp.position_in_cell.numpy(), np.asarray(jp.position_in_cell), rtol=1e-12
    )
    np.testing.assert_array_equal(
        t["counters"]["max_n_substeps_displacement"].numpy(),
        np.asarray(j["counters"]["max_n_substeps_displacement"]),
    )
    np.testing.assert_allclose(t_rain, j_rain, rtol=1e-12)
    return tp, t_rain


def _uniform(cx, cz):
    return (np.full((GRID[0] + 1, GRID[1]), cx), np.full((GRID[0], GRID[1] + 1), cz))


def test_uniform_updraft(sims):
    tp, _ = _compare(_run(sims, _uniform(0.1, 0.4), 1, False))
    z0 = sims[1].attributes["cell origin"][-1] + sims[1].attributes["position in cell"][-1]
    z1 = tp.cell_origin[-1].numpy() + tp.position_in_cell[-1].numpy()
    alive = tp.multiplicity.numpy() > 0
    np.testing.assert_allclose(z1[alive], (z0 + 0.4)[alive], rtol=1e-12)


def test_out_of_column_particles_die(sims):
    n_sd = sims[1].n_sd
    z = np.linspace(GRID[1] - 1.0, GRID[1] - 0.1, n_sd)
    tp, _ = _compare(_run(sims, _uniform(0.0, 0.9), 2, False, z=z))
    assert (tp.multiplicity.numpy() == 0).all()


def test_sedimentation_and_precipitation(sims):
    n_sd = sims[1].n_sd
    z = np.linspace(0.2, 3.0, n_sd)
    # ~0.5 mm drops: 1e5 times the haze mass, v_term ~ 4 m/s
    tp, rain = _compare(_run(
        sims, _uniform(0.0, 0.0), 4, True, water_mass_scale=1e9, z=z,
    ))
    assert rain > 0
    assert (tp.multiplicity.numpy() == 0).any()


def test_adaptive_substepping_in_sheared_flow(sims):
    cz = np.tile(np.linspace(-0.45, 0.45, GRID[1] + 1), (GRID[0], 1))
    tp, _ = _compare(_run(sims, (np.zeros((GRID[0] + 1, GRID[1])), cz), 1, False))
    assert sims[1].dynamics["Displacement"].host_reads >= 1


def test_courant_lookup_clamps_like_the_jax_package():
    """a dead particle's stale origin (outside the grid) reads the edge of
    the courant table, as the JAX package's clamped lookup does"""
    courant = np.arange(5 * 6, dtype=float).reshape(5, 6)
    origin = np.array([[-1, 0, 3, 4, 9], [0, -2, 5, 6, 1]], dtype=np.int32)
    strides = jax_ops.face_strides((4, 6), 0)
    expected = jax_ops.courant_at_particles(
        jax.numpy.asarray(courant), strides, jax.numpy.asarray(origin), 0
    )
    got = port_ops.courant_at_particles(
        torch.from_numpy(courant), strides, torch.from_numpy(origin), 0
    )
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_distributed_displacement_is_refused(sims, tmp_path):
    """``distributed_x`` is taken: on a group of one rank (the ring is the
    rank itself) the decomposed step, with its staggered courant halos, its
    MAX reduce of the substep count and its migration of the slab-crossers
    to the rank itself, moves every particle as the single-device step
    does in a sheared flow that needs substeps (the alive particles'
    positions, cell ids and multiplicities equal, rows matched by dry
    volume: the migration moves the crossers to other slots, and an
    arrival may fill the slot of a particle that died this step)"""
    tp = sims[1]
    cx = np.tile(np.linspace(-0.6, 0.6, GRID[1]), (GRID[0] + 1, 1))
    cz = np.tile(np.linspace(-0.3, 0.3, GRID[1] + 1), (GRID[0], 1))
    sim = dict(tp.sim_state)
    sim["env"] = {
        **sim["env"],
        "courant_0": torch.from_numpy(cx.ravel()),
        "courant_1": torch.from_numpy(cz.ravel()),
    }
    sim["counters"] = {
        **sim["counters"],
        "migration_dropped": torch.zeros(2, dtype=torch.int64),
        "migration_far_moves": torch.zeros(1, dtype=torch.int64),
    }
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
    )
    try:
        decomposed = pysdm_tpu_torch.dynamics.Displacement(
            enable_sedimentation=True,
            distributed_x=dict(
                group=torch.distributed.new_group([0]), capacity=64,
                overlap=False,
            ),
        )
        decomposed.particulator = tp
        got = decomposed.make_step(tp)(sim)
    finally:
        torch.distributed.destroy_process_group()
    want = tp.dynamics["Displacement"].make_step(tp)(sim)
    assert decomposed.host_reads == 1
    np.testing.assert_array_equal(
        got["counters"]["migration_dropped"].numpy(), [0, 0]
    )

    def rows(out):
        p = out["particles"]
        table = np.stack([
            p.ext("dry volume").numpy(), p.multiplicity.numpy(),
            p.cell_id.numpy(), *p.cell_origin.numpy(),
            *p.position_in_cell.numpy(),
        ])[:, p.multiplicity.numpy() > 0]
        return table[:, np.argsort(table[0], kind="stable")]

    before = tp.sim_state["particles"].cell_origin[0].numpy()
    after = want["particles"].cell_origin[0].numpy()
    assert (before != after).any(), "the flow must move particles across x"
    np.testing.assert_array_equal(rows(got), rows(want))
