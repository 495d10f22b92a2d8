"""Checks of the decomposition (port of
``pysdm_tpu/parallel/verification.py``), and the rank-side drivers that
the checks spawn.

Shard-count invariance: with collisions off every dynamic of the 2D
kinematic chain is deterministic (condensation, MPDATA, displacement,
migration), so the global state after N steps agrees between
decompositions up to float reassociation. Particles are matched across
runs by their dry volume, which is constant with collisions off and
distinct under the continuous spectral sampling, so the layout of the
slots (blocks, padding, sort order) cannot confound the comparison.

Each decomposition runs in its own set of spawned ranks
(``multihost.spawn``). The functions named ``rank_*`` run inside a rank:
they are module-level, so that a rank imports this package and nothing
of the caller's.
"""

import collections
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..dynamics.collisions.collision_kernels import Geometric
from ..models.arabas_et_al_2015 import Settings
from ..physics import Formulae
from . import migration, multihost

FIELDS = ("thd", "qv", "RH")


class CrosswindSettings(Settings):
    """a uniform strong horizontal flow (courant_x ~ 0.85 at dx = 93.75 m,
    dt = 5 s): every particle streams across the periodic x boundary,
    holding every slab boundary near the migration capacity"""

    U_RHOD = 17.5  # kg m^-2 s^-1

    def stream_function(self, xX, zZ, _):
        # psi = -u_rhod * Z * zZ: d(psi)/dz = -u_rhod, a uniform rhod * u
        return -self.U_RHOD * self.size[1] * zZ


def warm_rain_settings(*, seed, grid, n_sd_per_gridbox, size=(1500.0, 1500.0),
                       dt=5.0, crosswind=False, condensation_adaptive=True,
                       collection_efficiency=None):
    """the port's Arabas et al. 2015 ``Settings`` (``crosswind``:
    ``CrosswindSettings``; ``collection_efficiency``: a ``Geometric``
    kernel with it, 0 for a collision that sorts and never merges); as a
    ``functools.partial`` a settings factory that pickles"""
    cls = CrosswindSettings if crosswind else Settings
    settings = cls(
        Formulae(seed=seed), grid=grid, size=size, dt=dt,
        n_sd_per_gridbox=n_sd_per_gridbox,
    )
    settings.condensation_adaptive = condensation_adaptive
    if collection_efficiency is not None:
        settings.kernel = Geometric(collection_efficiency=collection_efficiency)
    return settings


def canonical_particles(sim, settings):
    """rows [dry volume, global x, global z, water mass, multiplicity] of
    every alive particle of every rank, ordered by dry volume (then
    multiplicity, where float32 dry volumes tie); a collective, the same
    on every rank"""
    p = sim.particulator
    parts = p.particles
    nx, nz = settings.grid
    sx, sz = sim.mesh_shape
    ix, iz = sim.tile
    origin = parts.cell_origin.double()
    pic = parts.position_in_cell.double()
    local = torch.stack([
        parts.ext("dry volume").double(),
        origin[0] + ix * (nx // sx) + pic[0],
        origin[1] + iz * (nz // sz) + pic[1],
        parts.ext("signed water mass").double(),
        parts.multiplicity.double(),
    ])
    rows = torch.cat(sim._gather(local), dim=1).cpu().numpy().T
    rows = rows[rows[:, 4] > 0]
    return rows[np.lexsort((rows[:, 4], rows[:, 0]))]


def _global_field(sim, settings, name):
    nx, nz = settings.grid
    return np.asarray(sim.get_env(name), dtype=np.float64).reshape(nx, nz)


def rank_warm_rain(settings_factory, checkpoints, sim_kwargs=None,
                   collisions=True, rows=False, backend_class=None,
                   probe=False, draw_seed=None, field_steps=False):
    """inside a rank: build a ``DistributedSimulation2D`` (CPU unless
    ``backend_class``; collisions off unless ``collisions``), record a
    snapshot, then run to each of ``checkpoints`` (step counts) and record
    one there. A snapshot holds the global diagnostics, the alive count of
    every rank, the migration counters, RH's extremes, the global cell ids'
    range, the finiteness of the water masses and the least multiplicity;
    with ``rows``, the last also ``canonical_particles`` and the global
    ``FIELDS`` (on rank 0 only). With ``probe``, the run goes under
    ``migration_probe`` and ``"probe"`` holds this rank's summaries of its
    x exchanges (``probe_summary``), one a step. ``draw_seed`` reseeds the
    rank's generators after the build: the same start, other draws. With
    ``field_steps``, the run goes one step at a time and ``"field_steps"``
    holds the global ``FIELDS`` after every step (on rank 0 only)."""
    from ..backends import CPU
    from .distributed_2d import DistributedSimulation2D, _rank_seed

    settings = settings_factory()
    sim = DistributedSimulation2D(
        settings, backend_class=backend_class or CPU, **(sim_kwargs or {})
    )
    p = sim.particulator
    if not collisions:
        p.set_flag("collision_enable", False)
    if draw_seed is not None:
        for gen in (p.rng, p.device_rng):
            gen.manual_seed(_rank_seed(draw_seed, sim.rank))
    snapshots, done = [], 0
    ctx = migration_probe() if probe else contextlib.nullcontext()
    per_step = []
    with ctx as records:
        for steps in (0, *checkpoints):
            while field_steps and done < steps:
                sim.run(1)
                done += 1
                fields = {f: _global_field(sim, settings, f) for f in FIELDS}
                per_step.append(fields)
            sim.run(steps - done)
            done = steps
            snapshots.append(
                _snapshot(sim, settings, rows and steps == checkpoints[-1])
            )
    out = {"capacity": p.n_sd, "snapshots": snapshots}
    if probe:
        out["probe"] = [probe_summary(r) for r in records]
    if field_steps and sim.rank == 0:
        out["field_steps"] = per_step
    return out


@contextlib.contextmanager
def migration_probe():
    """record every overlapped exchange that starts inside the block (a
    list, one dict per ``migrate_ring_start`` in call order): its stash,
    the rows of the slots its commit's later rounds ship (read from the
    state at each send), how many leftovers the commit put back into a
    slot other than the recorded one (``"away"``: the sort between start
    and commit moved a particle into it), its ``rounds``, ``capacity`` and
    [send, place] drops. Patches ``parallel.migration``'s functions for
    the block's duration (a passive probe: results are unchanged)."""
    real = {name: getattr(migration, name) for name in (
        "migrate_ring_start", "migrate_ring_commit", "_send_round",
        "_restore",
    )}
    records, by_inflight, current = [], {}, []

    def start(**kwargs):
        arrays, inflight = real["migrate_ring_start"](**kwargs)
        records.append({
            "stash": inflight["stash"], "capacity": kwargs["capacity"],
            "shipped": [],
        })
        by_inflight[id(inflight)] = records[-1]
        return arrays, inflight

    def commit(**kwargs):
        record = by_inflight.pop(id(kwargs["inflight"]))
        record["rounds"] = kwargs.get("rounds", 2)
        current.append(record)
        try:
            arrays, dropped = real["migrate_ring_commit"](**kwargs)
        finally:
            current.pop()
        record["dropped"] = dropped.tolist()
        return arrays, dropped

    def send_round(arrays, *args, **kwargs):
        out = real["_send_round"](arrays, *args, **kwargs)
        if current:
            departing = out[2]
            current[-1]["shipped"].append(
                [migration._as_rows(a)[:, departing] for a in arrays]
            )
        return out

    def restore(arrays, multiplicity_index, stash):
        arrays, target = real["_restore"](arrays, multiplicity_index, stash)
        if current:
            current[-1]["away"] = int((target != stash["slots"]).sum())
        return arrays, target

    patched = {"migrate_ring_start": start, "migrate_ring_commit": commit,
               "_send_round": send_round, "_restore": restore}
    for name, fn in patched.items():
        setattr(migration, name, fn)
    try:
        yield records
    finally:
        for name, fn in real.items():
            setattr(migration, name, fn)


def _columns(rows):
    """the particles of a list of row blocks as hashable columns (float64
    tuples of every row)"""
    block = torch.cat([r.double() for r in rows]).cpu().numpy()
    return [tuple(col) for col in block.T]


def probe_summary(record):
    """one ``migration_probe`` record as counts: ``stashed`` leftovers,
    ``expected`` (the first ``(rounds - 1) x capacity`` of each
    direction's, in the start's slot order: what the later rounds must
    ship), ``selected`` (what they shipped), ``matched`` (of those, the
    expected particles, by every row), ``away`` and the [send, place]
    ``dropped``"""
    stash = record["stash"]
    limit = (record["rounds"] - 1) * record["capacity"]
    direction = stash["direction"].cpu().numpy()
    columns = _columns(stash["rows"])
    expected = [
        col for d in migration.DIRECTIONS
        for col in [c for c, e in zip(columns, direction) if e == d][:limit]
    ]
    shipped = [c for rows in record["shipped"] for c in _columns(rows)]
    matched = collections.Counter(expected) & collections.Counter(shipped)
    return {
        "stashed": len(columns), "expected": len(expected),
        "selected": len(shipped), "matched": sum(matched.values()),
        "away": record.get("away", 0), "dropped": record["dropped"],
    }


def _snapshot(sim, settings, with_rows):
    p = sim.particulator
    mult = p.particles.multiplicity
    alive = mult > 0
    alive_per_rank = torch.cat(sim._gather(alive.sum().reshape(1)))
    cells = sim.global_cell_id()[
        torch.cat(sim._gather(alive)).cpu().numpy()
    ]
    rh = sim.get_env("RH")
    checks = torch.stack([
        (~torch.isfinite(p.particles.ext("signed water mass"))).sum(),
        -mult.min(),
    ]).double()
    dist.all_reduce(checks, op=dist.ReduceOp.MAX)
    out = {
        "steps": p.n_steps,
        "diagnostics": sim.global_diagnostics(),
        "alive_per_rank": alive_per_rank.tolist(),
        "migration_dropped": int(sim.get_counter("migration_dropped").sum()),
        "migration_far_moves": int(
            sim.get_counter("migration_far_moves").sum()
        ),
        "rh_max": float(rh.max()),
        "rh_finite": bool(np.isfinite(rh).all()),
        "cell_id_range": (int(cells.min()), int(cells.max())),
        "water_mass_nonfinite": int(checks[0]),
        "multiplicity_min": -int(checks[1]),
    }
    if with_rows:
        canonical = canonical_particles(sim, settings)
        fields = {f: _global_field(sim, settings, f) for f in FIELDS}
        if sim.rank == 0:
            out["rows"], out["fields"] = canonical, fields
    return out


def rank_cases(cases):
    """inside a rank: ``fn(*args)`` for each (fn, args) of ``cases``, in
    order (one spawn serves several checks)"""
    return [fn(*args) for fn, args in cases]


def _own_block(array, axis=-1, device="cpu"):
    """this rank's contiguous block of a host-replicated array, on
    ``device``"""
    moved = np.moveaxis(np.asarray(array), axis, -1)
    block = multihost.host_replicated_to_local(
        {"a": moved}, dist.get_rank(), dist.get_world_size()
    )["a"]
    return torch.as_tensor(np.moveaxis(block, -1, axis).copy(), device=device)


def rank_mpdata(psi, gc_x_blocks, gc_z, g, steps, opts):
    """inside a rank: ``steps`` MPDATA steps of this rank's x-slab of
    ``psi`` with an x bc of ring halos over the world; ``gc_x_blocks``
    stacks every slab's (nxl + 1)-face block along x. Returns the slab."""
    from ..ops.mpdata import PERIODIC, mpdata_step

    out = _own_block(psi, 0)
    gc = (_own_block(gc_x_blocks, 0), _own_block(gc_z, 0))
    g = _own_block(g, 0)
    for _ in range(steps):
        out = mpdata_step(
            out, gc, g, bcs=(("shard", None), PERIODIC), **opts
        )
    return out.numpy()


def rank_halo(arr, axis, depth, device="cpu", staggered=False):
    """inside a rank: its block of ``arr`` (split along ``axis``, on
    ``device``) padded by ``ring_halo_pad`` over the world"""
    from .halo import ring_halo_pad

    block = _own_block(arr, axis, device)
    padded = ring_halo_pad(block, axis, None, depth, staggered=staggered)
    return padded.cpu().numpy()


def rank_migration(arrays, shift, capacity, rounds, overlap, device="cpu",
                   permute_seed=None):
    """inside a rank: ``migrate_ring`` (or, with ``overlap``, the pair
    ``migrate_ring_start``/``migrate_ring_commit``) of this rank's blocks
    of ``arrays`` (multiplicity first; on ``device``) by ``shift``; with
    ``permute_seed``, the pair with a random permutation of the rank's
    slots between them (from the seed and the rank, standing in for the
    collision's sort). Returns the blocks and the [send, place] drops."""
    arrays = [_own_block(a, device=device) for a in arrays]
    shift = _own_block(shift, device=device)
    if overlap:
        arrays, inflight = migration.migrate_ring_start(
            arrays=arrays, multiplicity_index=0, dest_shift=shift,
            group=None, capacity=capacity,
        )
        if permute_seed is not None:
            order = np.random.default_rng(
                permute_seed + dist.get_rank()
            ).permutation(shift.shape[0])
            arrays = [a[..., torch.as_tensor(order, device=device)]
                      for a in arrays]
        arrays, dropped = migration.migrate_ring_commit(
            arrays=arrays, inflight=inflight, multiplicity_index=0,
            group=None, capacity=capacity, rounds=rounds,
        )
    else:
        arrays, dropped = migration.migrate_ring(
            arrays=arrays, multiplicity_index=0, dest_shift=shift,
            group=None, capacity=capacity, rounds=rounds,
        )
    return [a.cpu().numpy() for a in arrays], dropped.cpu().numpy()


def shard_invariance_report(
    settings_factory, shard_counts, steps, backend_class=None,
    fields=FIELDS, timeout=multihost.DEFAULT_TIMEOUT,
):
    """the deterministic (collision-off) decomposed case at each shard
    count, each in its own spawned gloo ranks, against the first count.
    Returns a dict of the largest differences; raises AssertionError where
    the alive counts, the identities or the multiplicities differ."""
    report = {}
    ref = None
    for n_shards in shard_counts:
        run = multihost.spawn(
            rank_warm_rain, n_shards, settings_factory, (steps,), None,
            False, True, backend_class, timeout=timeout,
        )[0]["snapshots"][-1]
        if ref is None:
            ref = run
            continue
        rows, ref_rows = run["rows"], ref["rows"]
        assert rows.shape == ref_rows.shape, (
            f"alive-count mismatch at n_shards={n_shards}: "
            f"{rows.shape} vs {ref_rows.shape}"
        )
        # the same global sampling, and multiplicities never change with
        # collisions off
        np.testing.assert_array_equal(
            rows[:, 0], ref_rows[:, 0],
            err_msg=f"particle identity mismatch at n_shards={n_shards}",
        )
        np.testing.assert_array_equal(
            rows[:, 4], ref_rows[:, 4],
            err_msg=f"multiplicity mismatch at n_shards={n_shards}",
        )
        # absolute errors: the stiff Koehler equilibrium amplifies
        # reassociation differences chaotically, and relative errors on
        # near-zero haze masses mean nothing
        report[f"position_max_abs_n{n_shards}"] = float(
            np.max(np.abs(rows[:, 1:3] - ref_rows[:, 1:3]))
        )
        report[f"water_mass_max_abs_n{n_shards}"] = float(
            np.max(np.abs(rows[:, 3] - ref_rows[:, 3]))
        )
        for f in fields:
            g, g_ref = run["fields"][f], ref["fields"][f]
            report[f"{f}_max_rel_n{n_shards}"] = float(np.max(
                np.abs(g - g_ref) / np.maximum(np.abs(g_ref), 1e-300)
            ))
    return report

