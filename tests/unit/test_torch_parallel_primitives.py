"""The port's distributed primitives (``pysdm_tpu_torch/parallel/``,
``ops/mpdata.py``'s shard bc) against the JAX package's, the counterpart
of ``tests/unit/test_parallel_primitives.py``.

The port's side runs in spawned gloo ranks on the CPU (one spawn of 8
ranks and one of 4 serve every case; ``parallel/verification.py``'s
``rank_*`` functions run inside them); the JAX side runs as its own tests
do, under ``shard_map`` on the emulated 8-device CPU mesh in this
process. float64 on both sides.

- Distributed MPDATA, ``iga``/``fct`` both ways, 16 x 12 over 8 ranks:
  bit-equal to the port's single-device periodic step (the halos are the
  periodic pad's values, the arithmetic per cell is the same), within
  1e-12 of the JAX distributed step.
- ``ring_halo_pad`` at 4 ranks equal to the JAX function's; its
  ``staggered`` form pads face arrays with the faces beyond the shared
  ones.
- ``migrate_ring``, and the overlap pair ``migrate_ring_start`` /
  ``migrate_ring_commit``, equal to the JAX functions slot for slot (int64
  and float64, exactly) at 8 ranks, with the JAX test's conservation
  checks; an overflow counts the same [send, place] drops.
- The overlap pair with a random permutation of every rank's slots
  between start and commit (the collision's sort): the particles of the
  inline ``migrate_ring`` on the unpermuted input, by identity, with the
  same drops (the JAX pair ships by stale per-slot flags there).
- ``classify_dest_shift`` flags far moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pysdm_tpu.ops.mpdata import mpdata_step as jax_mpdata_step
from pysdm_tpu.parallel import halo as jax_halo
from pysdm_tpu.parallel import migration as jax_migration
from pysdm_tpu_torch.ops.mpdata import mpdata_step
from pysdm_tpu_torch.parallel import migration, multihost, verification

N_DEV = 8
N_HALO = 4
NX, NZ = 16, 12
MPDATA_STEPS = 5
MPDATA_OPTS = ((False, False), (True, True))
HALO_CASES = ((0, 1), (0, 2), (1, 1), (1, 2))
N_LOCAL = 16


def _mpdata_inputs():
    rng = np.random.default_rng(5)
    psi = rng.uniform(0.2, 1.0, (NX, NZ))
    gc_x = rng.uniform(-0.3, 0.3, (NX + 1, NZ))
    gc_x[-1] = gc_x[0]  # periodic faces coincide
    gc_z = rng.uniform(-0.3, 0.3, (NX, NZ + 1))
    gc_z[:, -1] = gc_z[:, 0]
    g = 1.0 + rng.uniform(0.0, 1.0, (NX, NZ))
    nxl = NX // N_DEV
    # every slab's overlapping x faces, stacked along x
    gc_x_local = np.concatenate(
        [gc_x[i * nxl:i * nxl + nxl + 1] for i in range(N_DEV)], axis=0
    )
    return psi, gc_x, gc_x_local, gc_z, g


def _migration_inputs():
    """the JAX test's balanced flows: 4 out per direction per shard, 4
    graves"""
    rng = np.random.default_rng(9)
    mult = rng.integers(1, 100, N_DEV * N_LOCAL).astype(np.int64)
    payload = rng.uniform(0, 1, (3, N_DEV * N_LOCAL))
    shift = np.zeros(N_DEV * N_LOCAL, dtype=np.int32)
    local_slot = np.arange(N_DEV * N_LOCAL) % N_LOCAL
    shift[local_slot < 4] = 1
    shift[(local_slot >= 4) & (local_slot < 8)] = -1
    mult[(local_slot >= 8) & (local_slot < 12)] = 0  # graves
    shift[mult == 0] = 0
    payload[:, mult == 0] = 0.0
    return mult, payload, shift


def _overflow_inputs(graves, every=1):
    """6 movers forward on every ``every``-th shard, ``graves`` free slots
    on each"""
    mult = np.full(N_DEV * N_LOCAL, 5, dtype=np.int64)
    payload = np.arange(N_DEV * N_LOCAL, dtype=np.float64).reshape(1, -1)
    shift = np.zeros(N_DEV * N_LOCAL, dtype=np.int32)
    local_slot = np.arange(N_DEV * N_LOCAL) % N_LOCAL
    shard = np.arange(N_DEV * N_LOCAL) // N_LOCAL
    shift[(local_slot < 6) & (shard % every == 0)] = 1
    mult[(local_slot >= 6) & (local_slot < 6 + graves)] = 0
    return mult, payload, shift


# (inputs, capacity, rounds) of each migration case
MIGRATION_CASES = {
    "balanced": (_migration_inputs(), 8, 2),
    # 6 movers, 4 a pass, one pass: 2 send drops a shard
    "send_overflow": (_overflow_inputs(8), 4, 1),
    # the second pass takes the 2
    "two_rounds": (_overflow_inputs(8), 4, 2),
    # the odd shards get 6 and have no free slot
    "place_overflow": (_overflow_inputs(0, every=2), 4, 2),
}
# the [send, place] drops of each case, over all shards
DROPS = {"send_overflow": (16, 0), "two_rounds": (0, 0),
         "place_overflow": (0, 24)}
# the cases run again with a permutation between start and commit
PERMUTED_CASES = ("send_overflow", "two_rounds")
PERMUTATION_SEED = 61


@pytest.fixture(scope="module")
def port8():
    """one spawn of 8 ranks: both MPDATA cases, then every migration case
    inline and as the overlap pair, then the permuted cases"""
    psi, _, gc_x_local, gc_z, g = _mpdata_inputs()
    cases = [
        (verification.rank_mpdata, (
            psi, gc_x_local, gc_z, g, MPDATA_STEPS,
            dict(n_iters=2, infinite_gauge=iga, nonoscillatory=fct),
        ))
        for iga, fct in MPDATA_OPTS
    ]
    for (mult, payload, shift), cap, rounds in MIGRATION_CASES.values():
        for overlap in (False, True):
            cases.append((verification.rank_migration, (
                [mult, payload], shift, cap, rounds, overlap,
            )))
    for name in PERMUTED_CASES:
        (mult, payload, shift), cap, rounds = MIGRATION_CASES[name]
        cases.append((verification.rank_migration, (
            [mult, payload], shift, cap, rounds, True, "cpu", PERMUTATION_SEED,
        )))
    per_rank = multihost.spawn(verification.rank_cases, N_DEV, cases)
    # case by case, the ranks' blocks
    return list(zip(*per_rank))


def _faces():
    """periodic faces of 8 cells along axis 1 (face 8 is face 0), and the
    4 ranks' blocks of 3 faces (the first and last shared), stacked"""
    faces = np.random.default_rng(4).uniform(size=(5, 9))
    faces[:, -1] = faces[:, 0]
    blocks = np.concatenate([faces[:, 2 * r:2 * r + 3] for r in range(N_HALO)], axis=1)
    return faces, blocks


@pytest.fixture(scope="module")
def port4():
    """the halo cases, then the staggered one, at 4 ranks"""
    arr = np.random.default_rng(3).uniform(size=(8, 12, 3))
    cases = [
        (verification.rank_halo, (arr, axis, depth))
        for axis, depth in HALO_CASES
    ]
    cases.append((verification.rank_halo, (_faces()[1], 1, 1, "cpu", True)))
    per_rank = multihost.spawn(verification.rank_cases, N_HALO, cases)
    return arr, list(zip(*per_rank))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), axis_names=("x",))


def _joined(blocks, axis=-1):
    return np.concatenate(blocks, axis=axis)


@pytest.mark.parametrize("case", range(len(MPDATA_OPTS)))
def test_distributed_mpdata_matches_single_device(port8, mesh, case):
    iga, fct = MPDATA_OPTS[case]
    psi, gc_x, gc_x_local, gc_z, g = _mpdata_inputs()
    opts = dict(n_iters=2, infinite_gauge=iga, nonoscillatory=fct)
    got = _joined(port8[case], axis=0)

    single = torch.from_numpy(psi)
    for _ in range(MPDATA_STEPS):
        single = mpdata_step(
            single, (torch.from_numpy(gc_x), torch.from_numpy(gc_z)),
            torch.from_numpy(g), bcs=("periodic", "periodic"), **opts,
        )
    np.testing.assert_array_equal(got, single.numpy())

    @jax.jit
    def distributed(psi, gc_x_l, gc_z, g):
        def shard_fn(psi, gc_x_l, gc_z, g):
            out = psi
            for _ in range(MPDATA_STEPS):
                out = jax_mpdata_step(
                    out, (gc_x_l, gc_z), g,
                    bcs=(("shard", "x"), "periodic"), **opts,
                )
            return out

        return shard_map(
            shard_fn, mesh=mesh, in_specs=(P("x"),) * 4, out_specs=P("x"),
        )(psi, gc_x_l, gc_z, g)

    want = distributed(*(jnp.asarray(a) for a in (psi, gc_x_local, gc_z, g)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("case", range(len(HALO_CASES)))
def test_ring_halo_pad_matches_jax(port4, case):
    arr, results = port4
    axis, depth = HALO_CASES[case]
    mesh4 = Mesh(np.array(jax.devices()[:N_HALO]), axis_names=("x",))
    spec = P(*([None] * axis + ["x"]))

    @jax.jit
    def padded(a):
        return shard_map(
            lambda b: jax_halo.ring_halo_pad(b, axis, "x", depth=depth),
            mesh=mesh4, in_specs=(spec,), out_specs=spec,
        )(a)

    want = np.asarray(padded(jnp.asarray(arr)))
    np.testing.assert_array_equal(_joined(results[case], axis=axis), want)


def test_staggered_halo_takes_the_faces_beyond_the_shared_ones(port4):
    """a rank's faces padded with the neighbours' second-to-last and
    second faces: the faces of the cells either side, as on one device
    (the JAX package pads a displacement courant field with the shared
    face itself)"""
    faces, _ = _faces()
    _, results = port4
    periodic = np.concatenate([faces[:, -2:-1], faces, faces[:, 1:2]], axis=1)
    for r, got in enumerate(results[-1]):
        np.testing.assert_array_equal(got, periodic[:, 2 * r:2 * r + 5])


def _jax_migration(mesh, inputs, capacity, rounds, overlap):
    mult, payload, shift = inputs

    def shard_fn(mult, payload, shift):
        kwargs = dict(multiplicity_index=0, axis_name="x", capacity=capacity)
        if overlap:
            arrays, inflight = jax_migration.migrate_ring_start(
                arrays=[mult, payload], dest_shift=shift, **kwargs
            )
            arrays, dropped = jax_migration.migrate_ring_commit(
                arrays=arrays, inflight=inflight, rounds=rounds, **kwargs
            )
        else:
            arrays, dropped = jax_migration.migrate_ring(
                arrays=[mult, payload], dest_shift=shift, rounds=rounds,
                **kwargs,
            )
        return arrays[0], arrays[1], dropped

    run = jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("x"), P(None, "x"), P("x")),
        out_specs=(P("x"), P(None, "x"), P("x")),
    ))
    out = run(*(jnp.asarray(a) for a in (mult, payload, shift)))
    return [np.asarray(x) for x in out]


def _port_migration(port8, name, overlap):
    index = len(MPDATA_OPTS) + 2 * list(MIGRATION_CASES).index(name) + overlap
    blocks = port8[index]
    mult = _joined([b[0][0] for b in blocks])
    payload = _joined([b[0][1] for b in blocks])
    dropped = _joined([b[1] for b in blocks])
    return mult, payload, dropped


def _check_slot_for_slot(port8, mesh, name, overlap):
    inputs, capacity, rounds = MIGRATION_CASES[name]
    got = _port_migration(port8, name, overlap)
    want = _jax_migration(mesh, inputs, capacity, rounds, overlap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("overlap", (False, True))
def test_migrate_ring_conserves_particles(port8, mesh, overlap):
    (mult, payload, shift), _, _ = MIGRATION_CASES["balanced"]
    mult_out, payload_out, dropped = _check_slot_for_slot(
        port8, mesh, "balanced", overlap
    )
    assert int(dropped.sum()) == 0, "capacity was sufficient"
    assert mult_out.sum() == mult.sum()
    np.testing.assert_allclose(
        (payload_out * (mult_out > 0)).sum(), (payload * (mult > 0)).sum(),
        rtol=1e-12,
    )
    np.testing.assert_array_equal(
        np.sort(payload_out[0][mult_out > 0]), np.sort(payload[0][mult > 0])
    )
    # every mover landed on its neighbour
    for i in np.nonzero((mult > 0) & (shift != 0))[0]:
        dst = (i // N_LOCAL + shift[i]) % N_DEV
        seg = payload_out[0][dst * N_LOCAL:(dst + 1) * N_LOCAL]
        assert payload[0, i] in seg, f"particle {i} not on shard {dst}"


@pytest.mark.parametrize("name", ("send_overflow", "two_rounds", "place_overflow"))
@pytest.mark.parametrize("overlap", (False, True))
def test_migrate_ring_overflow_counts_dropped(port8, mesh, name, overlap):
    """a burst beyond the per-pass capacity rides the extra round; what
    exceeds rounds x capacity is a send drop, what finds no grave a
    placement drop, as the JAX function counts them"""
    (mult0, _, _), _, _ = MIGRATION_CASES[name]
    mult_out, _, dropped = _check_slot_for_slot(port8, mesh, name, overlap)
    dropped = dropped.reshape(N_DEV, 2).sum(axis=0)
    np.testing.assert_array_equal(dropped, DROPS[name])
    assert mult_out.sum() == mult0.sum() - int(dropped.sum()) * 5


@pytest.mark.parametrize("name", PERMUTED_CASES)
def test_overlap_commit_after_a_permutation_ships_the_leftovers(port8, name):
    """start, a random permutation of each rank's slots (standing in for
    the collision's cell sort between start and commit), commit: each rank
    ends with the particles of the inline ``migrate_ring`` on the
    unpermuted input, by (payload, multiplicity), with its [send, place]
    drops. The leftovers past the first round's capacity ride the stash,
    so the later rounds ship them and the send overflow kills them,
    wherever the permutation moved the residents (a per-slot pending
    flag, as in the JAX pair, would ship and kill residents instead)"""
    index = (len(MPDATA_OPTS) + 2 * len(MIGRATION_CASES)
             + PERMUTED_CASES.index(name))
    permuted = port8[index]
    inline = port8[len(MPDATA_OPTS) + 2 * list(MIGRATION_CASES).index(name)]
    for got, want in zip(permuted, inline):
        (g_mult, g_payload), g_dropped = got
        (w_mult, w_payload), w_dropped = want
        np.testing.assert_array_equal(g_dropped, w_dropped)
        g_alive, w_alive = g_mult > 0, w_mult > 0
        np.testing.assert_array_equal(
            np.sort(g_payload[0][g_alive]), np.sort(w_payload[0][w_alive])
        )
        # the payload is each particle's identity: its multiplicity too
        np.testing.assert_array_equal(
            g_mult[g_alive][np.argsort(g_payload[0][g_alive])],
            w_mult[w_alive][np.argsort(w_payload[0][w_alive])],
        )


def test_classify_dest_shift_flags_far_moves():
    nx_local = 4
    x = np.asarray([-9, -5, -4, -1, 0, 3, 4, 7, 8, 12], dtype=np.int32)
    mult = np.asarray([1, 1, 1, 1, 1, 1, 1, 1, 1, 0])
    dest, far = migration.classify_dest_shift(
        torch.from_numpy(x), nx_local, torch.from_numpy(mult)
    )
    np.testing.assert_array_equal(
        far.numpy(),
        [True, True, False, False, False, False, False, False, True, False],
    )
    np.testing.assert_array_equal(dest.numpy(), [0, 0, -1, -1, 0, 0, 1, 1, 0, 0])
    want_dest, want_far = jax_migration.classify_dest_shift(
        jnp.asarray(x), nx_local, jnp.asarray(mult)
    )
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
    np.testing.assert_array_equal(far.numpy(), np.asarray(want_far))

