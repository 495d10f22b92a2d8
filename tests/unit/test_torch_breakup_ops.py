"""The port's float64 breakup path (``pysdm_tpu_torch/ops/breakup.py``)
against the JAX package's (``pysdm_tpu/ops/breakup.py``) on both pairings
and both ``handle_all_breakups`` branches, and the cases of
``tests/unit/test_breakup_ops.py`` on the port: the closed-form transfer
against a per-event loop oracle (the semantics of reference
``collisions_methods.py:compute_transfer_multiplicities``), the limiters,
conservation and the bounce and coalescence branches; a case built to
reach each guard of ``handle_all_breakups``' loop.

Tolerances: multiplicities equal; extensive rows and the transfer's
floats to rtol 1e-12 (the same float64 operations; exp and log may round
an ulp apart between XLA and torch); counters to rtol 1e-6 (float32 sums
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops import breakup as jax_breakup
from pysdm_tpu.ops import pairing as jax_pairing
from pysdm_tpu.ops import segments as jax_seg
from pysdm_tpu_torch.ops import breakup
from pysdm_tpu_torch.ops.pairing import AdjacentPairing, MirrorPairing

MAX_MULTIPLICITY = 2**63 // int(2e5)
N_CELL = 3


def loop_oracle(gamma, mult_j, mult_k, mass_j, mass_k, fm, max_mult):
    """event-by-event transfer (the de Jong et al. 2023 breakup scheme):
    each of up to ``gamma`` events turns the pair's mass into fragments of
    mass ``fm``, bounded by j's multiplicity and the overflow cap"""
    take_test = mult_k
    take = 0.0
    nmk_test = (mass_j + mass_k) / fm * mult_k
    nmk = mult_k
    gjk = 0
    overflow = False
    for m in range(int(gamma)):
        if nmk_test > max_mult:
            overflow = True
            break
        if take_test > mult_j:
            break
        take = take_test
        nmk = nmk_test
        gjk = m + 1
        take_test += nmk_test
        nmk_test = nmk_test * (mass_j / fm) + nmk_test
    return take, nmk, gjk, overflow


def _transfer_inputs(seed, n=256):
    rng = np.random.default_rng(seed)
    gamma = rng.integers(0, 50, n).astype(float)
    mult_k = rng.integers(1, 10**6, n).astype(float)
    mult_j = mult_k * rng.integers(1, 100, n)
    mass_k = 10.0 ** rng.uniform(-15, -9, n)
    mass_j = mass_k * rng.uniform(1, 100, n)
    fm = (mass_j + mass_k) * 10.0 ** rng.uniform(-3, 0, n)
    return gamma, mult_j, mult_k, mass_j, mass_k, fm, 2**63 / 2e5


@pytest.mark.parametrize("seed", range(5))
def test_transfer_closed_form_matches_loop(seed):
    inputs = _transfer_inputs(seed)
    take, nmk, gjk, ovf = breakup._transfer_closed_form(
        *(torch.as_tensor(x, dtype=torch.float64) for x in inputs)
    )
    for i in range(inputs[0].shape[0]):
        t, m, g, o = loop_oracle(*(x[i] for x in inputs[:-1]), inputs[-1])
        assert int(gjk[i]) == g, f"i={i}: gamma_j_k {int(gjk[i])} != {g}"
        np.testing.assert_allclose(float(take[i]), t, rtol=1e-9)
        np.testing.assert_allclose(float(nmk[i]), m, rtol=1e-9)
        assert bool(ovf[i]) == o


@pytest.mark.parametrize("seed", range(2))
def test_transfer_closed_form_matches_jax_package(seed):
    inputs = _transfer_inputs(seed + 10)
    expected = jax_breakup._transfer_closed_form(
        *(jnp.asarray(x) for x in inputs)
    )
    got = breakup._transfer_closed_form(
        *(torch.as_tensor(x, dtype=torch.float64) for x in inputs)
    )
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(expected[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(expected[3]))
    for g, e in zip(got[:2], expected[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12)


def test_fragmentation_limiters():
    out = breakup.fragmentation_limiters(
        torch.tensor([np.nan, 0.0, 5.0, 0.5]), torch.ones(4)
    )
    np.testing.assert_allclose(out.numpy(), [1.0, 1.0, 1.0, 0.5])


@pytest.mark.parametrize(
    "kwargs", ({}, {"vmin_mass": 0.4}, {"vmin_mass": 0.1, "nfmax": 3}),
    ids=("plain", "vmin", "vmin-nfmax"),
)
def test_fragmentation_limiters_match_jax_package(kwargs):
    rng = np.random.default_rng(2)
    mass_sum = rng.uniform(0.0, 2.0, 64)
    mass_sum[:3] = 0.0
    frag = mass_sum * rng.uniform(-0.5, 1.5, 64)
    frag[3:6] = np.nan
    expected = jax_breakup.fragmentation_limiters(
        jnp.asarray(frag), jnp.asarray(mass_sum), **kwargs
    )
    got = breakup.fragmentation_limiters(
        torch.from_numpy(frag), torch.from_numpy(mass_sum), **kwargs
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def _counters(lib, n_cell=1):
    zeros = (
        (lambda dtype: torch.zeros(n_cell, dtype=dtype)) if lib is torch
        else (lambda dtype: jnp.zeros(n_cell, dtype))
    )
    f64, i64 = (
        (torch.float64, torch.int64) if lib is torch
        else (jnp.float64, jnp.int64)
    )
    return {
        "breakup_rate": zeros(f64),
        "breakup_rate_deficit": zeros(f64),
        "coalescence_rate": zeros(i64),
    }


def _pair_state(kind, n, seed):
    """a state for one substep: multiplicities 1-1000 with ties (equal
    multiplicities take their own branch with handle_all_breakups),
    masses 1e-12 to 1e-9, gamma 0-5, process draws, Ec and Eb that bounce,
    coalesce and break up, fragments of a tenth to all of the pair's mass;
    the JAX and the port pairing, the cells (adjacent)"""
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 1000, n).astype(np.int64)
    mult[rng.uniform(size=n) < 0.1] = 64
    mass = 10.0 ** rng.uniform(-12, -9, n)
    ext = np.stack([mass, rng.uniform(1e-18, 1e-16, n)])
    gamma = rng.integers(0, 6, n).astype(np.int64)
    rand = rng.uniform(size=n)
    Ec = rng.uniform(0.0, 0.5, n)
    Eb = rng.uniform(0.5, 1.0, n)
    frag = mass * rng.uniform(0.1, 1.0, n)
    frag[rng.uniform(size=n) < 0.05] = np.nan
    if kind == "mirror":
        K = n // 2 + 3
        jp = jax_pairing.MirrorPairing(K, n, jnp.asarray(mult > 0))
        tp = MirrorPairing(K, n, torch.from_numpy(mult > 0))
        cells = (None, None, None, 1)
    else:
        cell = jnp.asarray(rng.integers(0, N_CELL, n).astype(np.int32))
        order, sorted_cell, cell_start, is_first = jax_seg.bucket_shuffle(
            cell, jnp.asarray(mult > 0), jnp.asarray(rng.uniform(size=n)),
            N_CELL,
        )
        order = np.asarray(order)
        mult, ext = mult[order], ext[:, order]
        jp = jax_pairing.AdjacentPairing(is_first)
        tp = AdjacentPairing(torch.from_numpy(np.array(is_first)))
        cells = (
            sorted_cell, cell_start,
            torch.from_numpy(np.asarray(cell_start).astype(np.int64)), N_CELL,
        )
    return (mult, ext, gamma, rand, Ec, Eb, frag), jp, tp, cells


@pytest.mark.parametrize("kind", ("adjacent", "mirror"))
@pytest.mark.parametrize("handle_all", (False, True))
def test_collision_coalescence_breakup_matches_jax_package(kind, handle_all):
    (mult, ext, gamma, rand, Ec, Eb, frag), jp, tp, cells = _pair_state(
        kind, 2048, 11
    )
    sorted_cell, cell_start, t_cell_start, n_cell = cells
    names = ("signed water mass", "dry volume")
    jc = _counters(jnp, n_cell)
    j_mult, j_ext, jc = jax_breakup.collision_coalescence_breakup(
        mult_s=jnp.asarray(mult), ext_s=jnp.asarray(ext), ext_names=names,
        gamma=jnp.where(jp.is_first, jnp.asarray(gamma), 0),
        rand=jnp.asarray(rand), Ec=jnp.asarray(Ec), Eb=jnp.asarray(Eb),
        fragment_mass=jnp.asarray(frag), is_first=jp.is_first,
        sorted_cell=sorted_cell, cell_start=cell_start, n_cell=n_cell,
        counters=jc, max_multiplicity=MAX_MULTIPLICITY,
        handle_all_breakups=handle_all, formulae=None, pairing=jp,
    )
    tc = _counters(torch, n_cell)
    reads = []
    t_mult, t_ext = breakup.collision_coalescence_breakup(
        mult_s=torch.from_numpy(mult), ext_s=torch.from_numpy(ext),
        ext_names=names,
        gamma=torch.where(tp.is_first, torch.from_numpy(gamma), 0),
        rand=torch.from_numpy(rand), Ec=torch.from_numpy(Ec),
        Eb=torch.from_numpy(Eb), fragment_mass=torch.from_numpy(frag),
        pairing=tp, counters=tc, max_multiplicity=MAX_MULTIPLICITY,
        handle_all_breakups=handle_all, cell_start=t_cell_start,
        n_cell=n_cell, read=lambda t: reads.append(bool(t)) or reads[-1],
    )
    np.testing.assert_array_equal(t_mult.numpy(), np.asarray(j_mult))
    np.testing.assert_allclose(t_ext.numpy(), np.asarray(j_ext), rtol=1e-12)
    for name in tc:
        np.testing.assert_allclose(
            tc[name].numpy(), np.asarray(jc[name]), rtol=1e-6
        )
    assert tc["breakup_rate"].sum() > 0 and tc["coalescence_rate"].sum() > 0
    # the loop reads once after each run of iterations and once to stop;
    # the closed form reads nothing
    assert (len(reads) > 1) == handle_all and (not reads or not reads[-1])
    before = (mult * ext).sum(axis=1)
    after = (t_mult.numpy() * t_ext.numpy()).sum(axis=1)
    np.testing.assert_allclose(after, before, rtol=1e-10)


@pytest.mark.parametrize("handle_all", (False, True))
def test_breakup_conserves_mass_and_grows_multiplicity(handle_all):
    rng = np.random.default_rng(7)
    n_sd = 64
    mult = torch.from_numpy(rng.integers(1, 1000, n_sd))
    mass = torch.from_numpy(10.0 ** rng.uniform(-12, -9, n_sd))
    counters = _counters(torch)
    mult_out, ext_out = breakup.collision_coalescence_breakup(
        mult_s=mult, ext_s=mass[None, :], ext_names=("signed water mass",),
        gamma=torch.from_numpy(rng.integers(0, 4, n_sd)),
        rand=torch.full((n_sd,), 0.5),
        Ec=torch.zeros(n_sd),  # never coalesce
        Eb=torch.ones(n_sd),  # always break
        fragment_mass=mass / 3.0,  # fragments ~1/3 of a single droplet
        pairing=AdjacentPairing(torch.from_numpy(np.arange(n_sd) % 2 == 0)),
        counters=counters, max_multiplicity=MAX_MULTIPLICITY,
        handle_all_breakups=handle_all,
    )
    total_before = float((mult * mass).sum())
    total_after = float((mult_out * ext_out[0]).sum())
    # rounding multiplicities to integers rescales the attributes
    np.testing.assert_allclose(total_after, total_before, rtol=1e-6)
    assert int(mult_out.sum()) >= int(mult.sum())
    assert bool((mult_out >= 1).all())
    if handle_all:
        # all gamma consumed (no overflow at these sizes): zero deficit
        np.testing.assert_allclose(counters["breakup_rate_deficit"].numpy(), 0.0)


GUARDS = ("closed form without an event", "equal multiplicities overflow")


def _guard_state(guard, n_sd=64, gamma=3, seed=5):
    """adjacent pairs (slots 2i, 2i + 1) in one cell, every pair breaking
    up with ``gamma`` events; the even pairs built to reach ``guard`` of
    ``handle_all_breakups``: multiplicities 4e9 and 1e9 ("closed form
    without an event") or 1e9 and 1e9 ("equal multiplicities overflow"),
    masses 1e-9 kg and fragments of 1e-6 of the pair's mass, so that the
    first event would take the partner's multiplicity to ~1e15, past
    ``MAX_MULTIPLICITY``; the odd pairs ordinary (multiplicities 1-1000,
    unequal, fragments of a third of a drop), which spend their gamma.
    Returns (mult, mass, gamma, fragment mass, guarded pair mask by
    slot)"""
    rng = np.random.default_rng(seed)
    small = rng.integers(1, 500, n_sd // 2)
    mult = np.stack([2 * small + 1, small], axis=1).reshape(-1)
    mass = 10.0 ** rng.uniform(-12, -9, n_sd)
    frag = mass / 3.0
    guarded = (np.arange(n_sd) // 2) % 2 == 0
    lead = guarded & (np.arange(n_sd) % 2 == 0)
    mult[guarded] = 10**9
    if guard == GUARDS[0]:
        mult[lead] = 4 * 10**9
    mass[guarded] = 1e-9
    frag[guarded] = 2e-9 * 1e-6
    gammas = np.where(np.arange(n_sd) % 2 == 0, gamma, 0).astype(np.int64)
    return mult.astype(np.int64), mass, gammas, frag, guarded


@pytest.mark.parametrize("guard", GUARDS)
def test_handle_all_breakups_guard_matches_jax_package(guard):
    """each guard of ``handle_all_breakups``'s loop taken, in both packages
    alike: a guarded pair is left as it was and its remaining gamma times
    the partner's multiplicity goes to the deficit, once (the reference
    spins forever on the first guard's pairs and adds the deficit twice on
    the second's); the ordinary pairs break up and leave no deficit"""
    mult, mass, gamma, frag, guarded = _guard_state(guard)
    n_sd = mult.size
    is_first = np.arange(n_sd) % 2 == 0
    jc = _counters(jnp)
    j_mult, j_ext, jc = jax_breakup.collision_coalescence_breakup(
        mult_s=jnp.asarray(mult), ext_s=jnp.asarray(mass[None, :]),
        ext_names=("signed water mass",), gamma=jnp.asarray(gamma),
        rand=jnp.full(n_sd, 0.5), Ec=jnp.zeros(n_sd), Eb=jnp.ones(n_sd),
        fragment_mass=jnp.asarray(frag), is_first=jnp.asarray(is_first),
        sorted_cell=jnp.zeros(n_sd, dtype=jnp.int32), n_cell=1, counters=jc,
        max_multiplicity=MAX_MULTIPLICITY, handle_all_breakups=True,
        formulae=None,
    )
    tc = _counters(torch)
    t_mult, t_ext = breakup.collision_coalescence_breakup(
        mult_s=torch.from_numpy(mult), ext_s=torch.from_numpy(mass[None, :]),
        ext_names=("signed water mass",), gamma=torch.from_numpy(gamma),
        rand=torch.full((n_sd,), 0.5), Ec=torch.zeros(n_sd),
        Eb=torch.ones(n_sd), fragment_mass=torch.from_numpy(frag),
        pairing=AdjacentPairing(torch.from_numpy(is_first)), counters=tc,
        max_multiplicity=MAX_MULTIPLICITY, handle_all_breakups=True,
    )
    np.testing.assert_array_equal(t_mult.numpy(), np.asarray(j_mult))
    np.testing.assert_allclose(t_ext.numpy(), np.asarray(j_ext), rtol=1e-12)
    for name in tc:
        np.testing.assert_allclose(
            tc[name].numpy(), np.asarray(jc[name]), rtol=1e-6
        )
    # the guard taken: the guarded pairs as they were, their whole gamma
    # times the partner's multiplicity (1e9) in the deficit, once
    np.testing.assert_array_equal(t_mult.numpy()[guarded], mult[guarded])
    np.testing.assert_array_equal(t_ext.numpy()[0, guarded], mass[guarded])
    expected = float((gamma * guarded).sum()) * 1e9
    assert expected > 0
    np.testing.assert_allclose(tc["breakup_rate_deficit"].numpy(), [expected],
                               rtol=1e-12)
    # the ordinary pairs broke up
    assert t_mult.numpy()[~guarded].sum() > mult[~guarded].sum()
    assert float(tc["breakup_rate"].sum()) > 0


@pytest.mark.parametrize("max_unchecked", (4, 8))
def test_loop_result_does_not_depend_on_how_often_it_reads(
    max_unchecked, monkeypatch
):
    """``handle_all_breakups``'s loop reads its condition after each of its
    first ``_MAX_UNCHECKED`` iterations, then after runs of 2, 4, ... up to
    ``_MAX_UNCHECKED``: the iterations it runs with no pair active change
    no bit, so reading less often gives the state and counters of reading
    after every iteration (as the JAX package's ``while_loop`` does);
    ``tally`` counts every iteration run"""
    rng = np.random.default_rng(11)
    n_sd = 256
    mult = torch.from_numpy(rng.integers(1, 10**6, n_sd))
    mass = torch.from_numpy(10.0 ** rng.uniform(-12, -9, n_sd))
    args = dict(
        mult_s=mult, ext_s=mass[None, :], ext_names=("signed water mass",),
        gamma=torch.from_numpy(rng.integers(0, 40, n_sd)),
        rand=torch.full((n_sd,), 0.5), Ec=torch.zeros(n_sd),
        Eb=torch.ones(n_sd), fragment_mass=mass / 7.0,
        pairing=AdjacentPairing(torch.from_numpy(np.arange(n_sd) % 2 == 0)),
        max_multiplicity=MAX_MULTIPLICITY, handle_all_breakups=True,
    )
    runs = {}
    for cap in (1, max_unchecked):
        monkeypatch.setattr(breakup, "_MAX_UNCHECKED", cap)
        counters, reads, iterations = _counters(torch), [], []
        out = breakup.collision_coalescence_breakup(
            **args, counters=counters,
            read=lambda t: reads.append(bool(t)) or reads[-1],
            tally=iterations.append,
        )
        runs[cap] = (out, counters, reads, iterations)
    (want, c_want, r_want, i_want), (got, c_got, r_got, i_got) = (
        runs[1], runs[max_unchecked]
    )
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name in c_got:
        assert torch.equal(c_got[name], c_want[name])
    # read after every iteration: one read each and one to stop
    assert set(i_want) == {1} and len(r_want) == len(i_want) + 1
    assert i_got[:max_unchecked] == [1] * max_unchecked
    assert max(i_got) == max_unchecked and not r_got[-1]
    # fewer reads, fewer than max_unchecked idle iterations
    assert len(r_got) < len(r_want)
    assert sum(i_want) <= sum(i_got) < sum(i_want) + max_unchecked


def _branches(rand):
    n_sd = 8
    mult = torch.tensor([10, 4, 8, 8, 6, 6, 5, 3])
    mass = torch.full((n_sd,), 1e-10)
    counters = _counters(torch)
    mult_out, ext_out = breakup.collision_coalescence_breakup(
        mult_s=mult, ext_s=mass[None, :], ext_names=("signed water mass",),
        gamma=torch.ones(n_sd, dtype=torch.int64),
        rand=torch.full((n_sd,), rand), Ec=torch.full((n_sd,), 0.25),
        Eb=torch.full((n_sd,), 1.0 / 3.0), fragment_mass=mass / 2,
        pairing=AdjacentPairing(torch.tensor([True, False] * 4)),
        counters=counters, max_multiplicity=MAX_MULTIPLICITY,
        handle_all_breakups=False,
    )
    return mult, mass, mult_out, ext_out


def test_bounce_and_coalesce_branches():
    # rand = 0.9 > Ec + (1 - Ec) Eb = 0.5 for all: all bounce
    mult, mass, mult_out, ext_out = _branches(0.9)
    assert torch.equal(mult_out, mult)
    np.testing.assert_allclose(ext_out[0].numpy(), mass.numpy())
    # rand = 0.1 < Ec = 0.25: all coalesce; j loses gamma xi_k, k's mass
    # doubles
    mult, mass, mult_out, ext_out = _branches(0.1)
    np.testing.assert_allclose(
        float((mult_out * ext_out[0]).sum()), float((mult * mass).sum()),
        rtol=1e-12,
    )
    assert int(mult_out[0]) == 6 and int(mult_out[1]) == 4
    np.testing.assert_allclose(float(ext_out[0, 1]), 2e-10)
    # pair (8, 8): equal, so j is depleted and k splits 4/4
    assert int(mult_out[2]) == 4 and int(mult_out[3]) == 4
