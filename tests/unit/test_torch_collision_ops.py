"""The port's float64 collision ops (``pysdm_tpu_torch/ops/collisions.py``
``compute_gamma`` and ``coalesce``, the pairings' ``merge``) against the
JAX package's (``pysdm_tpu/ops/collisions.py``) on both pairings, and the
cases of ``tests/unit/test_collision_ops.py`` on the port.

Tolerances: gamma and multiplicities equal; extensive and max-merged rows
to rtol 1e-12 (both sides round the same float64 operations, so they are
bit-equal in practice); integer counters exact, float counters to rtol
1e-6 (float32 sums in another order). The draws keep gamma's cap below 2^26
wherever the quotient xi_j / xi_k binds, where the JAX package's quotient
walk is exact (ROADMAP, "large-quotient gamma").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops import collisions as jax_ops
from pysdm_tpu.ops import pairing as jax_pairing
from pysdm_tpu.ops import segments as jax_seg
from pysdm_tpu_torch.ops import collisions as ops
from pysdm_tpu_torch.ops.pairing import AdjacentPairing, MirrorPairing

N_CELL = 3


def _counters(n_cell, lib=torch):
    """the three rate counters, in the JAX package's or the port's arrays"""
    if lib is torch:
        return {
            "collision_rate": torch.zeros(n_cell, dtype=torch.int64),
            "collision_rate_deficit": torch.zeros(n_cell, dtype=torch.float64),
            "coalescence_rate": torch.zeros(n_cell, dtype=torch.int64),
        }
    return {
        "collision_rate": jnp.zeros(n_cell, jnp.int64),
        "collision_rate_deficit": jnp.zeros(n_cell, jnp.float64),
        "coalescence_rate": jnp.zeros(n_cell, jnp.int64),
    }


def _draws(n, seed):
    """multiplicities 0-1000 (5% dead), two extensive rows, two max-merged
    rows with NaN (not recorded) in a fifth of the slots, probabilities
    0-40 and u01"""
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 1000, n).astype(np.int64)
    mult[rng.uniform(size=n) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, (2, n))
    maximum = rng.uniform(230.0, 270.0, (2, n))
    maximum[rng.uniform(size=(2, n)) < 0.2] = np.nan
    prob = rng.uniform(0.0, 40.0, n) ** 2 / 40.0
    rand = rng.uniform(size=n)
    return mult, ext, maximum, prob, rand


def _pairings(kind, mult, seed):
    """(JAX pairing, port pairing, JAX (sorted_cell, cell_start), port
    cell_start, n_cell, order of the state's slots)"""
    n = mult.shape[0]
    if kind == "mirror":
        K = 2 * n // 3 + 1
        alive = mult > 0
        jp = jax_pairing.MirrorPairing(K, n, jnp.asarray(alive))
        tp = MirrorPairing(K, n, torch.from_numpy(alive))
        return jp, tp, (None, None), None, 1, np.arange(n)
    rng = np.random.default_rng(seed + 1)
    cell = jnp.asarray(rng.integers(0, N_CELL, n).astype(np.int32))
    order, sorted_cell, cell_start, is_first = jax_seg.bucket_shuffle(
        cell, jnp.asarray(mult > 0), jnp.asarray(rng.uniform(size=n)), N_CELL
    )
    jp = jax_pairing.AdjacentPairing(is_first)
    tp = AdjacentPairing(torch.from_numpy(np.array(is_first)))
    return (
        jp, tp, (sorted_cell, cell_start),
        torch.from_numpy(np.asarray(cell_start).astype(np.int64)), N_CELL,
        np.asarray(order),
    )


@pytest.mark.parametrize("kind", ("adjacent", "mirror"))
@pytest.mark.parametrize("with_max", (False, True))
@pytest.mark.parametrize("seed", (0, 1))
def test_gamma_and_coalesce_match_jax_package(kind, with_max, seed):
    n = 1000
    mult, ext, maximum, prob, rand = _draws(n, seed)
    jp, tp, (sorted_cell, cell_start), t_cell_start, n_cell, order = (
        _pairings(kind, mult, seed)
    )
    mult, ext, maximum = mult[order], ext[:, order], maximum[:, order]
    prob = np.where(np.asarray(jp.is_first), prob, 0.0)

    jc = _counters(n_cell, jnp)
    j_gamma, jc = jax_ops.compute_gamma(
        jnp.asarray(prob), jnp.asarray(rand), jnp.asarray(mult), sorted_cell,
        jp.is_first, n_cell, jc, cell_start=cell_start, pairing=jp,
    )
    out = jax_ops.coalesce(
        jnp.asarray(mult), jnp.asarray(ext), j_gamma, jp.is_first,
        sorted_cell, n_cell, jc, cell_start=cell_start,
        max_s=jnp.asarray(maximum) if with_max else None, pairing=jp,
    )
    tc = _counters(n_cell)
    t_gamma = ops.compute_gamma(
        torch.from_numpy(prob), torch.from_numpy(rand),
        torch.from_numpy(mult), tp, tc, t_cell_start, n_cell,
    )
    got = ops.coalesce(
        torch.from_numpy(mult), torch.from_numpy(ext), t_gamma, tp,
        counters=tc, cell_start=t_cell_start, n_cell=n_cell,
        max_s=torch.from_numpy(maximum) if with_max else None,
    )
    np.testing.assert_array_equal(t_gamma.numpy(), np.asarray(j_gamma))
    assert (t_gamma.numpy() > 1).sum() > 10  # caps and multiple events
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(out[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(out[1]), rtol=1e-12)
    if with_max:
        np.testing.assert_allclose(
            got[2].numpy(), np.asarray(out[3]), rtol=1e-12
        )
        assert np.isnan(got[2].numpy()).any()
    else:
        assert got[2] is None
    for name in ("collision_rate", "coalescence_rate"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    np.testing.assert_allclose(
        tc["collision_rate_deficit"].numpy(),
        np.asarray(jc["collision_rate_deficit"]), rtol=1e-6,
    )
    assert tc["collision_rate_deficit"].sum() > 0


@pytest.mark.parametrize("kind", ("adjacent", "mirror"))
def test_merge_matches_jax_package(kind):
    n = 257
    rng = np.random.default_rng(5)
    mult = rng.integers(0, 3, n)
    jp, tp, *_ = _pairings(kind, mult, 5)
    orig, a_new, b_new = rng.uniform(size=(3, 2, n))
    for axis, pick in ((0, 0), (1, slice(None))):
        expected = jp.merge(
            jnp.asarray(orig[pick]), jnp.asarray(a_new[pick]),
            jnp.asarray(b_new[pick]), jp.is_first, axis=axis,
        )
        got = tp.merge(
            torch.from_numpy(orig[pick]), torch.from_numpy(a_new[pick]),
            torch.from_numpy(b_new[pick]), tp.is_first, axis=axis,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_mirror_merge_leaves_fixed_points_and_dead_pairs():
    """n = 8, K = 2: slots 1 and 5 pair with themselves; leaders take
    a_new, their partners b_new through the involution"""
    alive = torch.tensor([True] * 7 + [False])
    pairing = MirrorPairing(2, 8, alive)
    # pairs {0, 2}, {3, 7} (7 dead), {4, 6}; fixed points 1, 5
    assert pairing.is_first.nonzero().flatten().tolist() == [0, 4]
    orig = torch.arange(8.0)
    a_new = torch.full((8,), 100.0) + torch.arange(8.0)
    b_new = torch.full((8,), 200.0) + torch.arange(8.0)
    got = pairing.merge(orig, a_new, b_new, pairing.is_first)
    assert got.tolist() == [100.0, 1.0, 200.0, 3.0, 104.0, 5.0, 204.0, 7.0]


# --- the cases of tests/unit/test_collision_ops.py ----------------------------
def _adjacent(*is_first):
    return AdjacentPairing(torch.tensor(is_first))


class TestCoalesce:
    @staticmethod
    def test_basic_update():
        """xi=(5,2), gamma=2: j loses gamma*xi_k, k absorbs gamma copies of
        j's extensive attributes"""
        m, e, _ = ops.coalesce(
            torch.tensor([5, 2]), torch.tensor([[10.0, 4.0]]),
            torch.tensor([2, 0]), _adjacent(True, False),
            counters=_counters(1),
        )
        assert m.tolist() == [1, 2]
        assert e[0].tolist() == [10.0, 24.0]

    @staticmethod
    def test_split_on_equal_removal():
        """when xi_j - gamma*xi_k == 0 the j slot is recycled: k's
        multiplicity is halved between the two slots and attributes
        equalized (reference ``collisions_methods.py:52-59``)"""
        m, e, _ = ops.coalesce(
            torch.tensor([4, 2]), torch.tensor([[10.0, 4.0]]),
            torch.tensor([2, 0]), _adjacent(True, False),
            counters=_counters(1),
        )
        assert m.tolist() == [1, 1]
        np.testing.assert_allclose(e[0].numpy(), [24.0, 24.0])

    @staticmethod
    def test_maximum_attribute_merge():
        """maximum attributes (e.g. freezing temperature) take the pairwise
        max on merge; pair (0,1) collides (j=0 absorbs into k=1), pair
        (2,3) does not; then a split, where both halves carry the pair
        max"""
        _, _, x = ops.coalesce(
            torch.tensor([5, 2, 3, 1]), torch.tensor([[10.0, 4.0, 1.0, 1.0]]),
            torch.tensor([2, 0, 0, 0]), _adjacent(True, False, True, False),
            counters=_counters(1),
            max_s=torch.tensor([[250.0, 260.0, 240.0, 270.0]]),
        )
        assert x[0].tolist() == [250.0, 260.0, 240.0, 270.0]
        m, _, x = ops.coalesce(
            torch.tensor([4, 2]), torch.tensor([[10.0, 4.0]]),
            torch.tensor([2, 0]), _adjacent(True, False),
            counters=_counters(1), max_s=torch.tensor([[270.0, 250.0]]),
        )
        assert m.tolist() == [1, 1]
        assert x[0].tolist() == [270.0, 270.0]

    @staticmethod
    def test_unrecorded_maximum_loses_to_a_record():
        """NaN marks "not recorded": the merged droplet takes the record"""
        _, _, x = ops.coalesce(
            torch.tensor([5, 2]), torch.tensor([[10.0, 4.0]]),
            torch.tensor([2, 0]), _adjacent(True, False),
            max_s=torch.tensor([[250.0, float("nan")]]),
        )
        assert x[0].tolist() == [250.0, 250.0]

    @staticmethod
    def test_mass_and_number_invariants_random():
        rng = np.random.default_rng(3)
        n = 128
        mult = rng.integers(1, 1000, n)
        ext = rng.uniform(1e-12, 1e-9, (2, n))
        is_first = torch.from_numpy(np.arange(n) % 2 == 0)
        mult_p = np.roll(mult, -1)
        gamma = np.minimum(
            rng.integers(0, 3, n),
            np.maximum(mult, mult_p) // np.minimum(mult, mult_p),
        )
        m, e, _ = ops.coalesce(
            torch.from_numpy(mult), torch.from_numpy(ext),
            torch.from_numpy(gamma), AdjacentPairing(is_first),
            counters=_counters(1),
        )
        before = (mult * ext).sum(axis=1)
        after = (m.numpy() * e.numpy()).sum(axis=1)
        np.testing.assert_allclose(after, before, rtol=1e-12)
        assert (m.numpy() >= 0).all()


class TestComputeGamma:
    @staticmethod
    def test_gamma_cap_and_deficit():
        """gamma = min(ceil(prob - rand), floor(xi_j / xi_k)); the excess
        goes to the collision rate deficit (reference
        ``collisions_methods.py:522-560``)"""
        counters = _counters(1)
        gamma = ops.compute_gamma(
            torch.tensor([10.0, 0.0]), torch.tensor([0.5, 0.0]),
            torch.tensor([7, 2]), _adjacent(True, False), counters,
            torch.tensor([0, 2]), 1,
        )
        assert gamma.tolist() == [3, 0]  # capped at 7 // 2
        assert counters["collision_rate"][0] == 3 * 2
        assert counters["collision_rate_deficit"][0] == (10 - 3) * 2

    @staticmethod
    def test_gamma_of_a_huge_probability_is_the_quotient():
        """a probability far past int64 gives gamma = floor(xi_j / xi_k)"""
        gamma = ops.compute_gamma(
            torch.tensor([1e30, 0.0]), torch.tensor([0.5, 0.0]),
            torch.tensor([7 * 2**40, 2]), _adjacent(True, False),
        )
        assert gamma.tolist() == [7 * 2**39, 0]


def test_gamma_exact_where_the_jax_quotient_walk_is_not():
    """the port's recorded departure (ROADMAP, "large-quotient gamma"): with
    floor(xi_j / xi_k) near 1.3e9, below the cap, the JAX package's f32
    quotient estimate and +-5 walk miss the floor (here they overshoot it,
    which leaves xi_j - gamma xi_k negative); the port divides exactly"""
    mult = np.array([2 * 1_294_221_640 + 1, 2, 5, 5], dtype=np.int64)
    prob = np.array([2e9, 0.0, 0.5, 0.0])
    rand = np.full(4, 0.25)
    is_first = np.array([True, False, True, False])
    expected, _ = jax_ops.compute_gamma(
        jnp.asarray(prob), jnp.asarray(rand), jnp.asarray(mult),
        jnp.zeros(4, jnp.int32), jnp.asarray(is_first), 1,
    )
    got = ops.compute_gamma(
        torch.from_numpy(prob), torch.from_numpy(rand), torch.from_numpy(mult),
        AdjacentPairing(torch.from_numpy(is_first)),
    )
    assert got.tolist() == [1_294_221_640, 0, 1, 0]
    assert int(expected[0]) > 1_294_221_640
    assert np.asarray(expected)[2:].tolist() == [1, 0]


class TestNormalizationFactor:
    @staticmethod
    def test_shima_eq20():
        norm = ops.normalization_factor(
            torch.tensor([0, 5, 5, 8]), 2.0, 10.0, torch.float64
        )
        expected = [2.0 / 10.0 * 5 * 4 / 2 / 2, 0.0, 2.0 / 10.0 * 3 * 2 / 2 / 1]
        np.testing.assert_allclose(norm.numpy(), expected)
