"""``tests/unit/test_pairing.py`` and ``tests/unit/test_segments.py``'s
croupier statistics replayed on the port:

- ``test_exactly_uniform_pair_marginals``: the port's ``MirrorPairing``
  (``ops/pairing.py``) makes each unordered pair a candidate exactly once
  over the n values of K, its leaders equal to the JAX package's;
- ``test_box_mirror_vs_sort_croupier_statistics``: the Golovin box at
  2^12 for 40 steps on both croupiers, three seeds each, on the port's own
  draws (the mirror croupier's K from ``rng``, the sort croupier's bits
  from ``device_rng``); the ensemble means within the JAX test's 5%;
- ``test_croupier_uniformity`` (``test_segments.py``): the sort croupier's
  permutation of one 64-slot cell, from the bits ``Collision._draw_sorted``
  draws, 2000 times: the slot-by-position counts within the JAX test's
  5-sigma chi-square band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops.pairing import MirrorPairing as JaxMirrorPairing
from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.impl.state import ParticleState
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Exponential
from pysdm_tpu_torch.ops import segments
from pysdm_tpu_torch.ops.pairing import MirrorPairing
from pysdm_tpu_torch.physics import si


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [6, 7])
def test_exactly_uniform_pair_marginals(n):
    """over the n equally-likely K values, each unordered pair {i,j} is a
    candidate exactly once => P(candidate) = 1/n for every pair"""
    alive = torch.ones(n, dtype=torch.bool)
    counts = {}
    for K in range(n):
        p = MirrorPairing(K, n, alive)
        first = p.is_first.numpy()
        np.testing.assert_array_equal(
            first, np.asarray(JaxMirrorPairing(K, n, jnp.ones(n, bool)).is_first)
        )
        partner = p.partner_index.numpy()
        for i in np.where(first)[0]:
            pair = (min(i, partner[i]), max(i, partner[i]))
            counts[pair] = counts.get(pair, 0) + 1
    all_pairs = {(i, j) for i in range(n) for j in range(i + 1, n)}
    assert set(counts) == all_pairs
    assert set(counts.values()) == {1}


def _golovin_box(seed, croupier, n_sd=2**12):
    formulae = Formulae(seed=seed)
    env = Box(dt=1.0 * si.s, dv=1e6 * si.m**3)
    builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
    spectrum = Exponential(norm_factor=8.39e12, scale=4.19e-15 * si.m**3)
    volume, mult = ConstantMultiplicity(spectrum).sample(n_sd)
    builder.add_dynamic(Coalescence(
        collision_kernel=Golovin(b=1.5e3 / si.s), croupier=croupier,
    ))
    return builder.build(attributes={
        "multiplicity": mult,
        "water mass": volume * formulae.constants.rho_w,
    })


def test_box_mirror_vs_sort_croupier_statistics():
    """full box coalescence: the mirror croupier reproduces the sort
    croupier's droplet count statistically (the ensemble means of three
    seeds within 5%)"""
    results = {}
    for croupier in ("mirror", "sort"):
        totals = []
        for seed in (1, 2, 3):
            particulator = _golovin_box(seed, croupier)
            route = particulator.dynamics["Collision"]._uses_mirror()
            assert route == (croupier == "mirror")
            particulator.run(40)
            totals.append(float(particulator.attributes["multiplicity"].sum()))
        results[croupier] = np.mean(totals)
    # droplet count decays by ~half over the run; croupiers must agree on the
    # ensemble mean within a few percent
    assert results["mirror"] == pytest.approx(results["sort"], rel=0.05)


def test_croupier_uniformity():
    """sorting by i.i.d. uniform keys yields a uniform random permutation:
    each particle appears in each slot with equal frequency"""
    n, trials = 64, 2000
    particulator = _golovin_box(7, "sort", n_sd=n)
    collision = particulator.dynamics["Collision"]
    ids = torch.arange(n, dtype=torch.float64)
    particles = ParticleState.from_numpy(
        multiplicity=np.ones(n, dtype=np.int64), extensive=ids[None].numpy(),
        ext_names=("id",), cell_id=np.zeros(n, dtype=np.int32),
        cell_origin=np.zeros((0, n), dtype=np.int32),
        position_in_cell=np.zeros((0, n)),
    )
    counts = np.zeros((n, n))
    for _ in range(trials):
        bits, _ = collision._draw_sorted(particulator.sim_state, 0)
        shuffled, *_ = segments.bucket_shuffle_state(particles, bits, 1)
        order = shuffled.ext("id").numpy().astype(int)
        counts[np.arange(n), order] += 1
    expected = trials / n
    chi2 = ((counts - expected) ** 2 / expected).sum()
    dof = (n - 1) ** 2
    # chi2 ~ N(dof, sqrt(2 dof)) for large dof; 5 sigma acceptance
    assert abs(chi2 - dof) < 5 * np.sqrt(2 * dof)
