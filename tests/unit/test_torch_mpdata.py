"""The port's MPDATA (``pysdm_tpu_torch/ops/mpdata.py``) against the JAX
package's (``pysdm_tpu/ops/mpdata.py``) in float64, on the cases of
``tests/unit/test_mpdata.py``: the exact shift at courant 1, periodic
conservation over n_iters x infinite gauge x FCT, extrapolated boundaries,
the third-order terms, a fixed point under a nondivergent advector with a
non-unit g-factor, and the 2D solid-body rotation. Both sides evaluate the
same formulas in the same order (the JAX side under jit, whose fusion
rounds a few intermediate values otherwise), so fields of order 1 agree to
rtol 1e-12 with atol 1e-15 (the rotation, 400 steps, to rtol 1e-11)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops.mpdata import mpdata_step as jax_step
from pysdm_tpu_torch.ops.mpdata import mpdata_step as port_step


def _both(psi, gc, g=None, steps=1, **opts):
    j = jnp.asarray(psi)
    t = torch.from_numpy(np.asarray(psi, dtype=np.float64))
    jgc = tuple(jnp.asarray(c) for c in gc)
    tgc = tuple(torch.from_numpy(np.asarray(c, dtype=np.float64)) for c in gc)
    jg = None if g is None else jnp.asarray(g)
    tg = None if g is None else torch.from_numpy(np.asarray(g, dtype=np.float64))
    step = jax.jit(lambda x: jax_step(x, jgc, jg, **opts))
    for _ in range(steps):
        j = step(j)
        t = port_step(t, tgc, tg, **opts)
    return np.asarray(j), t.numpy()


def _periodic_2d(rng, shape=(16, 24), c=0.4):
    gc_x = rng.uniform(-c, c, (shape[0] + 1, shape[1]))
    gc_z = rng.uniform(-c, c, (shape[0], shape[1] + 1))
    gc_x[-1] = gc_x[0]
    gc_z[:, -1] = gc_z[:, 0]
    return gc_x, gc_z


def test_courant_one_exact_shift():
    psi = np.random.default_rng(0).uniform(0, 1, 32)
    expected, got = _both(psi, (np.ones(33),), n_iters=1)
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got, np.roll(psi, 1), atol=1e-14)


@pytest.mark.parametrize("n_iters", (1, 2, 3))
@pytest.mark.parametrize("iga,fct", ((False, False), (True, False), (True, True), (False, True)))
def test_periodic_matches_jax_package_and_conserves(n_iters, iga, fct):
    rng = np.random.default_rng(1)
    psi = rng.uniform(0.1, 1, (16, 24))
    expected, got = _both(
        psi, _periodic_2d(rng), steps=5, n_iters=n_iters, infinite_gauge=iga,
        nonoscillatory=fct,
    )
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.sum(), psi.sum(), rtol=1e-12)


@pytest.mark.parametrize("iga, tot", ((False, False), (True, True), (False, True)))
def test_extrapolated_and_third_order_terms(iga, tot):
    rng = np.random.default_rng(2)
    psi = rng.uniform(0.1, 1, (12, 10))
    g = 1.0 + rng.uniform(0, 1, (12, 10))
    gc = (rng.uniform(-0.3, 0.3, (13, 10)), rng.uniform(-0.3, 0.3, (12, 11)))
    expected, got = _both(
        psi, gc, g, steps=3, n_iters=3, infinite_gauge=iga,
        nonoscillatory=True, third_order_terms=tot,
        bcs=("extrapolated", "periodic"),
    )
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)


def test_constant_field_fixed_point_nonunit_g():
    rng = np.random.default_rng(3)
    nx, nz = 12, 10
    stream = rng.uniform(-0.2, 0.2, (nx + 1, nz + 1))
    stream[-1, :] = stream[0, :]
    gc = (stream[:, 1:] - stream[:, :-1], -(stream[1:, :] - stream[:-1, :]))
    g = 1.0 + rng.uniform(0, 1, (nx, nz))
    expected, got = _both(
        np.full((nx, nz), 0.7), gc, g, steps=10, n_iters=2,
        infinite_gauge=True, nonoscillatory=True,
    )
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got, 0.7, atol=1e-12)


def test_solid_body_rotation_2d():
    n = 48
    xs = (np.arange(n) + 0.5) / n - 0.5
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    psi0 = np.exp(-((X + 0.25) ** 2 + Z**2) / (2 * 0.07**2))
    omega = 2 * np.pi
    dt = 0.12 / n
    xf = np.arange(n + 1) / n - 0.5
    _, Zc = np.meshgrid(xf, xs, indexing="ij")
    Xc, _ = np.meshgrid(xs, xf, indexing="ij")
    gc = (-omega * Zc * dt * n, omega * Xc * dt * n)
    expected, got = _both(
        psi0, gc, steps=int(round(1.0 / dt)), n_iters=2, infinite_gauge=True,
        nonoscillatory=True,
    )
    np.testing.assert_allclose(got, expected, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(got.sum(), psi0.sum(), rtol=1e-10)
    assert np.corrcoef(got.ravel(), psi0.ravel())[0, 1] > 0.97


def test_shard_halos_are_refused():
    with pytest.raises(NotImplementedError, match="slice 6"):
        port_step(
            torch.ones(4, 4), (torch.zeros(5, 4), torch.zeros(4, 5)),
            bcs=(("shard", "x"), "periodic"),
        )
