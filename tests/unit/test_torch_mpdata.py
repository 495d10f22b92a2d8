"""The port's MPDATA (``pysdm_tpu_torch/ops/mpdata.py``) against the JAX
package's (``pysdm_tpu/ops/mpdata.py``) in float64, on the cases of
``tests/unit/test_mpdata.py``: the exact shift at courant 1, periodic
conservation over n_iters x infinite gauge x FCT, extrapolated boundaries,
the third-order terms, a fixed point under a nondivergent advector with a
non-unit g-factor, and the 2D solid-body rotation. Both sides evaluate the
same formulas in the same order (the JAX side under jit, whose fusion
rounds a few intermediate values otherwise), so fields of order 1 agree to
rtol 1e-12 with atol 1e-15 (the rotation, 400 steps, to rtol 1e-11)."""

import datetime

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


def test_shard_halos_are_refused(tmp_path):
    """shard halos are taken: on a group of one rank the ``("shard",
    group)`` bc is the periodic one, bit for bit over 5 steps of the FCT
    scheme; a boundary condition of any other tuple raises"""
    rng = np.random.default_rng(8)
    psi = torch.from_numpy(rng.uniform(0.2, 1.0, (6, 4)))
    gc_x = rng.uniform(-0.3, 0.3, (7, 4))
    gc_x[-1] = gc_x[0]
    gc_z = rng.uniform(-0.3, 0.3, (6, 5))
    gc_z[:, -1] = gc_z[:, 0]
    gc = (torch.from_numpy(gc_x), torch.from_numpy(gc_z))
    opts = dict(n_iters=2, infinite_gauge=True, nonoscillatory=True)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
    )
    try:
        bc = ("shard", torch.distributed.new_group([0]))
        got = want = psi
        for _ in range(5):
            got = port_step(got, gc, bcs=(bc, "periodic"), **opts)
            want = port_step(want, gc, bcs=("periodic", "periodic"), **opts)
    finally:
        torch.distributed.destroy_process_group()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="boundary condition"):
        port_step(psi, gc, bcs=(("halo", 1), "periodic"))


def _column_couplings(dt):
    """the 1D column's MPDATA_1D coupling of each package, built as each
    package's Shipway and Hill 2012 model builds it (37 cells of 100 m)"""
    from pysdm_tpu.dynamics.eulerian_advection import MPDATA_1D as JaxMPDATA1D
    from pysdm_tpu.models import shipway_and_hill_2012 as jax_model
    from pysdm_tpu_torch.dynamics.eulerian_advection import MPDATA_1D
    from pysdm_tpu_torch.models import shipway_and_hill_2012 as port_model

    couplings = []
    for model, coupling in ((jax_model, JaxMPDATA1D), (port_model, MPDATA_1D)):
        settings = model.Settings(n_sd_per_gridbox=1, dz=100.0, dt=dt)
        z0 = -settings.particle_reservoir_depth
        z_faces = z0 + settings.dz * np.arange(settings.nz + 1)
        z_centres = z0 + settings.dz * (np.arange(settings.nz) + 0.5)
        couplings.append((settings, coupling(
            nz=settings.nz, dt=dt,
            advector_of_t=lambda t, s=settings: s.rho_times_w(t) * dt / s.dz,
            g_factor_z=settings.rhod_of_z(z_centres),
            g_factor_z_faces=settings.rhod_of_z(z_faces),
        )))
    return couplings


class _Particulator:
    dtype = torch.float64
    device = torch.device("cpu")


@pytest.mark.parametrize("steps", (1, 50))
def test_column_coupling_matches_jax_package(steps):
    """``MPDATA_1D`` of the 1D column against the JAX package's: the
    time-dependent scalar advector rho*w(t) dt / dz, extrapolated bounds,
    qv advected and thd passed through, the particle courant field; 50
    steps of 5 s from t = 475 s cross t_1 = 600 s, where the updraft
    stops"""
    dt, t0 = 5.0, 475.0
    (settings, jax_coupling), (_, port_coupling) = _column_couplings(dt)
    jax_step = jax_coupling.make_step(None)
    port_step_fn = port_coupling.make_step(_Particulator())
    z = -settings.particle_reservoir_depth + settings.dz * (
        np.arange(settings.nz) + 0.5
    )
    qv0 = settings.water_vapour_mixing_ratio(np.maximum(z, 0))
    thd0 = settings.thd_of_z(z)
    j_env = {"pred_qv": jnp.asarray(qv0), "pred_thd": jnp.asarray(thd0),
             "t": jnp.asarray(t0)}
    t_sim = {"env": {"pred_qv": torch.from_numpy(qv0.copy()),
                     "pred_thd": torch.from_numpy(thd0.copy())},
             "host": {"t": t0}}
    courant_max = 0.0
    for _ in range(steps):
        j_env = jax_step({"env": j_env})["env"]
        t_sim = port_step_fn(t_sim)
        for key in ("mpdata_qv", "mpdata_thd", "courant_0"):
            np.testing.assert_allclose(
                t_sim["env"][key].numpy(), np.asarray(j_env[key]), rtol=1e-12,
                atol=0, err_msg=key,
            )
        courant_max = max(courant_max, float(t_sim["env"]["courant_0"].max()))
        j_env = {**j_env, "pred_qv": j_env["mpdata_qv"], "t": j_env["t"] + dt}
        t_sim = {"env": {**t_sim["env"], "pred_qv": t_sim["env"]["mpdata_qv"]},
                 "host": {"t": t_sim["host"]["t"] + dt}}
    assert courant_max > 0
    np.testing.assert_array_equal(t_sim["env"]["mpdata_thd"].numpy(), thd0)
    if steps == 50:
        # past t_1 the advector is zero and the field stands still
        assert float(t_sim["env"]["courant_0"].abs().max()) == 0.0
