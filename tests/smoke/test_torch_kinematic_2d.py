"""The port's 2D warm rain (config #5, ``pysdm_tpu_torch/models/
arabas_et_al_2015.py``) against the JAX package on the CPU, at the size of
``tests/smoke/test_kinematic_2d.py`` (8 x 8 grid, 16 super-droplets per
cell), float64 on both sides.

- A spin-up of 20 steps (collisions and sedimentation off, so
  deterministic): thd, qv and RH agree to rtol 1e-12, the attributes to
  rtol 1e-9 (the wet radii equilibrated at build differ by ~1e-13 relative
  between NumPy and jnp and the implicit condensation solve carries that
  through; 3.5e-11 seen).
- Then 10 steps of rain, non-adaptive coalescence with sedimentation, the
  same injected u01 streams in both packages: multiplicities equal, masses
  to rtol 1e-9. The JAX side runs its TPU kernels in interpret mode
  (``PYSDM_TPU_PALLAS_INTERPRET``, the condensation kernel off), so its
  coalescence is ``fused_coalesce``, whose float32 semantics the port's K2
  twin shares; the rate counters are float32 per-cell sums taken in
  another order, hence rtol 1e-5.
- A JAX state carried across with ``sim_state_from_numpy``, then one step
  on each side that agrees (attributes to rtol 1e-10: only one step's
  summation order differs).
- The two tests of ``test_kinematic_2d.py`` on the port, adaptive
  coalescence: the cloud deck after a 5 min spin-up, and 10 min of rain
  with the water budget, precipitation included, closed to 1e-3.
"""

import jax
import numpy as np
import pytest

import pysdm_tpu
import pysdm_tpu.builder
import pysdm_tpu.dynamics
import pysdm_tpu.dynamics.eulerian_advection
from pysdm_tpu.models import arabas_et_al_2015 as jax_model
import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.models import arabas_et_al_2015 as port_model
from pysdm_tpu_torch.physics import si

GRID = (8, 8)
SPIN_UP_STEPS = 20
RAIN_STEPS = 10


def _build(pkg, model, settings, backend):
    """``make_simulation`` with u01 injection switched on before build and
    non-adaptive coalescence (both packages' classes, the same calls)"""
    from importlib import import_module

    dynamics = import_module(f"{pkg}.dynamics")
    advection = import_module(f"{pkg}.dynamics.eulerian_advection")
    environment = import_module(f"{pkg}.environments.kinematic_2d").Kinematic2D(
        dt=settings.dt, grid=settings.grid, size=settings.size,
        rhod_of=settings.rhod_of_zZ,
    )
    builder = import_module(pkg).Builder(
        n_sd=settings.n_sd, backend=backend(formulae=settings.formulae),
        environment=environment,
    )
    builder.enable_u01_injection()
    builder.add_dynamic(dynamics.AmbientThermodynamics())
    builder.add_dynamic(dynamics.Condensation(adaptive=True))
    advectees = {
        "th": np.repeat(
            settings.initial_dry_potential_temperature_profile.reshape(1, -1),
            settings.grid[0], axis=0,
        ),
        "water_vapour_mixing_ratio": np.repeat(
            settings.initial_vapour_mixing_ratio_profile.reshape(1, -1),
            settings.grid[0], axis=0,
        ),
    }
    builder.add_dynamic(dynamics.EulerianAdvection(advection.MPDATA_2D(
        advectees=advectees, stream_function=settings.stream_function,
        rhod_of_zZ=settings.rhod_of_zZ, dt=settings.dt, grid=settings.grid,
        size=settings.size, n_iters=2, infinite_gauge=True,
        nonoscillatory=True,
    )))
    builder.add_dynamic(dynamics.Displacement(enable_sedimentation=True))
    builder.add_dynamic(dynamics.Coalescence(
        collision_kernel=settings.kernel, adaptive=False
    ))
    attributes = environment.init_attributes(
        spatial_discretisation=import_module(
            f"{pkg}.initialisation.sampling.spatial_sampling"
        ).Pseudorandom(),
        dry_radius_spectrum=settings.spectrum_per_mass_of_dry_air,
        kappa=settings.kappa, seed=settings.formulae.seed,
    )
    particulator = builder.build(attributes)
    return particulator, model.SpinUp(particulator, 0)


def _inject(particulators, rng, n_sd):
    """the same u01 streams in both packages: shuffle draws tie-free in
    the packed key (k / 2^20 + 2^-22, exact in float32), gamma draws
    uniform"""
    shuffle = (rng.permutation(2**20)[:n_sd] / 2**20 + 2**-22).astype(np.float32)
    gamma = rng.uniform(size=n_sd)
    for p in particulators:
        p.inject_u01({"collision_shuffle": shuffle, "collision_gamma": gamma})


@pytest.fixture(scope="module", name="pair")
def _pair():
    """(jax particulator, port particulator, their spin-ups) after the
    spin-up"""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("PYSDM_TPU_NO_PALLAS_COND", "1")
    kwargs = dict(grid=GRID, n_sd_per_gridbox=16)
    jp, j_spin = _build(
        "pysdm_tpu", jax_model,
        jax_model.Settings(pysdm_tpu.Formulae(seed=44), **kwargs),
        pysdm_tpu.backends.CPU,
    )
    tp, t_spin = _build(
        "pysdm_tpu_torch", port_model,
        port_model.Settings(pysdm_tpu_torch.Formulae(seed=44), **kwargs), CPU,
    )
    jp.run(SPIN_UP_STEPS)
    tp.run(SPIN_UP_STEPS)
    yield jp, tp, j_spin, t_spin
    mp.undo()


def _assert_same(jp, tp, rtol_attr):
    for key in ("thd", "qv", "RH"):
        np.testing.assert_allclose(
            tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-12,
            err_msg=key,
        )
    for name in ("multiplicity", "cell id", "cell origin"):
        np.testing.assert_array_equal(
            tp.attributes[name], np.asarray(jp.attributes[name]), err_msg=name
        )
    for name in ("water mass", "dry volume", "position in cell"):
        np.testing.assert_allclose(
            tp.attributes[name], np.asarray(jp.attributes[name]),
            rtol=rtol_attr, err_msg=name,
        )
    np.testing.assert_array_equal(
        tp.get_counter("condensation_n_substeps"),
        np.asarray(jp.get_counter("condensation_n_substeps")),
    )


def test_spin_up_matches_jax_package(pair):
    jp, tp, _, _ = pair
    _assert_same(jp, tp, rtol_attr=1e-9)
    assert tp.get_counter("condensation_success").all()
    assert tp.get_env("RH").max() > 1.0


def test_rain_with_injected_u01_matches_jax_package(pair):
    jp, tp, j_spin, t_spin = pair
    j_spin.finish()
    t_spin.finish()
    mult0 = tp.attributes["multiplicity"]
    rng = np.random.default_rng(1)
    for _ in range(RAIN_STEPS):
        _inject((jp, tp), rng, tp.n_sd)
        jp.run(1)
        tp.run(1)
        np.testing.assert_allclose(
            tp.get_counter("precipitated_mass"),
            np.asarray(jp.get_counter("precipitated_mass")), rtol=1e-9,
        )
    _assert_same(jp, tp, rtol_attr=1e-9)
    for name in ("collision_rate", "coalescence_rate", "collision_rate_deficit"):
        np.testing.assert_allclose(
            tp.get_counter(name), np.asarray(jp.get_counter(name)), rtol=1e-5,
            err_msg=name,
        )
    assert (tp.attributes["multiplicity"] != mult0).any()
    assert tp.get_counter("coalescence_rate").sum() > 0


def test_state_carried_from_jax_package(pair):
    jp, tp, _, _ = pair
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    _inject((jp, tp), np.random.default_rng(2), tp.n_sd)
    jp.run(1)
    tp.run(1)
    # the states start equal: what differs is one step's summation order
    _assert_same(jp, tp, rtol_attr=1e-10)


def _total_water(p):
    vapour = float(np.sum(p.get_env("rhod") * p.get_env("qv") * p.mesh.dv))
    mult = p.attributes["multiplicity"].astype(float)
    liquid = float(np.sum(mult * p.attributes["water mass"]))
    return vapour + liquid + float(np.sum(p.get_counter("precipitated_mass")))


@pytest.fixture(scope="module", name="sim")
def _sim():
    settings = port_model.Settings(
        pysdm_tpu_torch.Formulae(seed=13), grid=GRID,
        size=(1500 * si.m, 1500 * si.m), dt=5 * si.s, n_sd_per_gridbox=16,
        spin_up_time=5 * si.minute,
    )
    particulator, spin_up = port_model.make_simulation(settings, backend_class=CPU)
    return settings, particulator, spin_up


def test_spin_up_activates_cloud_deck(sim):
    settings, p, _ = sim
    w0 = _total_water(p)
    lwc0 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    p.run(settings.n_spin_up)
    assert p.get_counter("condensation_success").all()
    rh = p.get_env("RH").reshape(settings.grid)
    assert np.isfinite(rh).all() and rh.max() < 1.10
    assert rh[:, -3:].max() > 0.99
    assert rh[:, :2].max() < 0.95
    lwc1 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    assert lwc1 > 5 * lwc0
    np.testing.assert_allclose(_total_water(p), w0, rtol=1e-3)
    assert float(np.sum(p.get_counter("precipitated_mass"))) == 0.0


def test_rain_phase_after_spin_up(sim):
    _, p, spin_up = sim
    spin_up.finish()
    w0 = _total_water(p)
    p.run(120)
    assert p.get_counter("condensation_success").all()
    assert float(np.sum(p.get_counter("coalescence_rate"))) > 0
    np.testing.assert_allclose(_total_water(p), w0, rtol=1e-3)
    r = p.attributes["radius"]
    alive = p.attributes["multiplicity"] > 0
    assert r[alive].max() > 1 * si.um


def test_make_simulation_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_model.make_simulation(port_model.Settings(grid=(2, 2), n_sd_per_gridbox=2))
