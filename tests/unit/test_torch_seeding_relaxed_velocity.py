"""Seeding, RelaxedVelocity and ``init_fall_momenta`` on the port's CPU
backend (float64), against the JAX package:
- ``test_seeding_injects_into_graves`` and
  ``test_relaxed_velocity_approaches_terminal`` of
  ``tests/unit/test_seeding_relaxed_velocity.py`` replayed on the port;
- RelaxedVelocity step by step against the JAX package (both timescale
  forms), the momentum to rtol 1e-12;
- ``init_fall_momenta`` against the JAX function at rtol 1e-12 for both
  terminal-velocity branches (the Gunn-Kinzer table and a formula's
  ``v_term``);
- the seeding parcel (``models/seeding.py``) with collisions off and a pool
  whose entries are all equal, so that the permutation cannot matter: the
  super-droplet count equal at every step, the environment to rtol 1e-10
  and the water masses to 1e-8 (the parcel tests' bounds, see
  ``tests/smoke/test_torch_activation_parcels.py``);
- ``TestSeeding::test_seeding_injects_and_rains`` on the port, collisions
  on (K1's twin: the two packages agree only statistically there);
- JAX states carried across with ``sim_state_from_numpy``: the seeding
  parcel's grave slots and the momentum row;
- the seeding model's default backend is the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.environments
from pysdm_tpu.initialisation import init_fall_momenta as jax_init_fall_momenta
from pysdm_tpu.models import seeding as jax_seeding

import pysdm_tpu_torch
from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import RelaxedVelocity, Seeding
from pysdm_tpu_torch.dynamics.terminal_velocity import gunn_kinzer_v_term
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.initialisation import init_fall_momenta
from pysdm_tpu_torch.models import seeding
from pysdm_tpu_torch.physics import si

ENV_KEYS = ("thd", "qv", "rhod", "T", "p", "RH", "z")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_seeding_injects_into_graves():
    """``test_seeding_injects_into_graves`` on the port: the Box keeps no
    clock, so the injection rate sees t = 0"""
    n_sd = 32
    formulae = Formulae(seed=6)
    env = Box(dt=1 * si.s, dv=1 * si.m**3)
    builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
    seeds = {"water mass": np.full(4, 5e-10)}
    builder.add_dynamic(Seeding(
        super_droplet_injection_rate=lambda t: 2 * (t < 2.0),
        seeded_particle_extensive_attributes=seeds,
        seeded_particle_multiplicity=np.full(4, 100.0),
    ))
    mult = np.ones(n_sd)
    mult[8:] = np.nan  # reserved slots
    particulator = builder.build({
        "multiplicity": mult, "water mass": np.full(n_sd, 1e-12),
    })
    assert int((particulator.attributes["multiplicity"] > 0).sum()) == 8
    particulator.run(1)
    alive = particulator.attributes["multiplicity"]
    assert int((alive > 0).sum()) == 10
    assert int(alive.sum()) == 8 + 2 * 100
    wm = particulator.attributes["water mass"]
    assert np.isclose(wm[alive == 100], 5e-10).all()
    # the free slots are filled in slot order
    np.testing.assert_array_equal(np.flatnonzero(alive == 100), [8, 9])


def test_seeding_stops_when_the_graves_are_full():
    """more to inject than free slots: only the free slots are filled"""
    formulae = Formulae(seed=6)
    builder = Builder(n_sd=8, backend=CPU(formulae), environment=Box(dt=1.0, dv=1.0))
    builder.add_dynamic(Seeding(
        super_droplet_injection_rate=lambda t: 5,
        seeded_particle_extensive_attributes={"water mass": np.full(6, 5e-10)},
        seeded_particle_multiplicity=np.arange(1.0, 7.0),
    ))
    mult = np.ones(8)
    mult[5:] = np.nan
    p = builder.build({"multiplicity": mult, "water mass": np.full(8, 1e-12)})
    p.run(1)
    alive = p.attributes["multiplicity"]
    assert (alive > 0).all()
    # three distinct seeds of the pool, by the permutation
    assert len(set(alive[5:])) == 3 and set(alive[5:]) <= set(range(1, 7))
    p.run(1)
    np.testing.assert_array_equal(p.attributes["multiplicity"], alive)


def _relaxed_velocity_box(pkg, backend, c=8.0, constant=False, n_sd=16):
    formulae = pkg.Formulae(seed=6)
    env = pkg.environments.Box(dt=0.1 * si.s, dv=1 * si.m**3)
    builder = pkg.Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic(pkg.dynamics.RelaxedVelocity(c=c, constant=constant))
    water_mass = np.geomspace(1e-12, 1e-7, n_sd)
    init = pkg.initialisation.init_fall_momenta
    return builder.build({
        "multiplicity": np.ones(n_sd),
        "water mass": water_mass,
        "relative fall momentum": 0.5 * init(water_mass, formulae),
    })


def test_relaxed_velocity_approaches_terminal():
    """``test_relaxed_velocity_approaches_terminal`` on the port"""
    n_sd = 16
    formulae = Formulae(seed=6)
    env = Box(dt=0.1 * si.s, dv=1 * si.m**3)
    builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
    builder.add_dynamic(RelaxedVelocity(c=8.0))
    water_mass = np.full(n_sd, 1e-9)  # ~ 62 um radius
    particulator = builder.build({
        "multiplicity": np.ones(n_sd),
        "water mass": water_mass,
        "relative fall momentum": init_fall_momenta(water_mass, formulae, zero=True),
    })
    v0 = particulator.attributes["relative fall velocity"]
    np.testing.assert_allclose(v0, 0.0)
    for steps in (5, 200):
        particulator.run(steps)
    v1 = particulator.attributes["relative fall velocity"]
    radius = particulator.attributes["radius"]
    v_term = gunn_kinzer_v_term(torch.as_tensor(radius)).numpy()
    np.testing.assert_allclose(v1, v_term, rtol=1e-3)


@pytest.mark.parametrize("constant", (False, True))
def test_relaxed_velocity_matches_jax_package_step_by_step(constant):
    c = 0.5 if constant else 8.0
    jp = _relaxed_velocity_box(pysdm_tpu, pysdm_tpu.backends.CPU, c, constant)
    tp = _relaxed_velocity_box(pysdm_tpu_torch, CPU, c, constant)
    for step in range(5):
        jp.run(1)
        tp.run(1)
        for name in ("relative fall momentum", "relative fall velocity",
                     "sqrt radius"):
            np.testing.assert_allclose(
                tp.attributes[name], np.asarray(jp.attributes[name]),
                rtol=1e-12, err_msg=f"{name} at step {step}",
            )


def test_momentum_row_carried_across():
    jp = _relaxed_velocity_box(pysdm_tpu, pysdm_tpu.backends.CPU)
    tp = _relaxed_velocity_box(pysdm_tpu_torch, CPU)
    jp.run(3)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    assert "relative fall momentum" in tp.sim_state["particles"].ext_names
    jp.run(2)
    tp.run(2)
    np.testing.assert_allclose(
        tp.attributes["relative fall momentum"],
        np.asarray(jp.attributes["relative fall momentum"]), rtol=1e-12,
    )


@pytest.mark.parametrize("variant", ("GunnKinzer1949", "RogersYau"))
def test_init_fall_momenta_matches_jax_package(variant):
    water_mass = np.geomspace(1e-15, 1e-5, 41)
    got = init_fall_momenta(water_mass, Formulae(terminal_velocity=variant))
    want = np.asarray(jax_init_fall_momenta(
        water_mass, pysdm_tpu.Formulae(terminal_velocity=variant)
    ))
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(
        init_fall_momenta(water_mass, zero=True), np.zeros_like(water_mass)
    )


# --- the seeding parcel -----------------------------------------------------
def _injection_rate(time):
    """one super-droplet per step within a 100 s window (the JAX test's)"""
    return np.where((time >= 300.0) & (time < 400.0), 1.0, 0.0)


def _seeding_settings(module, formulae, equal_pool, **kwargs):
    settings = module.Settings(
        super_droplet_injection_rate=_injection_rate, formulae=formulae,
        n_sd_initial=64, n_sd_seeding=16, **kwargs,
    )
    if equal_pool:
        # every seed of the pool alike: the permutation cannot matter
        ext = settings.seeded_particle_extensive_attributes
        for name, value in ext.items():
            ext[name] = np.full_like(value, np.mean(value))
        settings.seeded_particle_multiplicity = np.full_like(
            settings.seeded_particle_multiplicity,
            np.mean(settings.seeded_particle_multiplicity),
        )
    return settings


def _recorded(module, run):
    """``run()`` with ``module.Builder`` patched so that each ``run`` call
    of the particulator it builds records (steps, env, multiplicities,
    masses); returns (run's result, the records)"""
    records = []
    builder_class = module.Builder

    class RecordingBuilder(builder_class):
        def build(self, *args, **kwargs):
            p = super().build(*args, **kwargs)
            run_steps = p.run

            def run_and_record(steps):
                run_steps(steps)
                records.append((
                    p.n_steps,
                    {key: np.asarray(p.get_env(key)).copy() for key in ENV_KEYS},
                    np.asarray(p.attributes["multiplicity"]).copy(),
                    np.asarray(p.attributes["water mass"]).copy(),
                ))

            p.run = run_and_record
            return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "Builder", RecordingBuilder)
        return run(), records


@pytest.fixture(scope="module", name="seeded")
def _seeded():
    """(port output, port records, JAX output, JAX records) of the seeding
    parcel with collisions off and an equal pool"""
    out, records = _recorded(seeding, lambda: seeding.Simulation(
        _seeding_settings(seeding, Formulae(seed=44), True,
                          enable_collisions=False),
        backend_class=CPU,
    ).run())
    want, jax_records = _recorded(jax_seeding, lambda: jax_seeding.Simulation(
        _seeding_settings(jax_seeding, pysdm_tpu.Formulae(seed=44), True,
                          enable_collisions=False),
    ).run())
    return out, records, want, jax_records


def test_seeding_parcel_matches_jax_package_step_by_step(seeded):
    out, records, want, jax_records = seeded
    assert len(records) == len(jax_records) == 100
    for (steps, env, mult, mass), (_, j_env, j_mult, j_mass) in zip(
        records, jax_records
    ):
        for key in ENV_KEYS:
            np.testing.assert_allclose(
                env[key], j_env[key], rtol=1e-10, err_msg=f"{key} at {steps}"
            )
        np.testing.assert_array_equal(mult, j_mult, err_msg=f"step {steps}")
        np.testing.assert_allclose(mass, j_mass, rtol=1e-8, err_msg=f"{steps}")
    np.testing.assert_array_equal(
        out["products"]["sd_count"], want["products"]["sd_count"]
    )
    # seven injections, at t = 300, 315, ..., 390 s
    assert out["products"]["sd_count"][0] == 64
    assert out["products"]["sd_count"][-1] == 64 + 7
    for name in ("r_eff", "n_drop", "rain water mixing ratio", "time"):
        np.testing.assert_allclose(
            out["products"][name], want["products"][name], rtol=1e-8,
            err_msg=name,
        )


def test_grave_slots_carried_across():
    """a JAX seeding parcel, graves included, carried into the port after
    its injections began: the steps after agree"""
    jsim = jax_seeding.Simulation(_seeding_settings(
        jax_seeding, pysdm_tpu.Formulae(seed=44), True, enable_collisions=False,
    ))
    tsim = seeding.Simulation(_seeding_settings(
        seeding, Formulae(seed=44), True, enable_collisions=False,
    ), backend_class=CPU)
    jp, tp = jsim.particulator, tsim.particulator
    jp.run(23)  # t = 345 s: four injected, twelve graves left
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    tp.n_steps = jp.n_steps
    assert int((tp.attributes["multiplicity"] == 0).sum()) == 12
    assert tp.sim_state["host"]["t"] == 345.0
    jp.run(5)
    tp.run(5)
    np.testing.assert_array_equal(
        tp.attributes["multiplicity"], np.asarray(jp.attributes["multiplicity"])
    )
    np.testing.assert_allclose(
        tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
        rtol=1e-8,
    )


def test_seeding_injects_and_rains():
    """``TestSeeding::test_seeding_injects_and_rains`` on the port"""
    settings = seeding.Settings(
        super_droplet_injection_rate=_injection_rate,
        formulae=Formulae(seed=44),
        n_sd_initial=64,
        n_sd_seeding=16,
    )
    out = seeding.Simulation(settings, backend_class=CPU).run()
    sd_count = out["products"]["sd_count"]
    assert sd_count[0] == 64
    assert sd_count[-1] > 64
    assert np.nanmax(out["products"]["r_eff"]) > 1e-6


def test_seeding_updraft_matches_jax_package():
    port = _seeding_settings(seeding, Formulae(), False)
    ref = _seeding_settings(jax_seeding, pysdm_tpu.Formulae(), False)
    for t in np.linspace(0.0, 1500.0, 41):
        np.testing.assert_allclose(
            port.updraft(float(t)), float(ref.updraft(jnp.asarray(t))),
            rtol=1e-14,
        )
    for name, value in port.seeded_particle_extensive_attributes.items():
        np.testing.assert_allclose(
            value, ref.seeded_particle_extensive_attributes[name], rtol=1e-12
        )


def test_seeding_simulation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = _seeding_settings(seeding, Formulae(), False)
    with pytest.raises(RuntimeError, match="CUDA"):
        seeding.Simulation(settings)
