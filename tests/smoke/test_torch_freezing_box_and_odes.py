"""The Arabas et al. 2025 freezing box, Rogers 1975's ODE and Bartman et
al. 2021's benchmark harness on the port's CPU backend (float64), against
the JAX package and at the JAX tests' bounds:
- Arabas et al. 2025 through ``make_particulator`` and ``run_simulation``
  at the JAX test's size (256 super-droplets, 60 steps from 250 K to 230
  K). Singular freezing: the frozen fraction at every step equals the JAX
  package's to rtol 1e-12 (which drops froze is decided by T_fz alone).
  Time-dependent (ABIFM) freezing: both packages built with u01 injection,
  the same ``freezing_immersion`` rows injected before every step, the
  frozen fraction and the frozen mask equal at every step. Then the four
  ``TestArabasEtAl2025`` cases;
- Rogers 1975: ``TestRogers1975::test_fig_1``, and the whole trajectory
  against the JAX package's RK4 at rtol 1e-12;
- Bartman et al. 2021: ``test_bartman_benchmark_harness_returns_timings``
  with ``CPU``;
- each entry point's default backend is the card.
"""

import functools

import numpy as np
import pytest
import torch

from pysdm_tpu.models import arabas_et_al_2025 as jax_arabas
from pysdm_tpu.models import rogers_1975 as jax_rogers

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.models import arabas_et_al_2025 as arabas
from pysdm_tpu_torch.models import bartman_et_al_2021, rogers_1975
from pysdm_tpu_torch.physics import si

DROPLET_VOLUME = float(pysdm_tpu_torch.Formulae().trivia.volume(radius=10 * si.um))
BOX_VOLUME = 1 * si.m**3
TOTAL_PARTICLE_NUMBER = 1e6
N_STEPS = 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _injecting(module, mp, seed=0):
    """``module.Builder`` patched to build with u01 injection; each ``run``
    of the particulator it builds injects the next uniform row of a
    generator seeded with ``seed`` as "freezing_immersion" first"""
    builder_class = module.Builder

    class InjectingBuilder(builder_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.enable_u01_injection()

        def build(self, *args, **kwargs):
            p = super().build(*args, **kwargs)
            run_steps, rng = p.run, np.random.default_rng(seed)

            def run(steps):
                for _ in range(steps):
                    p.inject_u01({"freezing_immersion": rng.uniform(size=p.n_sd)})
                    run_steps(1)

            p.run = run
            return p

    mp.setattr(module, "Builder", InjectingBuilder)


def _run(module, singular, cooling_rate, n_sd=256, seed=44, inject=False,
         **kwargs):
    """the JAX test's ``_run`` through ``module``; returns (output,
    frozen fraction)"""
    dT_total = module.TEMP_RANGE[0] - module.TEMP_RANGE[1]
    t_total = dT_total / -cooling_rate
    dt = t_total / N_STEPS
    with pytest.MonkeyPatch.context() as mp:
        if inject:
            _injecting(module, mp)
        particulator = module.make_particulator(
            constants=module.FREEZING_CONSTANTS["dust"],
            n_sd=n_sd,
            dt=dt,
            initial_temperature=module.TEMP_RANGE[0],
            singular=singular,
            seed=seed,
            shima_T_fz="Niemand_et_al_2012",
            ABIFM_spec=module.abifm_spec(),
            droplet_volume=DROPLET_VOLUME,
            total_particle_number=TOTAL_PARTICLE_NUMBER,
            volume=BOX_VOLUME,
            **kwargs,
        )
    profile = lambda t: module.TEMP_RANGE[0] + cooling_rate * t
    out = module.run_simulation(particulator, profile, N_STEPS)
    ff = module.FrozenFraction(
        volume=BOX_VOLUME,
        droplet_volume=DROPLET_VOLUME,
        total_particle_number=TOTAL_PARTICLE_NUMBER,
        rho_w=particulator.formulae.constants.rho_w,
    )
    frozen_fraction = np.asarray([ff.qi2ff(qi) for qi in out["products"]["qi"]])
    return out, frozen_fraction


@functools.cache
def _port(singular, cooling_rate):
    return _run(arabas, singular, cooling_rate, backend_class=CPU)


def test_singular_frozen_fraction_equals_jax_package_at_every_step():
    rate = -0.75 * si.K / si.min
    out, ff = _port(True, rate)
    want_out, want_ff = _run(jax_arabas, True, rate)
    assert ff.shape == (N_STEPS + 1,)
    np.testing.assert_allclose(ff, want_ff, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        out["spectrum"]["freezing temperature"],
        np.asarray(want_out["spectrum"]["freezing temperature"]), rtol=1e-12,
    )
    for got, want in zip(out["frozen"], want_out["frozen"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        out["products"]["T"], want_out["products"]["T"], rtol=1e-12
    )


@pytest.mark.parametrize("cooling_rate", (-3.75 * si.K / si.min,
                                          -0.15 * si.K / si.min))
def test_time_dependent_freezing_equals_jax_package_under_injection(cooling_rate):
    out, ff = _run(arabas, False, cooling_rate, inject=True, backend_class=CPU)
    want_out, want_ff = _run(jax_arabas, False, cooling_rate, inject=True)
    np.testing.assert_allclose(ff, want_ff, rtol=1e-12, atol=0)
    for got, want in zip(out["frozen"], want_out["frozen"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        out["spectrum"]["immersed surface area"],
        np.asarray(want_out["spectrum"]["immersed surface area"]), rtol=1e-12,
    )
    assert 0 < ff[-1] < 1


def test_singular_frozen_fraction_monotone():
    """``TestArabasEtAl2025::test_singular_frozen_fraction_monotone``"""
    _, ff = _port(True, -0.75 * si.K / si.min)
    assert ff[0] == 0
    assert (np.diff(ff) >= -1e-12).all()
    assert ff[-1] > 0.9


def test_time_dependent_freezes():
    """``TestArabasEtAl2025::test_time_dependent_freezes``"""
    _, ff = _port(False, -0.75 * si.K / si.min)
    assert ff[0] == 0
    assert ff[-1] > 0.5
    assert (np.diff(ff) >= -1e-12).all()


def test_cooling_rate_sensitivity():
    """``TestArabasEtAl2025::test_cooling_rate_sensitivity``"""
    fast, slow = -3.75 * si.K / si.min, -0.15 * si.K / si.min
    ff_sing = {rate: _port(True, rate)[1] for rate in (fast, slow)}
    ff_td = {rate: _port(False, rate)[1] for rate in (fast, slow)}
    mid = 30
    assert ff_sing[fast][mid] == pytest.approx(ff_sing[slow][mid], abs=0.05)
    assert ff_td[slow][mid] > ff_td[fast][mid] + 0.05


def test_frozen_fraction_roundtrip():
    """``TestArabasEtAl2025::test_frozen_fraction_roundtrip``"""
    ff = arabas.FrozenFraction(
        volume=BOX_VOLUME,
        droplet_volume=DROPLET_VOLUME,
        total_particle_number=TOTAL_PARTICLE_NUMBER,
        rho_w=1000.0,
    )
    assert ff.qi2ff(ff.ff2qi(0.37)) == pytest.approx(0.37)


def test_arabas_constants_match_jax_package():
    assert arabas.FREEZING_CONSTANTS == jax_arabas.FREEZING_CONSTANTS
    np.testing.assert_allclose(arabas.COOLING_RATES, jax_arabas.COOLING_RATES)
    np.testing.assert_allclose(
        arabas.LOGNORMAL_MODE_SURF_A, jax_arabas.LOGNORMAL_MODE_SURF_A,
        rtol=1e-15,
    )


def test_update_thermo_writes_the_env_state():
    """the prescribed T reaches the env state the freezing step reads"""
    p = arabas.make_particulator(
        constants=arabas.FREEZING_CONSTANTS["dust"], n_sd=8, dt=1.0,
        initial_temperature=250.0, singular=True, seed=44,
        shima_T_fz="Niemand_et_al_2012", ABIFM_spec=arabas.abifm_spec(),
        droplet_volume=DROPLET_VOLUME, total_particle_number=1e3,
        volume=BOX_VOLUME, backend_class=CPU,
    )
    arabas.update_thermo(p, 241.5)
    assert p.sim_state["env"]["T"].dtype == torch.float64
    np.testing.assert_array_equal(p.get_env("T"), [241.5])


# --- Rogers 1975 ------------------------------------------------------------
@functools.cache
def _rogers():
    return rogers_1975.fig_1()


def test_rogers_fig_1():
    """``TestRogers1975::test_fig_1``"""
    out = _rogers()
    s_pct = out["supersaturation"] * 100
    r_um = out["radius"] / si.um
    assert (s_pct[1:] > 0).all() and s_pct.max() < 1.1
    assert (np.diff(r_um) > 0).all()
    assert r_um[0] == pytest.approx(8.0, abs=0.05)
    assert 9.5 < r_um[-1] < 10.2
    i_peak = np.argmax(s_pct)
    assert 0 < i_peak < len(s_pct) - 1
    assert s_pct[-1] < s_pct[i_peak]
    assert out["temperature"][-1] < out["temperature"][0]
    assert out["pressure"][-1] < out["pressure"][0]


def test_rogers_trajectory_matches_jax_package():
    out, want = _rogers(), jax_rogers.fig_1()
    for key in ("t", "supersaturation", "radius", "pressure", "temperature"):
        np.testing.assert_allclose(
            out[key], np.asarray(want[key]), rtol=1e-12, atol=0, err_msg=key
        )


def test_rogers_derivatives_match_jax_package():
    state = np.asarray([8e4, 280.0, 1.002, 8e-6])
    np.testing.assert_allclose(
        rogers_1975.derivatives(state, U=10.0, nu_0=2e8),
        np.asarray(jax_rogers.derivatives(state, U=10.0, nu_0=2e8)),
        rtol=1e-13,
    )


# --- Bartman et al. 2021 ----------------------------------------------------
def test_bartman_benchmark_harness_returns_timings():
    """``test_bartman_benchmark_harness_returns_timings`` with the port's
    ``CPU``"""
    results = bartman_et_al_2021.benchmark(
        backend_classes=(CPU,),
        n_sd_per_gridbox_list=(2,),
        grid=(4, 4),
        n_steps=2,
    )
    assert set(results) == {"CPU"}
    assert set(results["CPU"]) == {2}
    assert results["CPU"][2] > 0


# --- the entry points default to the card -----------------------------------
def test_bartman_benchmark_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bartman_et_al_2021.benchmark(
            n_sd_per_gridbox_list=(2,), grid=(4, 4), n_steps=1
        )


def test_arabas_make_particulator_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(arabas, True, -0.75 * si.K / si.min, n_sd=8)
