"""The port's coalescence-only box models and the thesis benchmarks through
their entry points on the CPU, with the JAX package's own tests replayed at
their bounds, and Berry 1967 held against the JAX package step by step.

Replayed, on the port's ``CPU`` backend (float64):
- ``tests/smoke/test_models.py`` ``TestShima2009`` and ``TestBerry1967``;
- the four tests of ``tests/smoke/test_dejong_azimi_and_theses.py``;
- the two tests of ``tests/smoke/test_srivastava_1982.py``;
- the Golovin tests of ``tests/smoke/test_box_coalescence.py`` (those that
  pass in the JAX package: the adaptive convergence ladders, liquid water
  conserved, adaptive better than not at dt = 50 s), the spectra read
  through the port's ``ParticleVolumeVersusRadiusLogarithmSpectrum``.
At these sizes the two packages draw different pairs and so agree only
statistically: the port takes the semantics of the JAX package's K1b and
K5 at every n, the JAX package only at n % 32768 == 0.

Berry 1967 at 2^15 super-droplets, where the JAX package takes its Pallas
K1b (in interpret mode here), with the port drawing the JAX package's
(K, seed) of each substep (``Collision._draw_mirror`` replaced by a replay
of its key chain, as ``tests/smoke/test_torch_box.py`` does): the
multiplicities equal at every step, water masses to rtol 1e-12.

The models' entry points default to the ``GPU`` backend and raise without a
CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.models import berry_1967 as jax_berry

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Exponential
from pysdm_tpu_torch.models import (
    berry_1967,
    dejong_azimi,
    shima_et_al_2009,
    srivastava_1982,
    thesis_benchmarks,
)
from pysdm_tpu_torch.physics import si
from pysdm_tpu_torch.products import ParticleVolumeVersusRadiusLogarithmSpectrum


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TestShima2009:
    @staticmethod
    def test_spectrum_evolution_matches_golovin_analytic():
        m = shima_et_al_2009
        settings = m.Settings(steps=[0, 1200])
        settings.n_sd = 2**12
        vals, wall_time = m.run(settings, backend_class=CPU)
        assert wall_time > 0
        r_mid = np.sqrt(
            settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:]
        )
        analytic = m.golovin_analytic_dvdlnr(
            r_mid, 1200.0, b=1.5e3, x_0=settings.X0,
            n_part=settings.n_part, rho=settings.rho,
        )
        measured = vals[1200]
        scale = analytic.max()
        rmse = np.sqrt(np.mean(((measured - analytic) / scale) ** 2))
        assert rmse < 0.15
        dlnr = np.diff(np.log(settings.radius_bins_edges))
        m0 = (vals[0] * dlnr).sum()
        m1 = (vals[1200] * dlnr).sum()
        np.testing.assert_allclose(m0, m1, rtol=5e-2)


class TestBerry1967:
    @staticmethod
    def test_collection_growth():
        settings = berry_1967.Settings(steps=[0, 400])
        settings.n_sd = 2**11
        vals, particulator = berry_1967.run(settings, backend_class=CPU)
        r_mid = np.sqrt(
            settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:]
        )
        mean_r0 = (vals[0] * r_mid).sum() / vals[0].sum()
        mean_r1 = (vals[400] * r_mid).sum() / vals[400].sum()
        assert mean_r1 > mean_r0
        assert particulator.dynamics["Collision"].substeps_run == 400


def test_dejong_azimi_box_moments():
    settings = dejong_azimi.Settings0D(n_sd=2**12)
    out = dejong_azimi.run_box(settings, backend_class=CPU)
    m0, m1 = out.moments[:, 0], out.moments[:, 1]
    assert m0[0] > m0[-1]
    np.testing.assert_allclose(m1, m1[0], rtol=1e-6)
    assert (np.diff(m1 / m0) > 0).all()
    assert out.dv_dlnr.shape == (3, 63)
    # the Cloudy.jl comparison data's analytic Golovin M0 at t = 0/60/120 s
    analytic_m0 = np.array([100.0, 4.863406413211965, 0.23652721940076313])
    analytic_m0 *= 1e6
    np.testing.assert_allclose(m0[0], analytic_m0[0], rtol=0.02)
    np.testing.assert_allclose(m0[1:], analytic_m0[1:], rtol=0.5)


def test_dejong_azimi_settings_1d():
    settings = dejong_azimi.Settings1D(n_sd_per_gridbox=16, z_max=500 * si.m)
    assert settings.collision_kernel.b == 5e3
    assert settings.enable_condensation is False
    assert settings.z_part == (0.5, 0.75)
    assert settings.nz == 20 + int(
        settings.particle_reservoir_depth // settings.dz
    )
    assert settings.formulae.terminal_velocity.variant == "PowerSeries"


def test_dejong_azimi_column_coalesces():
    """``Settings1D`` through the port's column ``Simulation``: the
    particles start in the z_part band only, K2 merges pairs there, no
    condensation runs, and water is conserved with the precipitation
    counted"""
    from pysdm_tpu_torch.models.shipway_and_hill_2012 import Simulation

    settings = dejong_azimi.Settings1D(n_sd_per_gridbox=16, z_max=500 * si.m)
    p = Simulation(settings, backend_class=CPU).particulator
    assert "Condensation" not in p.dynamics
    mult0 = p.attributes["multiplicity"]
    mass0 = (mult0 * p.attributes["water mass"]).sum()
    precipitated = 0.0
    for _ in range(20):
        p.run(1)
        precipitated += float(p.get_counter("precipitated_mass").sum())
    mult = p.attributes["multiplicity"]
    mass = (mult * p.attributes["water mass"]).sum()
    assert mult.sum() < 0.9 * mult0.sum()
    np.testing.assert_allclose(mass + precipitated, mass0, rtol=1e-10)
    assert p.get_counter("coalescence_rate").sum() > 0


def test_bartman_2020_adaptive_recovers_small_dt():
    out = thesis_benchmarks.bartman_2020_fig_4(
        n_sds=(2**12,), dts=(1 * si.s, 10 * si.s, "adaptive"),
        backend_class=CPU,
    )
    (state_dt1, _) = out[(2**12, 1 * si.s)]
    (state_dt10, _) = out[(2**12, 10 * si.s)]
    (state_ad, _) = out[(2**12, "adaptive")]
    ref = state_dt1[max(state_dt1.keys())]
    last10 = max(state_dt10.keys())
    err_ad = np.abs(state_ad[last10] - ref).sum()
    err_fixed = np.abs(state_dt10[last10] - ref).sum()
    assert err_ad <= err_fixed * 1.25


def test_bulenok_2023_benchmark():
    res = thesis_benchmarks.bulenok_2023_benchmark(
        n_sds=(2**10,), n_steps=32, backend_class=CPU
    )
    r = res[2**10]
    assert r["pair_updates_per_s"] > 0
    assert r["mean_mass_final"] > 1.0


def test_srivastava_equations_limits():
    eq = srivastava_1982.Equations(M=4e6, c=0.5e-6, beta=1e-9)
    tau = eq.tau(np.linspace(0, 1e4, 64))
    m = eq.eq13(1.0, tau)
    assert abs(m[0] - 1.0) < 1e-12
    assert (np.diff(m) >= 0).all()
    assert m[-1] <= eq.eq14()
    assert abs(m[-1] - eq.eq14()) / eq.eq14() < 1e-6


def test_srivastava_merge_and_break_close_to_analytic():
    settings = srivastava_1982.Settings(
        srivastava_c=0.5e-6 / si.s,
        srivastava_beta=1e-9 / si.s,
        frag_mass=0.25 * si.g,
        n_sds=(2**10,),
        drop_mass_0=1 * si.g,
        dt=1 * si.s,
        dv=1 * si.m**3,
        total_number=1e6,
        backend_class=CPU,
    )
    results = srivastava_1982.coalescence_and_breakup_eq13(
        settings=settings, n_steps=128, seed=44
    )
    sim = results["pysdm"][2**10]["mean mass to frag mass"]
    ana = results["analytic_mean_mass_to_frag_mass"]
    assert sim[-1] > 2 * sim[0]
    rel_err = np.abs(sim[1:] - ana[1:]) / ana[1:]
    assert rel_err.mean() < 0.15
    assert rel_err[-16:].mean() < 0.2


def test_entry_points_default_to_the_card(monkeypatch):
    """without ``backend_class`` every entry point builds on ``GPU``, which
    raises where torch sees no CUDA device"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = srivastava_1982.Settings(
        srivastava_c=0.5e-6, srivastava_beta=1e-9, frag_mass=2.5e-4,
        n_sds=(2**10,), drop_mass_0=1e-3, dt=1.0, dv=1.0, total_number=1e6,
    )
    calls = (
        lambda: shima_et_al_2009.run(shima_et_al_2009.Settings(steps=[0])),
        lambda: berry_1967.run(berry_1967.Settings(steps=[0])),
        lambda: dejong_azimi.run_box(dejong_azimi.Settings0D(steps=(0,))),
        lambda: srivastava_1982.coalescence_and_breakup_eq13(
            settings=settings, n_steps=1
        ),
        lambda: thesis_benchmarks.bulenok_2023_benchmark(n_sds=(2**10,)),
        lambda: thesis_benchmarks.bartman_2020_fig_4(n_sds=(2**10,)),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- tests/smoke/test_box_coalescence.py's Golovin tests on the port --------
RADIUS_BINS = np.logspace(np.log10(10 * si.um), np.log10(5e3 * si.um), num=64)


def _run_box(n_sd, dt, t_max, adaptive, seed=44):
    formulae = pysdm_tpu_torch.Formulae(seed=seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(formulae),
        environment=Box(dv=1e6 * si.m**3, dt=dt),
    )
    n_part = 2**23
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=adaptive)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        Exponential(norm_factor=n_part * 1e6, scale=x_0)
    ).sample(n_sd)
    particulator = builder.build(attributes, (
        ParticleVolumeVersusRadiusLogarithmSpectrum(RADIUS_BINS, name="dv/dlnr"),
    ))
    particulator.run(int(t_max / dt))
    return particulator, x_0, n_part


def _error(particulator, t_max, x_0, n_part):
    measured = particulator.products["dv/dlnr"].get()[0] * 1000.0
    r_mid = np.sqrt(RADIUS_BINS[:-1] * RADIUS_BINS[1:])
    analytic = shima_et_al_2009.golovin_analytic_dvdlnr(
        r_mid, t_max, b=1.5e3, x_0=x_0, n_part=n_part, rho=1000.0
    )
    scale = max(analytic.max(), 1e-300)
    return float(np.sqrt(np.mean(((measured - analytic) / scale) ** 2)))


@pytest.mark.parametrize("dt", (100.0, 50.0))
def test_golovin_convergence_with_sd_count(dt):
    """``test_box_coalescence.py::test_convergence_with_sd_count`` with
    adaptivity (its non-adaptive cases fail by design in both packages):
    the seed-averaged error against the Golovin solution at t = 3600 s
    falls over 2^11, 2^15, 2^17 super-droplets (at dt = 50 s it reaches the
    time-discretisation floor after 2^15) and ends under 0.1"""
    t_max = 3600.0
    errors = {}
    for ln2_nsd in (11, 15, 17):
        errs = []
        for seed in (44, 45, 46):
            particulator, x_0, n_part = _run_box(
                2**ln2_nsd, dt=dt, t_max=t_max, adaptive=True, seed=seed
            )
            errs.append(_error(particulator, t_max, x_0, n_part))
        errors[ln2_nsd] = float(np.mean(errs))
    keys = sorted(errors)
    if dt == 100.0:
        assert errors[keys[0]] > errors[keys[1]] > errors[keys[2]]
    else:
        assert errors[keys[0]] > errors[keys[1]]
        assert errors[keys[2]] < 1.05 * errors[keys[1]]
    assert errors[keys[2]] < 0.1


@pytest.mark.parametrize("adaptive", (False, True))
def test_golovin_lwc_constant(adaptive):
    particulator, *_ = _run_box(2**11, dt=10.0, t_max=300.0, adaptive=adaptive)
    mult = particulator.attributes["multiplicity"]
    lwc1 = float((mult * particulator.attributes["water mass"]).sum())
    p2, *_ = _run_box(2**11, dt=10.0, t_max=0.0, adaptive=adaptive)
    lwc0 = float(
        (p2.attributes["multiplicity"] * p2.attributes["water mass"]).sum()
    )
    np.testing.assert_allclose(lwc1, lwc0, rtol=1e-10)


def test_golovin_adaptive_beats_nonadaptive_at_large_dt():
    t_max = 1800.0
    errs = {}
    for adaptive in (False, True):
        particulator, x_0, n_part = _run_box(
            2**12, dt=50.0, t_max=t_max, adaptive=adaptive
        )
        errs[adaptive] = _error(particulator, t_max, x_0, n_part)
    assert errs[True] < errs[False]


# -- Berry 1967 against the JAX package at 2^15 ------------------------------
BERRY_N_SD = 2**15
BERRY_STEPS = 4


def _berry(package):
    """``berry_1967.run``'s build at 2^15 super-droplets"""
    if package == "jax":
        model, pkg, backend = jax_berry, pysdm_tpu, pysdm_tpu.backends.CPU
        box, coalescence = pysdm_tpu.environments.Box, pysdm_tpu.dynamics.Coalescence
        sampling = jax_sampling.ConstantMultiplicity
    else:
        model, pkg, backend = berry_1967, pysdm_tpu_torch, CPU
        box, coalescence, sampling = Box, Coalescence, ConstantMultiplicity
    settings = model.Settings()
    builder = pkg.Builder(
        n_sd=BERRY_N_SD, backend=backend(formulae=settings.formulae),
        environment=box(dv=settings.dv, dt=settings.dt),
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = sampling(
        settings.spectrum
    ).sample(BERRY_N_SD)
    builder.add_dynamic(coalescence(collision_kernel=settings.kernel, adaptive=False))
    return builder.build(attributes)


def _replay_jax_draws(particulator, key):
    """the port draws what the JAX collision substeps draw from ``key`` on:
    K, the PRF seed and the u01 rows of the key chain (gamma, process,
    fragment)"""
    state = {"key": key}

    def draw_mirror(n_sd, n_rows=0):
        key, k_sh, k_gam, k_proc, k_frag = jax.random.split(state["key"], 5)
        state["key"] = key
        K = jax.random.randint(k_sh, (), 0, n_sd, dtype=jnp.int32)
        seed = jax.random.bits(k_gam, (), jnp.uint32)
        rows = [
            torch.from_numpy(np.asarray(
                jax.random.uniform(k, (n_sd,), dtype=jnp.float64)
            ))
            for k in (k_gam, k_proc, k_frag)[:n_rows]
        ]
        return int(K), int(seed), rows

    particulator.dynamics["Collision"]._draw_mirror = draw_mirror


def test_berry_matches_jax_package_step_by_step(monkeypatch):
    """Geometric on K1's twin against the JAX package's Pallas K1b: the
    fall velocity (Gunn-Kinzer) and radius rows agree to an ulp in float64
    and are the same float32 values, so every pair draws the same gamma"""
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp, tp = _berry("jax"), _berry("port")
    _replay_jax_draws(tp, jp.sim_state["key"])
    for name in ("radius", "relative fall velocity"):
        np.testing.assert_array_equal(
            tp.attributes[name].astype(np.float32),
            np.asarray(jp.attributes[name]).astype(np.float32), err_msg=name,
        )
    mult0 = tp.attributes["multiplicity"]
    for _ in range(BERRY_STEPS):
        jp.run(1)
        tp.run(1)
        np.testing.assert_array_equal(
            tp.attributes["multiplicity"], np.asarray(jp.attributes["multiplicity"])
        )
        np.testing.assert_allclose(
            tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
            rtol=1e-12,
        )
    assert (tp.attributes["multiplicity"] != mult0).sum() > 100
    np.testing.assert_allclose(
        tp.get_counter("coalescence_rate"), jp.get_counter("coalescence_rate"),
        rtol=1e-5,
    )
