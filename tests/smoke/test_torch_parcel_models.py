"""The parcel models of the rest of physics/ on the port's CPU backend
(float64), against the JAX package and at the JAX tests' bounds:
- ``TestLowe2019``, ``TestArabasShima2017``, ``TestYang2018`` and
  ``TestJensenNugent2017`` of ``tests/smoke/test_models.py`` at their sizes
  and bounds. Each condensation-only model runs in both packages side by
  side, step by step: the environment to rtol 1e-10 (the displacement
  also to 1e-9 m, as the oscillating parcels return to z = 0) and the
  water masses
  to 1e-8 at every step (the per-drop solves stop at rtol_x, so an ulp in
  an input moves a root by an ulp of its bracket, and a few hundred
  adaptive steps carry that on; ``tests/smoke/test_torch_parcel.py`` holds
  40 steps at 1e-12 and 1e-10). Jensen & Nugent's JAX test runs without
  coalescence, so it compares too; with gravitational coalescence it holds
  bounds only: at its 62 super-droplets the JAX package draws its pairs
  for K1a from ``jax.random`` rows (n % 32768 != 0), the port for K1's
  semantics (ROADMAP queue 3, "K1a/K1b and K5 semantics at every N"), so
  the two agree only statistically;
- ``TestSingerWard`` (``tests/smoke/test_arabas2025_singer_ward.py``) and
  ``TestVentilation`` (``tests/smoke/test_parcel_condensation.py``),
  replayed, with the Reynolds number held against the JAX package's on
  one state at rtol 1e-12;
- each model's entry point defaults to the card.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.models import arabas_and_shima_2017 as jax_arabas_shima
from pysdm_tpu.models import jensen_and_nugent_2017 as jax_jensen_nugent
from pysdm_tpu.models import lowe_et_al_2019 as jax_lowe
from pysdm_tpu.models import singer_ward as jax_singer_ward
from pysdm_tpu.models import yang_et_al_2018 as jax_yang

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation
from pysdm_tpu_torch.environments import Parcel
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Lognormal
from pysdm_tpu_torch.models import (
    arabas_and_shima_2017,
    jensen_and_nugent_2017,
    lowe_et_al_2019,
    singer_ward,
    yang_et_al_2018,
)
from pysdm_tpu_torch.physics import si

ENV_KEYS = ("thd", "qv", "rhod", "T", "p", "RH", "z")
RTOL_ENV, RTOL_MASS = 1e-10, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(jp, tp, step):
    for key in ENV_KEYS:
        # the oscillating parcels come back to z = 0, where only an
        # absolute bound means anything (1e-9 m)
        np.testing.assert_allclose(
            tp.get_env(key), np.asarray(jp.get_env(key)), rtol=RTOL_ENV,
            atol=1e-9 if key == "z" else 0, err_msg=f"{key} at step {step}",
        )
    np.testing.assert_allclose(
        tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
        rtol=RTOL_MASS, err_msg=f"water mass at step {step}",
    )


def _lockstep(jax_sim, port_sim):
    """run the port simulation's ``run`` with each port step checked
    against the JAX package's: the port particulator's ``run`` steps the
    JAX one beside it, and reads the JAX products where the port's run
    goes on to read its own (some reset on read). Returns (the port's
    output, the steps, the JAX products read, {name: [values]})"""
    jp, tp = jax_sim.particulator, port_sim.particulator
    port_run = tp.run
    count = {"steps": 0}
    jax_products = {name: [] for name in jp.products}

    def run(n):
        jp.run(n)
        port_run(n)
        count["steps"] += n
        _assert_same(jp, tp, count["steps"])
        for name, product in jp.products.items():
            jax_products[name].append(
                float(np.asarray(product.get()).reshape(-1)[0])
            )

    tp.run = run
    try:
        port_out = port_sim.run()
    finally:
        tp.run = port_run
    return port_out, count["steps"], jax_products


# --- Lowe et al. 2019 -------------------------------------------------------
@functools.cache
def _lowe():
    wmv = 18.015e-3 / 1000.0
    out = {}
    for model in ("Constant", "CompressedFilmOvadnevaite"):
        sims = {}
        for pkg, module, backend in (
            ("jax", jax_lowe, {}), ("port", lowe_et_al_2019, {"backend_class": CPU}),
        ):
            settings = module.Settings(
                dz=5.0, n_sd_per_mode=16,
                aerosol=module.AerosolMarine(water_molar_volume=wmv, Forg=0.2),
                model=model,
            )
            sims[pkg] = module.Simulation(settings, **backend)
        out[model] = _lockstep(sims["jax"], sims["port"])
    return out


@pytest.mark.parametrize("model", ("Constant", "CompressedFilmOvadnevaite"))
def test_lowe_matches_jax_package_step_by_step(model):
    """the state at every step, and every product at every step to rtol
    1e-8"""
    port_out, steps, jax_products = _lowe()[model]
    assert steps == 40
    for name in ("S_max", "CDNC", "r_eff", "liquid water mixing ratio", "z"):
        np.testing.assert_allclose(
            port_out[name], jax_products[name], rtol=1e-8, err_msg=name
        )


def test_lowe_film_model_increases_cdnc():
    """``TestLowe2019::test_film_model_increases_cdnc`` (Forg = 0.2)"""
    out = _lowe()
    assert (
        out["CompressedFilmOvadnevaite"][0]["CDNC"][-1]
        > out["Constant"][0]["CDNC"][-1]
    )


def test_lowe_aerosols_match_jax_package():
    wmv = 18.015e-3 / 1000.0
    for name in ("AerosolMarine", "AerosolBoreal"):
        port = getattr(lowe_et_al_2019, name)(water_molar_volume=wmv)
        ref = getattr(jax_lowe, name)(water_molar_volume=wmv)
        for p_mode, j_mode in zip(port.modes, ref.modes):
            assert p_mode["kappa"] == j_mode["kappa"]
            assert p_mode["f_org"] == j_mode["f_org"]


# --- Arabas & Shima 2017 ----------------------------------------------------
def _arabas_shima_settings(module):
    return module.Settings(
        w_avg=1.0, N_STP=50 / si.cm**3, r_dry=0.1 * si.um,
        mass_of_dry_air=1e3 * si.kg, n_output=100,
    )


@functools.cache
def _arabas_shima():
    jax_sim = jax_arabas_shima.Simulation(_arabas_shima_settings(jax_arabas_shima))
    port_sim = arabas_and_shima_2017.Simulation(
        _arabas_shima_settings(arabas_and_shima_2017), backend_class=CPU
    )
    return _lockstep(jax_sim, port_sim)


def test_arabas_shima_matches_jax_package_step_by_step():
    out, steps, jax_products = _arabas_shima()
    assert steps == 100 and len(out["RH"]) == 100
    np.testing.assert_allclose(out["RH"], jax_products["RH"], rtol=1e-10)


def test_arabas_shima_activation_hysteresis():
    """``TestArabasShima2017::test_activation_hysteresis``"""
    out = _arabas_shima()[0]
    rh, r = np.asarray(out["RH"]), np.asarray(out["r"])
    assert rh.max() > 1.0
    assert r.max() > 1e-6
    assert rh[-1] < rh.max()


def test_arabas_shima_vertical_velocity_matches_jax_package():
    port = _arabas_shima_settings(arabas_and_shima_2017)
    ref = _arabas_shima_settings(jax_arabas_shima)
    t = np.linspace(0.0, 2 * port.t_total, 17)
    np.testing.assert_allclose(port.w(t), np.asarray(ref.w(t)), rtol=1e-14)


# --- Yang et al. 2018 -------------------------------------------------------
def _yang_settings(module):
    settings = module.Settings(n_sd=32, total_time=2400.0, dt_max=5.0)
    settings.n_steps = int(settings.total_time / 5.0)
    return settings


@functools.cache
def _yang():
    jax_sim = jax_yang.Simulation(_yang_settings(jax_yang))
    port_sim = yang_et_al_2018.Simulation(
        _yang_settings(yang_et_al_2018), backend_class=CPU
    )
    return _lockstep(jax_sim, port_sim)


def test_yang_matches_jax_package_step_by_step():
    out, steps, jax_products = _yang()
    # 480 outputs of two 2.5 s steps each
    assert steps == 960 and len(out["S"]) == 481
    for name in ("dt_cond_min", "dt_cond_max", "r_act", "r_mean_gt_1_um"):
        np.testing.assert_allclose(
            out[name][1:], jax_products[name], rtol=1e-8, err_msg=name
        )


def test_yang_cloud_cycles_activate_and_deactivate():
    """``TestYang2018::test_cloud_cycles_activate_and_deactivate``"""
    out = _yang()[0]
    S = np.asarray(out["S"])
    assert S.max() > 0.0
    i_t0 = np.searchsorted(np.asarray(out["t"]), 1200.0)
    assert S[i_t0:].min() < S.max()
    z = np.asarray(out["z"])
    assert z.max() > 1100.0
    assert z[-1] < z.max()
    assert np.nanmax(np.asarray(out["r_act"])) > 1e-6


def test_yang_vertical_velocity_matches_jax_package():
    port, ref = _yang_settings(yang_et_al_2018), _yang_settings(jax_yang)
    t = np.linspace(0.0, 3000.0, 61)
    np.testing.assert_array_equal(port.w(t), np.asarray(ref.w(t)))


# --- Jensen & Nugent 2017 ---------------------------------------------------
def _jensen_nugent(module, **kwargs):
    settings = module.Settings(aerosol="pristine", cloud_type="Sc", dt=2.0)
    return module.Simulation(settings, gccn=True, n_sd_non_gccn=24, **kwargs)


@functools.cache
def _jensen_nugent_pair():
    jax_sim = _jensen_nugent(jax_jensen_nugent)
    port_sim = _jensen_nugent(jensen_and_nugent_2017, backend_class=CPU)
    port_run = port_sim.run
    port_sim.run = lambda: port_run(n_steps=600, steps_per_output_interval=100)
    return _lockstep(jax_sim, port_sim)


def test_jensen_nugent_matches_jax_package_step_by_step():
    out, steps, jax_products = _jensen_nugent_pair()
    assert steps == 600
    for name in ("S_max", "r_mean_act", "r_std_act", "z"):
        np.testing.assert_allclose(
            out["products"][name], jax_products[name], rtol=1e-8,
            err_msg=name,
        )


def test_jensen_nugent_sc_parcel_activation():
    """``TestJensenNugent2017::test_sc_parcel_activation``"""
    out = _jensen_nugent_pair()[0]
    s_max = np.nanmax(out["products"]["S_max"])
    assert 0.0 < s_max < 0.05
    assert np.nanmax(np.asarray(out["products"]["r_mean_act"])) > 1e-6
    assert np.asarray(out["attributes"]["radius"][-1]).max() > 10e-6
    z = np.asarray(out["products"]["z"])
    assert z[-1] > z[0]


def test_jensen_nugent_with_gravitational_coalescence():
    """coalescence (``Geometric``, K1's twin on the mirror croupier) on the
    same parcel, 100 steps: bounds only (see above); the total water is
    conserved and the collision ran every step"""
    sim = _jensen_nugent(
        jensen_and_nugent_2017, backend_class=CPU,
        gravitational_coalescence=True,
    )
    p = sim.particulator

    def total_water():
        liquid = (p.attributes["multiplicity"] * p.attributes["water mass"]).sum()
        return float(p.get_env("qv")[0]) * 666 + float(liquid)

    water0 = total_water()
    out = sim.run(n_steps=100, steps_per_output_interval=50)
    assert p.get_counter("collision_n_substep").sum() >= 100
    assert (p.attributes["multiplicity"] >= 0).all()
    np.testing.assert_allclose(total_water(), water0, rtol=1e-9)
    assert np.isfinite(out["products"]["S_max"]).all()


# --- Singer and Ward --------------------------------------------------------
WMV = pysdm_tpu_torch.Formulae().constants.Mv / pysdm_tpu_torch.Formulae().constants.rho_w


def test_singer_ward_aerosol_modes():
    """``TestSingerWard::test_aerosol_modes``, and each mode equal to the
    JAX package's"""
    for port_cls, ref_cls in zip(
        singer_ward.AEROSOL_CLASSES, jax_singer_ward.AEROSOL_CLASSES
    ):
        mode = port_cls(water_molar_volume=WMV).modes[0]
        ref = ref_cls(water_molar_volume=WMV).modes[0]
        assert 0 < mode["f_org"] < 1
        for kappa in mode["kappa"].values():
            assert 0 < kappa < 1.5
        assert mode["kappa"]["CompressedFilmOvadnevaite"] < mode["kappa"]["Constant"]
        assert mode["nu_org"] > 0
        assert (mode["f_org"], mode["kappa"], mode["nu_org"]) == (
            ref["f_org"], ref["kappa"], ref["nu_org"]
        )


@pytest.mark.parametrize("st", (
    "Constant", "CompressedFilmOvadnevaite", "CompressedFilmRuehl",
    "SzyszkowskiLangmuir",
))
def test_singer_ward_kohler_curve_matches_jax_package(st):
    port = singer_ward.kohler_curve(
        surface_tension=st,
        aerosol=singer_ward.AerosolBetaCaryophylleneDark(water_molar_volume=WMV),
    )
    ref = jax_singer_ward.kohler_curve(
        surface_tension=st,
        aerosol=jax_singer_ward.AerosolBetaCaryophylleneDark(
            water_molar_volume=WMV
        ),
    )
    for key in ("r_wet", "supersaturation", "sigma"):
        np.testing.assert_allclose(
            np.asarray(port[key]), np.asarray(ref[key]), rtol=1e-12, err_msg=key
        )


def test_singer_ward_kohler_curves():
    """``TestSingerWard::test_kohler_curves``"""
    aerosol = singer_ward.AerosolBetaCaryophylleneDark(water_molar_volume=WMV)
    curves = {
        st: singer_ward.kohler_curve(surface_tension=st, aerosol=aerosol)
        for st in ("Constant", "CompressedFilmOvadnevaite")
    }
    for curve in curves.values():
        s = curve["supersaturation"]
        i_crit = np.argmax(s)
        assert 0 < i_crit < len(s) - 1
        assert 1e-4 < s[i_crit] < 0.05
    assert (
        curves["CompressedFilmOvadnevaite"]["supersaturation"].max()
        < curves["Constant"]["supersaturation"].max()
    )
    sgm = curves["CompressedFilmOvadnevaite"]["sigma"]
    assert sgm.min() >= 40e-3 - 1e-9
    assert sgm.max() <= 72.9e-3


# --- ventilation and the Reynolds number ------------------------------------
def _run_parcel(package, n_steps, **formulae_kwargs):
    """``tests/smoke/test_parcel_condensation.py``'s ``run_parcel`` (64
    drops, w = 2 m/s, qv0 = 0.0158, T0 = 300 K) through either package"""
    if package == "jax":
        pkg, backend = pysdm_tpu, pysdm_tpu.backends.CPU
        parcel, dyn = pysdm_tpu.environments.Parcel, pysdm_tpu.dynamics
        spectrum = jax_spectra.Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
        sampling = jax_sampling.ConstantMultiplicity
        thermo, cond = dyn.AmbientThermodynamics, dyn.Condensation
    else:
        pkg, backend, parcel = pysdm_tpu_torch, CPU, Parcel
        spectrum = Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
        sampling = ConstantMultiplicity
        thermo, cond = AmbientThermodynamics, Condensation
    formulae = pkg.Formulae(seed=44, **formulae_kwargs)
    env = parcel(dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
                 initial_water_vapour_mixing_ratio=0.0158, T0=300.0, w=2.0)
    builder = pkg.Builder(n_sd=64, backend=backend(formulae), environment=env)
    builder.add_dynamic(thermo())
    builder.add_dynamic(cond())
    r_dry, n_in_dv = sampling(spectrum).sample(64)
    p = builder.build(env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry))
    p.run(n_steps)
    return p


@functools.cache
def _ventilated():
    return _run_parcel("port", 600, ventilation="Froessling1938")


@functools.cache
def _neglected():
    return _run_parcel("port", 600)


def _reynolds(p):
    return p._resolver.get(
        p.sim_state["particles"], "Reynolds number", env=p.sim_state["env"]
    )


def test_reynolds_number_matches_hand_computed():
    """``TestVentilation::test_reynolds_number_matches_hand_computed``"""
    p = _ventilated()
    re = _reynolds(p).numpy()
    radius = p.attributes["radius"]
    v_term = p._resolver.get(p.sim_state["particles"], "relative fall velocity").numpy()
    cell = p.sim_state["particles"].cell_id.numpy()
    rho_air = p.get_env("air_density")[cell]
    eta_air = p.get_env("air_viscosity")[cell]
    assert (re > 0).all()
    np.testing.assert_allclose(re, 2 * radius * v_term * rho_air / eta_air, rtol=1e-6)


def test_reynolds_number_zero_when_neglect():
    """``TestVentilation::test_reynolds_number_zero_when_neglect``"""
    assert (_reynolds(_run_parcel("port", 10)).numpy() == 0).all()


@pytest.mark.parametrize("ventilation", ("Froessling1938", "PruppacherAndRasmussen1979"))
def test_reynolds_number_matches_jax_package(ventilation):
    """on one state, the JAX package's after 30 steps carried to the port:
    Re at rtol 1e-12"""
    jp = _run_parcel("jax", 30, ventilation=ventilation)
    tp = _run_parcel("port", 0, ventilation=ventilation)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    expected = np.asarray(jp._resolver.get(
        jp.sim_state["particles"], "Reynolds number", env=jp.sim_state["env"]
    ))
    assert (expected > 0).all()
    np.testing.assert_allclose(_reynolds(tp).numpy(), expected, rtol=1e-12)


def test_froessling_differs_from_neglect():
    """``TestVentilation::test_froessling_differs_from_neglect``"""
    p_vent, p_negl = _ventilated(), _neglected()
    assert float(np.mean(p_vent.attributes["radius"])) != float(
        np.mean(p_negl.attributes["radius"])
    )
    formulae = p_vent.formulae
    re = _reynolds(p_vent).numpy()
    cell = p_vent.sim_state["particles"].cell_id.numpy()
    T = p_vent.get_env("T")[cell]
    p_amb = p_vent.get_env("p")[cell]
    rho_air = p_vent.get_env("air_density")[cell]
    eta_air = p_vent.get_env("air_viscosity")[cell]
    D = np.asarray(formulae.diffusion_thermics.D(T, p_amb), dtype=float)
    Sc = np.asarray(formulae.trivia.air_schmidt_number(
        dynamic_viscosity=eta_air, diffusivity=D, density=rho_air
    ))
    vent = np.asarray(formulae.ventilation.ventilation_coefficient(
        sqrt_re_times_cbrt_sc=np.sqrt(re) * np.cbrt(Sc)
    ))
    np.testing.assert_allclose(vent, 1.0 + 0.276 * np.sqrt(re) * np.cbrt(Sc), rtol=1e-6)
    assert (vent > 1.0).all()


# --- the entry points default to the card -----------------------------------
def _refuses_without_cuda(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_lowe_simulation_defaults_to_the_card(monkeypatch):
    settings = lowe_et_al_2019.Settings(
        dz=5.0, n_sd_per_mode=4,
        aerosol=lowe_et_al_2019.AerosolMarine(water_molar_volume=WMV),
        model="Constant",
    )
    _refuses_without_cuda(monkeypatch, lambda: lowe_et_al_2019.Simulation(settings))


def test_arabas_shima_simulation_defaults_to_the_card(monkeypatch):
    settings = _arabas_shima_settings(arabas_and_shima_2017)
    _refuses_without_cuda(
        monkeypatch, lambda: arabas_and_shima_2017.Simulation(settings)
    )


def test_yang_simulation_defaults_to_the_card(monkeypatch):
    settings = _yang_settings(yang_et_al_2018)
    _refuses_without_cuda(monkeypatch, lambda: yang_et_al_2018.Simulation(settings))


def test_jensen_nugent_simulation_defaults_to_the_card(monkeypatch):
    _refuses_without_cuda(
        monkeypatch, lambda: _jensen_nugent(jensen_and_nugent_2017)
    )
