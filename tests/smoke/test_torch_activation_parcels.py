"""The activation parcels that need only what is ported, on the port's CPU
backend (float64), against the JAX package and at the JAX tests' bounds:
``TestPyrcel``, ``TestGrabowskiPawlowska2023`` (pristine and polluted) and
``TestAbdulRazzakGhan2000`` of ``tests/smoke/test_models.py``, at their
sizes.

Each model runs through its entry point in both packages, with the
model module's ``Builder`` patched so that every ``run`` call records the
state: the environment to rtol 1e-10 and the water masses to 1e-8 at every
step, the tolerances and reasons ``test_torch_parcel_models.py`` states
(the per-drop solves stop at rtol_x, so an ulp in an input moves a root by
an ulp of its bracket). Every product the models read is held to 1e-8.
Then each JAX test's bounds on the port, the refusal of ``scipy_solver``
and the card as every entry point's default backend.
"""

import functools

import numpy as np
import pytest
import torch

from pysdm_tpu import Formulae as JaxFormulae
from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.models import abdul_razzak_ghan_2000 as jax_arg
from pysdm_tpu.models import grabowski_and_pawlowska_2023 as jax_gp
from pysdm_tpu.models import pyrcel as jax_pyrcel

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.initialisation import spectra
from pysdm_tpu_torch.models import abdul_razzak_ghan_2000 as arg
from pysdm_tpu_torch.models import grabowski_and_pawlowska_2023 as gp
from pysdm_tpu_torch.models import pyrcel
from pysdm_tpu_torch.physics import si

ENV_KEYS = ("thd", "qv", "rhod", "T", "p", "RH", "z")
RTOL_ENV, RTOL_MASS, RTOL_PRODUCTS = 1e-10, 1e-8, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def recorded(module, run):
    """``run()`` with ``module.Builder`` patched so that each ``run`` call
    of the particulator it builds records (step count, env, water masses);
    returns (run's result, the records)"""
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
                    np.asarray(p.attributes["water mass"]).copy(),
                ))

            p.run = run_and_record
            return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "Builder", RecordingBuilder)
        return run(), records


def assert_same_records(port, jax):
    assert len(port) == len(jax) > 1
    for (t_steps, t_env, t_mass), (j_steps, j_env, j_mass) in zip(port, jax):
        assert t_steps == j_steps
        for key in ENV_KEYS:
            np.testing.assert_allclose(
                t_env[key], j_env[key], rtol=RTOL_ENV,
                err_msg=f"{key} at step {t_steps}",
            )
        np.testing.assert_allclose(
            t_mass, j_mass, rtol=RTOL_MASS, err_msg=f"mass at step {t_steps}"
        )


def assert_same_products(port, jax, names):
    for name in names:
        np.testing.assert_allclose(
            np.asarray(port[name], dtype=float),
            np.asarray(jax[name], dtype=float),
            rtol=RTOL_PRODUCTS, err_msg=name,
        )


# --- Grabowski & Pawlowska 2023 ---------------------------------------------
GP_PRODUCTS = (
    "S_max", "RH", "z", "t", "r_mean", "ripening rate", "activating rate",
    "deactivating rate",
)


def _gp_settings(module, aerosol, n_sd=32):
    return module.Settings(
        aerosol=aerosol, vertical_velocity=1.0 * si.m / si.s,
        dt=2 * si.s, n_sd=n_sd, displacement=100 * si.m,
    )


@functools.cache
def _gp(aerosol):
    port = recorded(gp, lambda: gp.Simulation(
        _gp_settings(gp, aerosol), backend_class=CPU
    ).run())
    jax = recorded(jax_gp, lambda: jax_gp.Simulation(
        _gp_settings(jax_gp, aerosol)
    ).run())
    return port, jax


@pytest.mark.parametrize("aerosol", ("pristine", "polluted"))
def test_grabowski_pawlowska_matches_jax_package_step_by_step(aerosol):
    (out, port), (want, jax) = _gp(aerosol)
    assert len(port) == 51  # run(0), then 50 steps of 2 s
    assert_same_records(port, jax)
    assert_same_products(out["products"], want["products"], GP_PRODUCTS)
    np.testing.assert_array_equal(
        out["attributes"]["multiplicity"], want["attributes"]["multiplicity"]
    )


@pytest.mark.parametrize("aerosol", ("pristine", "polluted"))
def test_grabowski_pawlowska_activation_and_supersaturation(aerosol):
    """``TestGrabowskiPawlowska2023::test_activation_and_supersaturation``"""
    out = _gp(aerosol)[0][0]
    s_max = np.nanmax(out["products"]["S_max"])
    assert 0.0 < s_max < 0.05
    v0 = np.asarray(out["attributes"]["volume"][0])
    v1 = np.asarray(out["attributes"]["volume"][-1])
    assert v1.sum() > v0.sum()
    assert np.isfinite(out["products"]["ripening rate"]).all()


def test_grabowski_pawlowska_aerosol_matches_jax_package():
    for aerosol in ("pristine", "polluted"):
        port = gp.AEROSOL_MODES_BY_KAPPA[aerosol][1.28]
        ref = jax_gp.AEROSOL_MODES_BY_KAPPA[aerosol][1.28]
        r = np.logspace(-9, -6, 31)
        np.testing.assert_allclose(
            port.size_distribution(r), np.asarray(ref.size_distribution(r)),
            rtol=1e-12,
        )
    assert gp.CONDENSATION_TOLERANCE == jax_gp.CONDENSATION_TOLERANCE


# --- Abdul-Razzak & Ghan 2000 -----------------------------------------------
ARG_KWARGS = dict(
    w=0.5, sol2=1.0, N2=100 / si.cm**3, rad2=50 * si.nm, n_sd_per_mode=16,
    n_steps=30,
)


@functools.cache
def _arg():
    port = recorded(arg, lambda: arg.run_parcel(**ARG_KWARGS, backend_class=CPU))
    jax = recorded(jax_arg, lambda: jax_arg.run_parcel(**ARG_KWARGS))
    return port, jax


def test_abdul_razzak_ghan_matches_jax_package_step_by_step():
    (out, port), (want, jax) = _arg()
    assert len(port) == 30
    assert_same_records(port, jax)
    assert_same_products(
        out.output, want.output, ("liquid water mixing ratio", "S max", "RH", "z")
    )
    for name in ("activated_fraction_S", "activated_fraction_V", "error"):
        np.testing.assert_array_equal(
            getattr(out, name), getattr(want, name), err_msg=name
        )
    for name in ("critical volume", "critical saturation"):
        np.testing.assert_allclose(
            out.particulator.attributes[name],
            np.asarray(want.particulator.attributes[name]), rtol=1e-8,
            err_msg=name,
        )


def test_abdul_razzak_ghan_mode1_activated_fraction():
    """``TestAbdulRazzakGhan2000::test_mode1_activated_fraction``"""
    out = _arg()[0][0]
    np.testing.assert_allclose(
        out.activated_fraction_S[0], out.activated_fraction_S[1], atol=0.12
    )
    assert 0.05 < out.activated_fraction_S[0] < 0.95
    np.testing.assert_allclose(
        out.activated_fraction_S, out.activated_fraction_V, atol=0.25
    )


@pytest.mark.parametrize("sol2", (0.0, 0.3, 1.0))
def test_abdul_razzak_ghan_aerosol_matches_jax_package(sol2):
    wmv = 18.015e-3 / 1000.0
    port = arg.AerosolARG(water_molar_volume=wmv, M2_sol=sol2)
    ref = jax_arg.AerosolARG(water_molar_volume=wmv, M2_sol=sol2)
    for p_mode, j_mode in zip(port.modes, ref.modes):
        np.testing.assert_allclose(
            p_mode["kappa"]["Constant"], j_mode["kappa"]["Constant"],
            rtol=1e-12,
        )
        assert p_mode["spectrum"].norm_factor == j_mode["spectrum"].norm_factor


# --- pyrcel -----------------------------------------------------------------
def _pyrcel_settings(module, formulae, spectra_module, n_sd_per_mode=(16, 16)):
    return module.Settings(
        dz=10 * si.m,
        n_sd_per_mode=n_sd_per_mode,
        aerosol_modes_by_kappa={
            0.54: spectra_module.Lognormal(
                norm_factor=850 / si.cm**3, m_mode=15 * si.nm, s_geom=1.6
            ),
            1.2: spectra_module.Lognormal(
                norm_factor=10 / si.cm**3, m_mode=850 * si.nm, s_geom=1.2
            ),
        },
        vertical_velocity=1.0 * si.m / si.s,
        initial_pressure=775 * si.mbar,
        initial_temperature=274 * si.K,
        initial_relative_humidity=0.98,
        displacement=250 * si.m,
        formulae=formulae(constants={"MAC": 0.3}, seed=44),
    )


@functools.cache
def _pyrcel():
    port = recorded(pyrcel, lambda: pyrcel.Simulation(
        _pyrcel_settings(pyrcel, pysdm_tpu_torch.Formulae, spectra),
        backend_class=CPU,
    ).run())
    jax = recorded(jax_pyrcel, lambda: jax_pyrcel.Simulation(
        _pyrcel_settings(jax_pyrcel, JaxFormulae, jax_spectra)
    ).run())
    return port, jax


def test_pyrcel_matches_jax_package_step_by_step():
    (out, port), (want, jax) = _pyrcel()
    assert len(port) == 26  # run(0), then 25 steps of 10 s
    assert_same_records(port, jax)
    assert_same_products(
        out["products"], want["products"], ("S_max", "RH", "z", "t")
    )


def test_pyrcel_supersaturation_peak_and_activation():
    """``TestPyrcel::test_supersaturation_peak_and_activation``"""
    out = _pyrcel()[0][0]
    smax = np.nanmax(out["products"]["S_max"])
    assert 0.001 < smax < 0.01
    vol_final = out["attributes"]["volume"][-1]
    r_final = (3 * vol_final / 4 / np.pi) ** (1 / 3)
    assert (r_final[16:] > 1e-6).all()


# --- refusals and the default backend ---------------------------------------
def test_scipy_solver_names_its_roadmap_item():
    """the SciPy ODE solver came with "exporters and utils" (ROADMAP queue
    1, item 9): both models take ``scipy_solver=True`` and run the LSODA
    host step in Condensation's place. Pyrcel's run at its test's n_sd (16
    + 16) stays within the implicit run's T, qv and liquid water at
    ``TestScipyOdeSolver``'s bounds (rtol 1e-4, 5e-3, 2e-2); Grabowski &
    Pawlowska's patched chain takes a step"""
    sim = pyrcel.Simulation(
        _pyrcel_settings(pyrcel, pysdm_tpu_torch.Formulae, spectra),
        backend_class=CPU, scipy_solver=True,
    )
    p = sim.particulator
    assert p.condensation_solver_patched.kind == "scipy_ode"
    out = sim.run()
    implicit = _pyrcel()[0][0]
    np.testing.assert_allclose(out["products"]["RH"], implicit["products"]["RH"], rtol=5e-3)
    implicit_records = _pyrcel()[0][1]
    _, env, mass = implicit_records[-1]
    np.testing.assert_allclose(p.get_env("T"), env["T"], rtol=1e-4)
    np.testing.assert_allclose(p.get_env("qv"), env["qv"], rtol=5e-3)
    mult = p.attributes["multiplicity"].astype(float)
    np.testing.assert_allclose(
        (mult * p.attributes["water mass"]).sum(), (mult * mass).sum(),
        rtol=2e-2,
    )
    gp_sim = gp.Simulation(
        _gp_settings(gp, "pristine"), backend_class=CPU, scipy_solver=True
    )
    assert gp_sim.particulator.condensation_solver_patched.kind == "scipy_ode"
    gp_sim.particulator.run(1)
    assert np.isfinite(gp_sim.particulator.get_env("T")).all()


def _refuses_without_cuda(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_pyrcel_simulation_defaults_to_the_card(monkeypatch):
    settings = _pyrcel_settings(pyrcel, pysdm_tpu_torch.Formulae, spectra, (2, 2))
    _refuses_without_cuda(monkeypatch, lambda: pyrcel.Simulation(settings))


def test_grabowski_pawlowska_simulation_defaults_to_the_card(monkeypatch):
    settings = _gp_settings(gp, "pristine", n_sd=4)
    _refuses_without_cuda(monkeypatch, lambda: gp.Simulation(settings))


def test_abdul_razzak_ghan_run_parcel_defaults_to_the_card(monkeypatch):
    _refuses_without_cuda(
        monkeypatch,
        lambda: arg.run_parcel(**{**ARG_KWARGS, "n_sd_per_mode": 2}),
    )
