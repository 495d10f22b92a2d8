"""The isotope models on the port against the JAX package, in float64 on
the CPU: each helper of the eight modules at its defaults (rtol 1e-12: the
same NumPy around formulae that agree to an ulp), Rozanski & Sonntag's
one-drop parcel (rtol 1e-10, the parcel's environment tolerance of
``test_torch_activation_parcels.py``: its condensation solve stops at
rtol_x), and the JAX package's ``test_isotope_examples.py``,
``test_isotope_papers.py`` and ``test_isotope_papers2.py`` replayed on the
port: each JAX test runs with its module's names of the JAX package
(models, ``Formulae``, ``si``) bound to the port's.
"""

import importlib
import importlib.util
import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU

REPO = Path(__file__).resolve().parents[2]
RTOL, RTOL_PARCEL = 1e-12, 1e-10
MODELS = (
    "isotopes", "merlivat_and_nief_1967", "van_hook_1968",
    "gonfiantini_1986", "jouzel_and_merlivat_1984",
    "gedzelman_and_arnold_1994", "isotope_papers",
    "rozanski_and_sonntag_1982",
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(name):
    return (
        importlib.import_module(f"pysdm_tpu.models.{name}"),
        importlib.import_module(f"pysdm_tpu_torch.models.{name}"),
    )


def _assert_close(got, want, rtol, where=""):
    """nested dicts, tuples and arrays equal to ``rtol``; objects by their
    float attributes"""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _assert_close(got[key], want[key], rtol, f"{where}/{key}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, rtol, f"{where}[{i}]")
    elif hasattr(want, "__dict__") and not isinstance(want, np.ndarray):
        floats = {k: v for k, v in vars(want).items()
                  if isinstance(v, (float, np.floating))}
        assert floats, where
        for key, value in floats.items():
            _assert_close(getattr(got, key), value, rtol, f"{where}.{key}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=0, err_msg=where)


HELPERS = (
    ("isotopes", "equilibrium_fractionation_curves", {}),
    ("isotopes", "rayleigh_distillation", {}),
    ("isotopes", "meteoric_water_lines", {}),
    ("isotopes", "kinetic_fractionation_vs_humidity", {}),
    ("merlivat_and_nief_1967", "fig_2", {}),
    ("van_hook_1968", "fig_1", {}),
    ("gonfiantini_1986", "fig_3_1", {}),
    ("gonfiantini_1986", "delta", dict(
        delta_liq_0=-6e-3, remaining_water_fraction=np.linspace(1, 0.01, 9),
        humidity=0.5, delta_atmos=-12e-3, alpha=1.0098,
        D_ratio_vs_light=0.9691,
    )),
    ("jouzel_and_merlivat_1984", "pressure", dict(T=np.linspace(220, 270, 11))),
    ("jouzel_and_merlivat_1984", "fig_8", {}),
    ("jouzel_and_merlivat_1984", "fig_9", {}),
    ("gedzelman_and_arnold_1994", "fig_2", {}),
    ("isotope_papers", "bolin_1958_table_1", {}),
    ("isotope_papers", "miyake_et_al_1968_fig_19", {}),
    ("isotope_papers", "stewart_1975_fig_1", {}),
    ("isotope_papers", "pruppacher_rasmussen_1979_fig_1", {}),
    ("isotope_papers", "fisher_1991_fig_2", {}),
    ("isotope_papers", "bolot_et_al_2013_fig_1", {}),
    ("isotope_papers", "lamb_et_al_2017_fig_4", {}),
    ("isotope_papers", "graf_et_al_2019_table_1", {}),
    ("isotope_papers", "toon_et_al_1980_fig_1", {}),
    ("isotope_papers", "zaba_et_al_timescales", {}),
    ("isotope_papers", "kinzer_and_gunn_1951_evaporation", {}),
    ("isotope_papers", "pierchala_et_al_2022_excess_17O", {}),
    ("rozanski_and_sonntag_1982", "Rv_prim", dict(
        Rl=1.6e-4, Nl=1e-3, Rv=1.5e-4, Nv=1e-2, dNl=2e-3, Rr=1.55e-4,
        K=1.0, a=1.08,
    )),
)


@pytest.mark.parametrize(
    "module, helper, kwargs", HELPERS, ids=[f"{m}.{h}" for m, h, _ in HELPERS]
)
def test_helper_matches_jax_package(module, helper, kwargs):
    jax_module, module = _models(module)
    _assert_close(getattr(module, helper)(**kwargs),
                  getattr(jax_module, helper)(**kwargs), RTOL, helper)


def test_every_helper_is_compared():
    """each public function of the eight modules has a case above, or is a
    class or the parcel (compared below)"""
    named = {(m, h) for m, h, _ in HELPERS}
    for name in MODELS:
        _, module = _models(name)
        for helper, value in vars(module).items():
            if (inspect.isfunction(value) and not helper.startswith("_")
                    and value.__module__ == module.__name__):
                assert (name, helper) in named or helper in (
                    "run_parcel", "ice_saturation_curve_4",
                    "vapour_mixing_ratio",
                ), (name, helper)


def test_jouzel_merlivat_thermodynamics_match_jax_package():
    jax_module, module = _models("jouzel_and_merlivat_1984")
    T = np.linspace(225.0, 262.0, 9)
    jax_formulae, formulae = pysdm_tpu.Formulae(), pysdm_tpu_torch.Formulae()
    _assert_close(module.ice_saturation_curve_4(formulae.constants, T),
                  jax_module.ice_saturation_curve_4(jax_formulae.constants, T),
                  RTOL)
    _assert_close(module.vapour_mixing_ratio(formulae, T),
                  jax_module.vapour_mixing_ratio(jax_formulae, T), RTOL)


@pytest.fixture(scope="module", name="rozanski")
def _rozanski():
    """both packages' fig-4 multibox at the JAX test's settings: the
    one-drop parcel (40 steps of 300 s) and 401 sweeps on its profile"""
    jax_module, module = _models("rozanski_and_sonntag_1982")
    jax_box = jax_module.MultiBox(jax_module.Settings())
    settings = module.Settings()
    box = module.MultiBox(settings, backend_class=CPU)
    return jax_box, jax_box.run(), box, box.run()


def test_rozanski_parcel_matches_jax_package(rozanski):
    jax_box, _, box, _ = rozanski
    assert box.settings.nt == jax_box.settings.nt == 40
    _assert_close(box.profiles, jax_box.profiles, RTOL_PARCEL, "profiles")
    for name in ("QL", "QR", "delta_nl"):
        _assert_close(getattr(box, name), getattr(jax_box, name),
                      RTOL_PARCEL, name)


def test_rozanski_sweeps_match_jax_package(rozanski):
    _, want, _, got = rozanski
    assert len(got) == len(want) == 401
    _assert_close(got, want, RTOL_PARCEL, "sweeps")


def test_rozanski_parcel_defaults_to_the_card(monkeypatch):
    _, module = _models("rozanski_and_sonntag_1982")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.run_parcel(module.Settings())


# -- the JAX package's isotope model tests, replayed on the port -------------

JAX_TESTS = ("test_isotope_examples", "test_isotope_papers",
             "test_isotope_papers2")


def _jax_test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "tests" / "unit" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _replays():
    cases = []
    for name in JAX_TESTS:
        module = _jax_test_module(name)
        for attr, value in vars(module).items():
            if attr.startswith("test_") and inspect.isfunction(value):
                cases.append((name, attr, None))
            elif attr.startswith("Test") and inspect.isclass(value):
                cases.extend(
                    (name, attr, method) for method in vars(value)
                    if method.startswith("test_")
                )
    return cases


REPLAYS = _replays()


def _on_the_port(module, monkeypatch):
    """bind the JAX test module's names of the JAX package to the port's"""
    for attr, value in list(vars(module).items()):
        if isinstance(value, types.ModuleType) and (
            value.__name__.startswith("pysdm_tpu.")
        ):
            monkeypatch.setattr(module, attr, importlib.import_module(
                "pysdm_tpu_torch." + value.__name__[len("pysdm_tpu."):]
            ))
        elif value is pysdm_tpu.Formulae:
            monkeypatch.setattr(module, attr, pysdm_tpu_torch.Formulae)


@pytest.mark.parametrize(
    "test_module, test, method", REPLAYS,
    ids=[f"{m}::{t}" + (f"::{k}" if k else "") for m, t, k in REPLAYS],
)
def test_jax_isotope_model_test_on_the_port(test_module, test, method,
                                            rozanski, monkeypatch):
    module = _jax_test_module(test_module)
    _on_the_port(module, monkeypatch)
    if method is None:
        getattr(module, test)()
        return
    instance = getattr(module, test)()
    parameters = inspect.signature(getattr(instance, method)).parameters
    if "output" in parameters:
        # the JAX class fixture's (settings, multibox, sweeps), on the port
        _, _, box, sweeps = rozanski
        getattr(instance, method)((box.settings, box, sweeps))
    else:
        getattr(instance, method)()
