"""The SciPy ODE condensation solver and the profiling helpers of the port
(``pysdm_tpu_torch/utils/scipy_ode_condensation_solver.py``,
``utils/profiling.py``) on the CPU, in float64:

- ``TestScipyOdeSolver`` of ``tests/unit/test_checkpoint_and_scipy_solver.py``
  replayed: the implicit solver and the LSODA integration agree on the
  parcel (32 drops, kappa = 0.5, w = 2 m/s, 200 steps) at the JAX test's
  bounds, T to rtol 1e-4, qv to 5e-3, liquid water to 2e-2;
- the port's SciPy path against the JAX package's on the same parcel
  started near saturation (qv0 = 0.0226, 30 steps: the drops activate), at
  rtol 1e-6, the integrator's own tolerance: the two evaluate the same
  right-hand side, each through its package's formulae;
- the patched chain runs under ``enable_per_dynamic_timing``;
- ``test_profile_run_reports_per_dynamic_times`` of
  ``tests/unit/test_misc_models.py`` replayed, and the ``trace`` context.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pysdm_tpu import Builder as JaxBuilder
from pysdm_tpu import Formulae as JaxFormulae
from pysdm_tpu.backends import CPU as JaxCPU
from pysdm_tpu.dynamics import (
    AmbientThermodynamics as JaxAmbientThermodynamics,
    Condensation as JaxCondensation,
)
from pysdm_tpu.environments import Parcel as JaxParcel
from pysdm_tpu.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity as JaxConstantMultiplicity,
)
from pysdm_tpu.initialisation.spectra import Lognormal as JaxLognormal
from pysdm_tpu.utils.scipy_ode_condensation_solver import (
    patch_particulator as jax_patch_particulator,
)

from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation
from pysdm_tpu_torch.environments import Parcel
from pysdm_tpu_torch.utils.profiling import profile_run, trace
from pysdm_tpu_torch.utils.scipy_ode_condensation_solver import (
    patch_particulator,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402

NEAR_SATURATION_QV0 = 0.0226
ENV_KEYS = ("T", "p", "RH", "qv", "thd", "rhod", "z")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one intra-op thread: the tier-1 run puts several test files on the
    cores at once"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_parcel(scipy_solver=False, n_sd=32, qv0=0.0158):
    """the JAX test's ``build_parcel`` on the port (``chip_smoke.build_parcel``
    builds the same parcel)"""
    p = chip_smoke.build_parcel(n_sd, CPU, True, qv0=qv0)
    return patch_particulator(p) if scipy_solver else p


def build_jax_parcel(scipy_solver=False, n_sd=32, qv0=0.0158):
    formulae = JaxFormulae(seed=44)
    env = JaxParcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=qv0, T0=300.0, w=2.0,
    )
    builder = JaxBuilder(n_sd=n_sd, backend=JaxCPU(formulae), environment=env)
    builder.add_dynamic(JaxAmbientThermodynamics())
    builder.add_dynamic(JaxCondensation(adaptive=True))
    spectrum = JaxLognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = JaxConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    p = builder.build(attributes)
    return jax_patch_particulator(p) if scipy_solver else p


def liquid(p):
    return float((
        np.asarray(p.attributes["multiplicity"], dtype=float)
        * np.asarray(p.attributes["water mass"])
    ).sum())


class TestScipyOdeSolver:
    @staticmethod
    def test_cross_validates_implicit_solver():
        """the bespoke implicit solver and an independent adaptive ODE
        integration agree on the parcel activation transient"""
        n_steps = 200
        p_impl = build_parcel(scipy_solver=False)
        p_impl.run(n_steps)
        p_scipy = build_parcel(scipy_solver=True)
        p_scipy.run(n_steps)

        T_i, T_s = float(p_impl.get_env("T")[0]), float(
            p_scipy.get_env("T")[0]
        )
        qv_i, qv_s = float(p_impl.get_env("qv")[0]), float(
            p_scipy.get_env("qv")[0]
        )
        np.testing.assert_allclose(T_i, T_s, rtol=1e-4)
        np.testing.assert_allclose(qv_i, qv_s, rtol=5e-3)
        np.testing.assert_allclose(liquid(p_impl), liquid(p_scipy), rtol=2e-2)


def test_scipy_path_matches_the_jax_packages():
    n_steps = 30
    port = build_parcel(scipy_solver=True, qv0=NEAR_SATURATION_QV0)
    jax = build_jax_parcel(scipy_solver=True, qv0=NEAR_SATURATION_QV0)
    port.run(n_steps)
    jax.run(n_steps)
    assert port.condensation_solver_patched.kind == "scipy_ode"
    # the drops activated: RH passed saturation on the way
    assert float(port.get_counter("condensation_RH_max")[0]) > 1.0
    for key in ENV_KEYS:
        np.testing.assert_allclose(
            port.get_env(key), np.asarray(jax.get_env(key)), rtol=1e-6,
            err_msg=key,
        )
    np.testing.assert_allclose(
        port.attributes["water mass"], np.asarray(jax.attributes["water mass"]),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        port.get_counter("condensation_RH_max"),
        np.asarray(jax.get_counter("condensation_RH_max")), rtol=1e-6,
    )


def test_patched_chain_under_per_dynamic_timing():
    """``enable_per_dynamic_timing`` runs ``_named_step_fns``, where the
    host step stands in Condensation's place: the same state as ``run``"""
    plain = build_parcel(scipy_solver=True, n_sd=8)
    timed = build_parcel(scipy_solver=True, n_sd=8)
    timed.enable_per_dynamic_timing()
    plain.run(5)
    timed.run(5)
    assert timed.timers["Condensation"] > 0
    for key in ENV_KEYS:
        np.testing.assert_array_equal(timed.get_env(key), plain.get_env(key))
    np.testing.assert_array_equal(
        timed.attributes["water mass"], plain.attributes["water mass"]
    )


def test_profile_run_reports_per_dynamic_times(tmp_path):
    env = Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.015, T0=295.0, w=1.0,
    )
    builder = Builder(n_sd=8, backend=CPU(Formulae(seed=4)), environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=False))
    attributes = env.init_attributes(
        n_in_dv=np.full(8, 1e6), kappa=0.5, r_dry=np.full(8, 50e-9)
    )
    particulator = builder.build(attributes)
    times = profile_run(particulator, 3, logdir=tmp_path)
    assert set(times) >= {"AmbientThermodynamics", "Condensation"}
    assert all(v > 0 for v in times.values())
    assert particulator.n_steps == 3
    assert any(tmp_path.iterdir())  # a trace was captured


def test_profile_run_names_each_dynamic_in_the_trace(tmp_path):
    """each dynamic's scope is in the trace, and the run it profiled is the
    run ``run`` would have made"""
    import json

    p = build_parcel(n_sd=8)
    reference = build_parcel(n_sd=8)
    times = profile_run(p, 2, logdir=tmp_path)
    reference.run(2)
    (path,) = tmp_path.iterdir()
    with open(path, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(times) <= names
    np.testing.assert_array_equal(
        p.attributes["water mass"], reference.attributes["water mass"]
    )
    with trace(tmp_path / "block") as prof:
        p.run(1)
    assert prof.key_averages()
    assert any((tmp_path / "block").iterdir())
