"""``tests/unit/test_new_attributes.py``'s ``TestCoolingRate`` and
``TestAcidityAttributes`` replayed on the port, each beside the JAX
package on the same build (``test_torch_freezing.py`` holds the cooling
rate of a freezing box after a step, ``test_torch_chemistry.py`` the pH of
a chemistry box; neither holds the NaN at t = 0, the zero rate, or the pH
resolver on a box without chemistry):

- the "cooling rate" product NaN before the first step, 0 with no change
  of T, -dT/dt after one, equal to the JAX package's at rtol 1e-12;
- "pH" and "conc_H" of three drops (pure water and two ammonium loads):
  finite, 7 for pure water, rising with ammonium, conc_H = pH2H(pH), and
  equal to the JAX package's at rtol 1e-10.
"""

import numpy as np
import pytest

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.environments
import pysdm_tpu.products.freezing
import pysdm_tpu_torch
import pysdm_tpu_torch.backends
import pysdm_tpu_torch.environments
import pysdm_tpu_torch.products.freezing

T0 = 300.0
N_SD = 64
DT = 44.0
D_T = -2.0
PACKAGES = {"port": pysdm_tpu_torch, "jax": pysdm_tpu}


def _make_cooling_rate_particulator(package):
    pkg = PACKAGES[package]
    env = pkg.environments.Box(dt=DT, dv=1.0)
    builder = pkg.Builder(
        n_sd=N_SD, backend=pkg.backends.CPU(pkg.Formulae(seed=1)),
        environment=env,
    )
    env["T"] = np.asarray([T0])
    particulator = builder.build(
        attributes={
            "multiplicity": np.ones(N_SD),
            "volume": np.linspace(0.01, 10, N_SD) * 1e-18,
        },
        products=(pkg.products.freezing.CoolingRate(),),
    )
    return particulator, env


def _cooling_rates(run, d_t=0.0):
    """the product in both packages after ``run`` steps, T moved by
    ``d_t`` after them"""
    out = {}
    for package in PACKAGES:
        particulator, env = _make_cooling_rate_particulator(package)
        particulator.run(run)
        if d_t:
            env["T"] = np.asarray([T0 + d_t])
        out[package] = np.asarray(particulator.products["cooling rate"].get())
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-12)
    return out["port"]


class TestCoolingRate:
    @staticmethod
    def test_nan_at_t_zero():
        assert np.isnan(_cooling_rates(0)).all()

    @staticmethod
    def test_zero_with_no_env_change():
        np.testing.assert_allclose(_cooling_rates(1), 0.0)

    @staticmethod
    def test_with_env_change():
        np.testing.assert_allclose(_cooling_rates(1, D_T), -D_T / DT)


def _acidity(package):
    pkg = PACKAGES[package]
    formulae = pkg.Formulae(seed=1)
    env = pkg.environments.Box(dt=1.0, dv=1.0)
    builder = pkg.Builder(
        n_sd=3, backend=pkg.backends.CPU(formulae), environment=env
    )
    env["T"] = np.asarray([298.15])
    builder.request_attribute("pH")
    volume = np.full(3, 4.19e-15)  # ~10 um radius droplets, in m^3
    n_minus_iii = np.asarray([0.0, 1e-17, 1e-16])  # mol NH4 per droplet
    particulator = builder.build(
        attributes={
            "multiplicity": np.ones(3),
            "water mass": volume * 1e3,
            "moles_N_mIII": n_minus_iii,
            **{
                f"moles_{k}": np.zeros(3)
                for k in ("N_V", "C_IV", "S_IV", "S_VI", "O3", "H2O2")
            },
        },
    )
    return formulae, {
        name: np.asarray(particulator.get_attribute(name))
        for name in ("pH", "conc_H")
    }


class TestAcidityAttributes:
    @staticmethod
    def test_ph_and_conc_h():
        formulae, got = _acidity("port")
        _, want = _acidity("jax")
        pH = got["pH"]
        assert np.isfinite(pH).all()
        # pure water -> pH 7; ammonia shifts it basic, monotonically
        np.testing.assert_allclose(pH[0], 7.0, atol=0.05)
        assert pH[1] > pH[0] and pH[2] > pH[1]
        np.testing.assert_allclose(
            got["conc_H"], np.asarray(formulae.trivia.pH2H(pH)), rtol=1e-10
        )
        for name in got:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-10)


@pytest.mark.parametrize("package", PACKAGES)
def test_cooling_rate_product_is_registered(package):
    particulator, _ = _make_cooling_rate_particulator(package)
    assert "cooling rate" in particulator.products
