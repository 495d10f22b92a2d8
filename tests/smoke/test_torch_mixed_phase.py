"""The ice models through their entry points on the port's ``CPU`` backend
(float64): the JAX package's tests of them replayed at their bounds, and
the two mixed-phase parcels held against the JAX package step by step.

Replayed on the port:
- the five tests of ``tests/smoke/test_mixed_phase_parcels.py``
  (Spichtinger et al. 2023 and Abade & Albuquerque 2024), and the total
  water of the Spichtinger parcel to 1e-5;
- ``TestAlpertKnopf2016`` and ``TestNiedermeier2014`` of
  ``tests/smoke/test_models.py``.

Step by step against the JAX package (``Simulation.run`` of both, the
port's particulator stepping the JAX one beside it and comparing after
every step): signed masses, T and qv at rtol 1e-10 and the frozen masks
equal. The Spichtinger parcel (32 super-droplets, 200 steps through the
nucleation burst near step 85) under u01 injection, the same rows given to
both; the Abade parcel (64 super-droplets, 700 steps of 10 s: cloud, then
singular immersion freezing and deposition) needs none, its freezing is
singular.
"""

import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.models.abade_and_albuquerque_2024 as jax_abade
import pysdm_tpu.models.spichtinger_et_al_2023 as jax_spichtinger

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.initialisation import spectra as spc
from pysdm_tpu_torch.models import (
    abade_and_albuquerque_2024,
    alpert_and_knopf_2016,
    niedermeier_et_al_2014,
    spichtinger_et_al_2023,
)
from pysdm_tpu_torch.physics import Formulae, si


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs (the tests run in several
    processes at once)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _injecting(package):
    class Builder(package.Builder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.enable_u01_injection()

    return Builder


def _lockstep(tp, jp, u01_rows=None):
    """make ``tp.run`` advance the JAX particulator ``jp`` beside the port's,
    one step at a time, comparing after each; ``u01_rows(n_sd)``: the rows
    both get before a step. Returns the count of steps compared."""
    run = tp.run
    steps = []

    def lockstep_run(n):
        for _ in range(n):
            if u01_rows is not None:
                rows = u01_rows(tp.n_sd)
                tp.inject_u01(rows)
                jp.inject_u01(rows)
            run(1)
            jp.run(1)
            want = np.asarray(jp.attributes["signed water mass"])
            got = tp.attributes["signed water mass"]
            np.testing.assert_array_equal(got < 0, want < 0)
            np.testing.assert_allclose(got, want, rtol=1e-10)
            for key in ("T", "qv", "thd", "RH"):
                np.testing.assert_allclose(
                    tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-10
                )
            steps.append((got < 0).sum())

    tp.run = lockstep_run
    return steps


# --- Spichtinger et al. 2023 ---------------------------------------------------
def _spichtinger_settings(module):
    return module.Settings(n_sd=32, w_updraft=5.0, T0=220.0, seed=44, dt=1.0)


class TestSpichtingerEtAl2023:
    @pytest.fixture(scope="class")
    def output(self):
        settings = _spichtinger_settings(spichtinger_et_al_2023)
        sim = spichtinger_et_al_2023.Simulation(settings, backend_class=CPU)
        return settings, sim, sim.run(n_steps=400, steps_per_output=20)

    def test_homogeneous_nucleation_burst(self, output):
        settings, _, out = output
        assert out["RH_ice"][0] == pytest.approx(1.0, abs=1e-6)
        assert 1.4 < np.nanmax(out["RH_ice"]) < 1.7
        assert out["RH_ice"][-1] < 1.1
        assert out["n_i"][0] == 0
        assert out["n_i"][-1] > 1e6
        assert out["n_i"][-1] <= settings.N_dv_solution_droplet * 1.01

    def test_ice_growth_and_budget(self, output):
        settings, sim, out = output
        assert (np.diff(out["qi"][out["qi"] > 0]) >= -1e-18).all()
        assert out["qi"][-1] > 0
        p = sim.particulator
        sm = p.attributes["signed water mass"]
        mult = p.attributes["multiplicity"]
        qv = float(p.get_env("qv")[0])
        total = qv + float((mult * np.abs(sm)).sum()) / settings.mass_of_dry_air
        assert total == pytest.approx(
            settings.initial_water_vapour_mixing_ratio, rel=1e-3
        )

    def test_total_water_is_conserved(self, output):
        """vapour + liquid + ice per dry-air mass, before and after the
        burst, to 1e-5"""
        settings, sim, _ = output
        fresh = spichtinger_et_al_2023.Simulation(settings, backend_class=CPU)

        def total(p):
            water = p.attributes["multiplicity"] * np.abs(
                p.attributes["signed water mass"]
            )
            return float(p.get_env("qv")[0]) + water.sum() / settings.mass_of_dry_air

        assert total(sim.particulator) == pytest.approx(
            total(fresh.particulator), rel=1e-5
        )

    def test_matches_jax_package_step_by_step_under_u01_injection(self, monkeypatch):
        monkeypatch.setattr(
            spichtinger_et_al_2023, "Builder", _injecting(pysdm_tpu_torch)
        )
        monkeypatch.setattr(jax_spichtinger, "Builder", _injecting(pysdm_tpu))
        tsim = spichtinger_et_al_2023.Simulation(
            _spichtinger_settings(spichtinger_et_al_2023), backend_class=CPU
        )
        jsim = jax_spichtinger.Simulation(_spichtinger_settings(jax_spichtinger))
        rng = np.random.default_rng(2023)
        frozen = _lockstep(
            tsim.particulator, jsim.particulator,
            lambda n: {"freezing_homogeneous": rng.uniform(size=n)},
        )
        out = tsim.run(n_steps=200, steps_per_output=20)
        assert len(frozen) == 200
        assert frozen[0] == 0 and frozen[-1] > 0
        assert out["n_i"][-1] > 1e6


# --- Abade & Albuquerque 2024 --------------------------------------------------
class TestAbadeAndAlbuquerque2024:
    @pytest.fixture(scope="class")
    def output(self):
        """the port's ``Simulation.run`` with the JAX package's parcel
        stepped beside it"""
        settings = abade_and_albuquerque_2024.Settings(
            n_sd=64, timestep=10.0, seed=44
        )
        sim = abade_and_albuquerque_2024.Simulation(settings, backend_class=CPU)
        jsim = jax_abade.Simulation(
            jax_abade.Settings(n_sd=64, timestep=10.0, seed=44)
        )
        frozen = _lockstep(sim.particulator, jsim.particulator)
        out = sim.run(nt=700, steps_per_output_interval=50)["products"]
        return settings, sim, out, frozen

    def test_matches_jax_package_step_by_step(self, output):
        _, _, _, frozen = output
        assert len(frozen) == 700
        assert frozen[0] == 0 and frozen[-1] > 0

    def test_cloud_then_glaciation(self, output):
        _, _, out, _ = output
        water, ice = out["water"], out["ice"]
        assert water[0] < 1e-8
        assert water.max() > 1e-4
        assert ice[np.argmax(water)] < ice[-1]
        assert ice[-1] > 1e-3
        assert water[-1] < 1e-6
        assert out["vapour"][-1] < 0.3 * out["vapour"][0]

    def test_freezing_onset_temperature(self, output):
        _, _, out, _ = output
        first_ice = np.argmax(out["ice"] > 0)
        assert 238 < out["T"][first_ice] < 260

    def test_toggles(self):
        settings = abade_and_albuquerque_2024.Settings(
            n_sd=16, timestep=10.0,
            enable_immersion_freezing=False,
            enable_vapour_deposition_on_ice=False,
        )
        sim = abade_and_albuquerque_2024.Simulation(settings, backend_class=CPU)
        out = sim.run(nt=50, steps_per_output_interval=25)["products"]
        assert (out["ice"] == 0).all()


# --- tests/smoke/test_models.py ---------------------------------------------
def test_alpert_knopf_2016_constant_jhet_exponential_decay():
    J_het, A = 1e7, 1e-9
    dt, nt = 10.0, 20
    spec = spc.Lognormal(norm_factor=1000 / 1e-6, m_mode=A, s_geom=1.0)
    f_ufz, a_tot = alpert_and_knopf_2016.simulation(
        constants={"J_HET": J_het},
        seed=1, n_sd=1000, time_step=dt, volume=1e-6,
        spectrum=spec, droplet_volume=1e-18, multiplicity=1,
        total_time=dt * nt, number_of_real_droplets=1000,
        cooling_rate=0,
        heterogeneous_ice_nucleation_rate="Constant",
        initial_temperature=240.0,
        backend_class=CPU,
    )
    f = np.asarray(f_ufz)
    t = dt * np.arange(len(f))
    assert abs(f[-1] - np.exp(-J_het * A * t)[-1]) < 0.1
    assert (np.diff(f) <= 0).all()
    assert a_tot[-1] < a_tot[0]


def test_niedermeier_2014_immersion_freezing_produces_ice():
    settings = niedermeier_et_al_2014.Settings(
        formulae=Formulae(
            seed=44,
            particle_shape_and_density="MixedPhaseSpheres",
            heterogeneous_ice_nucleation_rate="Constant",
            constants={"J_HET": 1e12},
        ),
        initial_temperature=250.0 * si.K,
        timestep=5 * si.s,
        ccn_sampling_n=5,
        in_sampling_n=4,
    )
    sim = niedermeier_et_al_2014.Simulation(settings, backend_class=CPU)
    out = sim.run()
    iwc = np.asarray(out["ice water content"])
    assert iwc[0] == 0.0
    assert iwc[-1] > 0.0
    T = np.asarray(out["T"])
    assert T[-1] < T[0]
