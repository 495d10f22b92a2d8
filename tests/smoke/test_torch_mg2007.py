"""The port's Morrison & Grabowski 2007 strato-cumulus
(``pysdm_tpu_torch/models/morrison_and_grabowski_2007.py``) against the JAX
package on the CPU, float64 on both sides, at the size of the JAX
``test_mixed_phase_simulation``: 6 x 6 cells, 8 super-droplets per cell,
dt 5 s, ``Bigg_1953`` freezing temperatures, ``MixedPhaseSpheres``; the
comparisons set Bigg's median depression (``BIGG_DT_MEDIAN``, NaN by
default, and so are the JAX test's freezing temperatures) to 33 K.

The mixed-phase grid carries the singular freezing temperature, a
max-merged row, so coalescence takes the float64 collision path in both
packages (``Collision.route()`` "float64"). Both ``make_simulation``s are
built here with u01 injection switched on before build and non-adaptive
coalescence (the packages' ``Builder`` and ``Coalescence`` patched for the
build only), the spin-up finished (collisions and sedimentation on), and
the same tie-free u01 streams injected before every step. Every other step
draws its gamma on [0, 1e-8), so that haze pairs merge and the max row is
merged too. Over 12 steps: env to rtol 1e-12, multiplicities and the
"freezing temperature" row exactly, the other attributes to rtol 1e-9.

Also: the JAX test's own assertions replayed on the port, the fig-1
velocity field at rtol 1e-12, the warm path delegating to Arabas et al.
2015, a JAX state carried across, and the card as the default backend.
"""

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.builder
import pysdm_tpu.dynamics
from pysdm_tpu.models import morrison_and_grabowski_2007 as jax_model
import pysdm_tpu_torch
import pysdm_tpu_torch.builder
import pysdm_tpu_torch.dynamics
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.models import morrison_and_grabowski_2007 as port_model
from pysdm_tpu_torch.physics import si

STEPS = 12
# the gamma draws' range in the steps that merge pairs
MERGING_GAMMA_SCALE = 1e-8
ENV_KEYS = ("thd", "qv", "RH", "T", "p")
# Bigg's median freezing-temperature depression; the constant is NaN by
# default (so are the JAX test's freezing temperatures), and the max-merge
# is seen only on numbers
BIGG = {"BIGG_DT_MEDIAN": 33 * si.K}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _settings(pkg, model, constants=None):
    """the JAX ``test_mixed_phase_simulation`` settings, freezing on"""
    settings = model.StratoCumulus(
        pkg.Formulae(
            seed=44,
            freezing_temperature_spectrum="Bigg_1953",
            particle_shape_and_density="MixedPhaseSpheres",
            constants=constants,
        ),
        rhod_w_max=1 * si.m / si.s * si.kg / si.m**3,
        grid=(6, 6),
        size=(1.5 * si.km, 1.5 * si.km),
        dt=5 * si.s,
        n_sd_per_gridbox=8,
        spin_up_time=0,
    )
    settings.processes["freezing"] = True
    return settings


def _injecting(mp, pkg, model, backend):
    """``model.make_simulation`` with u01 injection and non-adaptive
    coalescence (the package's Builder and Coalescence patched for the
    build only), the spin-up finished"""
    builder_module = getattr(pkg, "builder")
    dynamics = getattr(pkg, "dynamics")
    builder_class, coalescence = builder_module.Builder, dynamics.Coalescence

    class InjectingBuilder(builder_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.enable_u01_injection()

    with mp.context() as patch:
        patch.setattr(builder_module, "Builder", InjectingBuilder)
        patch.setattr(
            dynamics, "Coalescence",
            lambda **kwargs: coalescence(**{**kwargs, "adaptive": False}),
        )
        particulator, spin_up = model.make_simulation(
            _settings(pkg, model, BIGG), backend_class=backend
        )
    spin_up.finish()
    return particulator


def _inject(particulators, rng, n_sd, gamma_scale=1.0):
    """the same u01 streams in both packages: shuffle draws tie-free in
    the packed key (k / 2^20 + 2^-22, exact in float32), gamma draws
    uniform on [0, gamma_scale)"""
    shuffle = (rng.permutation(2**20)[:n_sd] / 2**20 + 2**-22).astype(np.float32)
    gamma = rng.uniform(size=n_sd) * gamma_scale
    for p in particulators:
        p.inject_u01({"collision_shuffle": shuffle, "collision_gamma": gamma})


def _assert_same(jp, tp, step, rtol_attr=1e-9, rtol_env=1e-12):
    for key in ENV_KEYS:
        np.testing.assert_allclose(
            tp.get_env(key), np.asarray(jp.get_env(key)), rtol=rtol_env,
            err_msg=f"{key} at step {step}",
        )
    for name in ("multiplicity", "cell id", "freezing temperature"):
        np.testing.assert_array_equal(
            tp.attributes[name], np.asarray(jp.attributes[name]),
            err_msg=f"{name} at step {step}",
        )
    for name in ("signed water mass", "dry volume", "kappa times dry volume",
                 "position in cell"):
        np.testing.assert_allclose(
            tp.attributes[name], np.asarray(jp.attributes[name]),
            rtol=rtol_attr, err_msg=f"{name} at step {step}",
        )
    np.testing.assert_allclose(
        tp.get_counter("precipitated_mass"),
        np.asarray(jp.get_counter("precipitated_mass")), rtol=rtol_attr,
    )


@pytest.fixture(scope="module", name="run")
def _run():
    """(jax particulator, port particulator, initial freezing temperatures,
    port step count at which the pair was last equal)"""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("PYSDM_TPU_NO_PALLAS_COND", "1")
    jp = _injecting(mp, pysdm_tpu, jax_model, pysdm_tpu.backends.CPU)
    tp = _injecting(mp, pysdm_tpu_torch, port_model, CPU)
    t_fz0 = tp.attributes["freezing temperature"].copy()
    rng = np.random.default_rng(0)
    for step in range(1, STEPS + 1):
        _inject((jp, tp), rng, tp.n_sd,
                MERGING_GAMMA_SCALE if step % 2 else 1.0)
        jp.run(1)
        tp.run(1)
        _assert_same(jp, tp, step)
    yield jp, tp, t_fz0
    mp.undo()


def test_mixed_phase_grid_matches_jax_package_step_by_step(run):
    jp, tp, t_fz0 = run
    assert tp.dynamics["Collision"].route() == "float64"
    assert tp.n_steps == STEPS
    # pairs merged: multiplicities fell, the freezing-temperature row was
    # max-merged (each value is still one of the initial ones, fewer
    # distinct), and nothing froze at ~289 K
    t_fz = tp.attributes["freezing temperature"]
    assert int(np.asarray(tp.get_counter("coalescence_rate")).sum()) > 0
    assert np.isin(t_fz, t_fz0).all()
    assert len(np.unique(t_fz)) < len(np.unique(t_fz0))
    assert (tp.attributes["signed water mass"] > 0).all()
    # the JAX package sums each cell's rate in float32 (the 1D column's
    # test states the same bound)
    want = np.asarray(jp.get_counter("coalescence_rate"))
    np.testing.assert_allclose(
        tp.get_counter("coalescence_rate"), want, rtol=1e-5,
        atol=2**-20 * float(want.sum()),
    )


def test_jax_state_carried_across_steps_on_equal(run):
    jp, _, _ = run
    mp = pytest.MonkeyPatch()
    tp = _injecting(mp, pysdm_tpu_torch, port_model, CPU)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    assert tp.sim_state["particles"].max_names == ("freezing temperature",)
    rng = np.random.default_rng(5)
    for step in range(2):
        _inject((jp, tp), rng, tp.n_sd, MERGING_GAMMA_SCALE)
        jp.run(1)
        tp.run(1)
        # the states start equal: what differs is two steps' summation order
        _assert_same(jp, tp, step, rtol_attr=1e-10, rtol_env=1e-10)


def test_mixed_phase_simulation():
    """the JAX ``test_mixed_phase_simulation`` on the port"""
    particulator, _ = port_model.make_simulation(
        _settings(pysdm_tpu_torch, port_model), backend_class=CPU
    )
    assert "Freezing" in particulator.dynamics
    assert "freezing temperature" in particulator.attributes
    mass0 = float(
        (
            particulator.attributes["multiplicity"]
            * np.abs(particulator.attributes["signed water mass"])
        ).sum()
    )
    particulator.run(3)
    particulator.block_until_ready()
    signed = np.asarray(particulator.attributes["signed water mass"])
    assert np.isfinite(signed).all()
    assert (signed > 0).all()  # no ice at these temperatures
    mass1 = float(
        (particulator.attributes["multiplicity"] * np.abs(signed)).sum()
    )
    assert mass1 != mass0


def test_freezing_temperatures_sampled_as_in_jax_package():
    """the same "freezing temperature" row and initial state from the same
    seed, without injection"""
    tp, _ = port_model.make_simulation(
        _settings(pysdm_tpu_torch, port_model, BIGG), backend_class=CPU
    )
    jp, _ = jax_model.make_simulation(_settings(pysdm_tpu, jax_model, BIGG))
    assert np.isfinite(tp.attributes["freezing temperature"]).all()
    np.testing.assert_allclose(
        tp.attributes["freezing temperature"],
        np.asarray(jp.attributes["freezing temperature"]), rtol=1e-12,
    )
    np.testing.assert_array_equal(
        tp.attributes["multiplicity"], np.asarray(jp.attributes["multiplicity"])
    )


def _velocity_settings(pkg, model):
    return model.StratoCumulus(
        pkg.Formulae(),
        rhod_w_max=1 * si.m / si.s * si.kg / si.m**3,
        grid=(16, 16),
        size=(2 * si.km, 1 * si.km),
        dt=1 * si.s,
    )


def test_velocity_field():
    """the JAX ``test_velocity_field`` on the port, and the field against
    the JAX package's at rtol 1e-12"""
    out = port_model.velocity_field(_velocity_settings(pysdm_tpu_torch, port_model))
    assert 1.4 < np.abs(out["w"]).max() < 2.0
    assert 1.5 < np.abs(out["u"]).max() < 3.0
    assert np.abs(out["w"][:, 0]).max() < 1e-12
    assert np.abs(out["w"][:, -1]).max() < 1e-12
    want = jax_model.velocity_field(_velocity_settings(pysdm_tpu, jax_model))
    for key in ("u", "w", "x_faces", "z_faces"):
        for got, expected in zip(np.atleast_1d(out[key]), np.atleast_1d(want[key])):
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(expected), rtol=1e-12, atol=1e-15,
                err_msg=key,
            )


def test_warm_path_delegates_to_arabas():
    """the JAX ``test_warm_path_delegates_to_arabas`` on the port"""
    settings = port_model.StratoCumulus(
        pysdm_tpu_torch.Formulae(seed=44),
        rhod_w_max=0.6 * si.m / si.s * si.kg / si.m**3,
        grid=(4, 4),
        size=(1.5 * si.km, 1.5 * si.km),
        dt=5 * si.s,
        n_sd_per_gridbox=4,
        spin_up_time=0,
    )
    particulator, _ = port_model.make_simulation(settings, backend_class=CPU)
    assert "Freezing" not in particulator.dynamics
    assert particulator.dynamics["Collision"].route() == "k2"
    particulator.run(2)
    assert np.isfinite(np.asarray(particulator.attributes["water mass"])).all()


@pytest.mark.parametrize("freezing", (False, True))
def test_make_simulation_defaults_to_the_card(monkeypatch, freezing):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = _settings(pysdm_tpu_torch, port_model)
    settings.processes["freezing"] = freezing
    with pytest.raises(RuntimeError, match="CUDA"):
        port_model.make_simulation(settings)
