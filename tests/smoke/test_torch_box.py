"""The port's 0D box coalescence slice as a whole against the JAX package on
the CPU.

The JAX side runs the bench's box (``bench.py`` ``_build_box``) on the
``CPU`` backend with ``PYSDM_TPU_PALLAS_INTERPRET=1``; at n_sd = 2^15 its
dispatch takes ``fused_coalesce_mirror_blocks``. The port draws its
per-substep (K, seed) through ``Collision._draw_mirror``, which the test
replaces by a replay of the JAX key chain
(``pysdm_tpu/dynamics/collisions/collision.py:152,162,283``). Multiplicities
and the substep counter must then agree exactly, water masses to rtol 1e-12.
The collision and coalescence counters add float32 sums of each substep's
pair rates, which the two packages sum in another order: past 2^24 a sum
rounds differently, so those counters agree to rtol 1e-5, the kernel
test's bound for the rate sums.

``test_box_trace_replay`` replays the ``box`` block of
``tests/data/parity_traces.json`` (16 drops, ConstantK, 8 steps under u01
injection, which takes the sort croupier) on the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.initialisation import spectra as jax_spectra

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import (
    ConstantK,
    Golovin,
)
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.impl.state import ParticleState
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Exponential
from pysdm_tpu_torch.physics import si

N_SD = 2**15
DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "parity_traces.json",
)
RATE_COUNTERS = ("collision_rate", "coalescence_rate")


def _jax_box(n_sd, dt, adaptive, seed=44):
    formulae = pysdm_tpu.Formulae(seed=seed)
    builder = pysdm_tpu.Builder(
        n_sd=n_sd, backend=pysdm_tpu.backends.CPU(formulae),
        environment=pysdm_tpu.environments.Box(dv=1e6 * si.m**3, dt=dt),
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        pysdm_tpu.dynamics.Coalescence(
            collision_kernel=jax_kernels.Golovin(b=1.5e3), adaptive=adaptive
        )
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = (
        jax_sampling.ConstantMultiplicity(
            jax_spectra.Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
        ).sample(n_sd)
    )
    return builder.build(attributes)


def _port_box(n_sd, dt, adaptive, seed=44):
    formulae = pysdm_tpu_torch.Formulae(seed=seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(formulae),
        environment=Box(dv=1e6 * si.m**3, dt=dt),
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=adaptive)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
    ).sample(n_sd)
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


def _assert_same(jp, tp):
    np.testing.assert_array_equal(
        tp.attributes["multiplicity"], np.asarray(jp.attributes["multiplicity"])
    )
    np.testing.assert_allclose(
        tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
        rtol=1e-12,
    )
    np.testing.assert_array_equal(
        tp.get_counter("collision_n_substep"),
        jp.get_counter("collision_n_substep"),
    )
    for name in RATE_COUNTERS:
        np.testing.assert_allclose(
            tp.get_counter(name), jp.get_counter(name), rtol=1e-5
        )


@pytest.mark.parametrize("adaptive, dt, n_steps", ((False, 1.0, 3), (True, 10.0, 2)))
def test_box_matches_jax_package(adaptive, dt, n_steps, monkeypatch):
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp = _jax_box(N_SD, dt, adaptive)
    tp = _port_box(N_SD, dt, adaptive)
    _replay_jax_draws(tp, jp.sim_state["key"])
    mult0 = tp.attributes["multiplicity"]
    jp.run(n_steps)
    tp.run(n_steps)
    _assert_same(jp, tp)
    assert (tp.attributes["multiplicity"] != mult0).any()
    assert tp.get_counter("coalescence_rate")[0] > 0
    if adaptive:
        assert tp.get_counter("collision_n_substep")[0] >= n_steps


def test_state_carried_from_jax_package(monkeypatch):
    """one JAX step, the state carried across with ``from_numpy``, then two
    more steps on each side"""
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp = _jax_box(N_SD, 1.0, adaptive=False)
    jp.run(1)
    tp = _port_box(N_SD, 1.0, adaptive=False)
    jax_state = jp.sim_state["particles"]
    tp.sim_state["particles"] = ParticleState.from_numpy(
        multiplicity=np.asarray(jax_state.multiplicity),
        extensive=np.asarray(jax_state.extensive),
        ext_names=jax_state.ext_names,
        cell_id=np.asarray(jax_state.cell_id),
    )
    for name, value in jp.sim_state["counters"].items():
        tp.sim_state["counters"][name] = torch.from_numpy(np.array(value))
    _replay_jax_draws(tp, jp.sim_state["key"])
    jp.run(2)
    tp.run(2)
    _assert_same(jp, tp)
    back = tp.particles.to_numpy()
    assert back["ext_names"] == jax_state.ext_names
    np.testing.assert_array_equal(back["multiplicity"], tp.attributes["multiplicity"])


@pytest.mark.parametrize("adaptive", (False, True))
def test_port_box_conserves_liquid_water(adaptive):
    tp = _port_box(2**11, 10.0, adaptive)
    mult0 = tp.attributes["multiplicity"]
    lwc0 = (mult0 * tp.attributes["water mass"]).sum()
    tp.run(30)
    mult = tp.attributes["multiplicity"]
    lwc1 = (mult * tp.attributes["water mass"]).sum()
    np.testing.assert_allclose(lwc1, lwc0, rtol=1e-10)
    assert mult.sum() < mult0.sum()


RADIUS_BINS = np.logspace(np.log10(10 * si.um), np.log10(5e3 * si.um), num=64)


def _dm_dlnr(particulator, dv):
    """mass density per unit ln(radius), from the attributes"""
    mult = particulator.attributes["multiplicity"]
    mass = particulator.attributes["water mass"]
    radius = particulator.attributes["radius"]
    hist, _ = np.histogram(radius, bins=RADIUS_BINS, weights=mult * mass)
    return hist / dv / np.diff(np.log(RADIUS_BINS))


def test_port_adaptive_beats_nonadaptive_at_large_dt():
    """with dt = 50 s the non-adaptive run is further from the Golovin
    analytic solution than the adaptive one
    (``tests/smoke/test_box_coalescence.py:142-161``)"""
    t_max, dt, n_sd, dv = 1800.0, 50.0, 2**12, 1e6
    n_part = 2**23
    errs = {}
    for adaptive in (False, True):
        tp = _port_box(n_sd, dt, adaptive)
        tp.run(int(t_max / dt))
        x_0 = float(tp.formulae.trivia.volume(radius=30.531 * si.um))
        r_mid = np.sqrt(RADIUS_BINS[:-1] * RADIUS_BINS[1:])
        x = tp.formulae.trivia.volume(radius=r_mid)
        analytic = (
            n_part * Golovin(b=1.5e3).analytic_solution(x, t_max, x_0, n_part)
            * 3 * x**2 * tp.formulae.constants.rho_w
        )
        measured = _dm_dlnr(tp, dv)
        scale = analytic.max()
        errs[adaptive] = float(
            np.sqrt(np.mean(((measured - analytic) / scale) ** 2))
        )
    assert errs[True] < errs[False]


def test_box_trace_replay():
    """the committed ``box`` trace on the port's CPU float64 backend, as
    ``tools/make_parity_traces.py`` ``run_box_ours`` drives the JAX
    package: the shuffle row and the pairwise-repeated gamma draws of each
    step injected, ConstantK, non-adaptive. The trace's own bounds
    (``tests/unit/test_parity_traces.py``): multiplicities equal, volumes
    to rtol 1e-12, at every step."""
    with open(DATA) as f:
        block = json.load(f)["box"]
    case = block["case"]
    builder = pysdm_tpu_torch.Builder(
        n_sd=case["n_sd"], backend=CPU(pysdm_tpu_torch.Formulae(**case["formulae"])),
        environment=Box(dt=case["env"]["dt"], dv=case["env"]["dv"]),
    )
    builder.enable_u01_injection()
    builder.add_dynamic(Coalescence(
        collision_kernel=ConstantK(a=case["kernel"]["a"]), adaptive=False
    ))
    particulator = builder.build({
        "multiplicity": np.asarray(case["multiplicity"]),
        "volume": np.asarray(case["volume"]),
    })
    assert len(block["expected"]) == case["n_steps"] == 8
    for step, expected in enumerate(block["expected"]):
        particulator.inject_u01({
            "collision_shuffle": np.asarray(case["shuffle_u01"]),
            "collision_gamma": np.repeat(np.asarray(case["gamma_rand"][step]), 2),
        })
        particulator.run(1)
        np.testing.assert_array_equal(
            particulator.attributes["multiplicity"], expected["multiplicity"]
        )
        np.testing.assert_allclose(
            particulator.attributes["volume"], expected["volume"], rtol=1e-12
        )
