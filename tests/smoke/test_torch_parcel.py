"""The port's adiabatic parcel (AmbientThermodynamics + Condensation) as a
whole against the JAX package on the CPU, in float64.

On CPU tensors the port's solver runs the JAX package's own plain
formulation (the XLA path, global stopping rule), so the two agree to a few
ulps per step:
- the ``parcel`` block of ``tests/data/parity_traces.json`` replays at the
  bounds of ``tests/unit/test_parity_traces.py:20-33`` (thd, qv and RH to
  rtol 1e-12, radii to 1e-10);
- the same 64-drop run in both packages, adaptive and not, agrees in env to
  rtol 1e-12, water masses to 1e-10 (the per-drop solves stop at rtol_x, so
  an ulp in an input moves a root by an ulp of its bracket), the substep
  count and success exactly, RH_max to 1e-12 and the activation counters to
  1e-12;
- a JAX state carried across after 40 steps runs on alike.
Then the physics checks of ``tests/smoke/test_parcel_condensation.py``
(activation, water budget, lapse rates, subsaturated haze) on the port at a
smaller size: the runs start nearer saturation (qv0 = 0.0225, cloud base
after ~20 s) so that cloud forms within 150 steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
import pysdm_tpu.initialisation
from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation
from pysdm_tpu_torch.environments import Parcel
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.initialisation import equilibrate_wet_radii
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Lognormal

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "parity_traces.json",
)
ENV_KEYS = ("thd", "qv", "rhod", "T", "p", "RH", "z", "air_density",
            "air_viscosity")
EVENT_COUNTERS = ("condensation_activating", "condensation_deactivating",
                  "condensation_ripening")


def _parcel(package, *, n_sd, qv0, adaptive=True, w=2.0, substeps=1):
    """``bench.py``'s parcel (``_bench_parcel``) through either package's
    entry points on its CPU backend"""
    if package == "jax":
        pkg, backend = pysdm_tpu, pysdm_tpu.backends.CPU
        dyn, envs = pysdm_tpu.dynamics, pysdm_tpu.environments
        sampling, spectra = jax_sampling, jax_spectra
    else:
        pkg, backend = pysdm_tpu_torch, CPU
        dyn = envs = sampling = spectra = None
    formulae = pkg.Formulae(seed=44)
    env = (envs.Parcel if envs else Parcel)(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=qv0, T0=300.0, w=w,
    )
    builder = pkg.Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic((dyn.AmbientThermodynamics if dyn else AmbientThermodynamics)())
    builder.add_dynamic((dyn.Condensation if dyn else Condensation)(
        adaptive=adaptive, substeps=substeps
    ))
    spectrum = (spectra.Lognormal if spectra else Lognormal)(
        norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5
    )
    r_dry, n_in_dv = (
        sampling.ConstantMultiplicity if sampling else ConstantMultiplicity
    )(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes)


def _assert_same(jp, tp):
    for key in ENV_KEYS:
        np.testing.assert_allclose(
            tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-12, err_msg=key
        )
    np.testing.assert_allclose(
        tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
        rtol=1e-10,
    )
    for name in ("condensation_n_substeps", "condensation_success"):
        np.testing.assert_array_equal(tp.get_counter(name), jp.get_counter(name))
    for name in ("condensation_RH_max", *EVENT_COUNTERS):
        np.testing.assert_allclose(
            tp.get_counter(name), jp.get_counter(name), rtol=1e-12, err_msg=name
        )


def test_parcel_trace_replay():
    """the committed ``parcel`` trace (32 drops, 20 steps of 10 substeps)
    replays on the port's CPU float64 backend, initialised from the trace's
    equilibrated volumes as ``tools/reference_replay.py`` is"""
    with open(DATA) as f:
        block = json.load(f)["parcel"]
    case = block["case"]
    formulae = pysdm_tpu_torch.Formulae(**case["formulae"])
    env = Parcel(**case["env"])
    builder = pysdm_tpu_torch.Builder(
        n_sd=case["n_sd"], backend=CPU(formulae), environment=env
    )
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(**case["condensation"]))
    v_dry = formulae.trivia.volume(radius=np.asarray(case["r_dry"]))
    particulator = builder.build({
        "multiplicity": np.asarray(case["multiplicity"]),
        "dry volume": v_dry,
        "kappa times dry volume": case["kappa"] * v_dry,
        "volume": np.asarray(case["volume"]),
    })
    for expected in block["expected"]:
        particulator.run(1)
        for key in ("thd", "qv", "RH"):
            np.testing.assert_allclose(
                particulator.get_env(key)[0], expected[key], rtol=1e-12
            )
        np.testing.assert_allclose(
            particulator.attributes["radius"] * 1e6, expected["radii_um"],
            rtol=1e-10,
        )


@pytest.mark.parametrize("adaptive", (False, True))
def test_parcel_matches_jax_package(adaptive):
    jp = _parcel("jax", n_sd=64, qv0=0.0225, adaptive=adaptive)
    tp = _parcel("torch", n_sd=64, qv0=0.0225, adaptive=adaptive)
    jp.run(100)
    tp.run(100)
    _assert_same(jp, tp)
    assert tp.get_counter("condensation_RH_max")[0] > 1
    assert tp.get_counter("condensation_activating")[0] > 0
    assert float(tp.get_env("t")) == 100.0


def test_state_carried_from_jax_package():
    jp = _parcel("jax", n_sd=32, qv0=0.0225)
    jp.run(40)
    tp = _parcel("torch", n_sd=32, qv0=0.0225)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    assert tp.sim_state["host"]["t"] == 40.0
    assert tp.sim_state["counters"]["condensation_n_substeps"].dtype == torch.int32
    _assert_same(jp, tp)
    jp.run(40)
    tp.run(40)
    _assert_same(jp, tp)


def _liquid_mixing_ratio(p):
    return float(
        (p.attributes["multiplicity"] * p.attributes["water mass"]).sum()
    ) / 1e3


def test_activation_and_water_budget():
    p = _parcel("torch", n_sd=32, qv0=0.0225)
    lwmr0 = _liquid_mixing_ratio(p)
    p.run(150)
    assert p.get_counter("condensation_success").all()
    RH_max = float(p.get_counter("condensation_RH_max")[0])
    assert 1.0005 < RH_max < 1.05
    lwmr = _liquid_mixing_ratio(p)
    # total water conserved: qv + liquid invariant (incl. initial haze)
    np.testing.assert_allclose(
        float(p.get_env("qv")[0]) + lwmr, 0.0225 + lwmr0, rtol=1e-9
    )
    assert lwmr > 1e-4
    assert 5e-6 < float(np.mean(p.attributes["radius"])) < 50e-6


def test_dry_then_moist_lapse_rate():
    """below the LCL the parcel cools at the dry-adiabatic rate g/cp; in
    cloud the rate is visibly smaller"""
    dry = _parcel("torch", n_sd=8, qv0=0.0158)
    dry.run(100)  # 200 m of ascent, still subsaturated
    dT_dz_dry = (300.0 - float(dry.get_env("T")[0])) / float(dry.get_env("z")[0])
    np.testing.assert_allclose(dT_dz_dry, 9.8e-3, rtol=2e-2)
    moist = _parcel("torch", n_sd=8, qv0=0.0225)
    moist.run(50)
    T0, z0 = float(moist.get_env("T")[0]), float(moist.get_env("z")[0])
    moist.run(100)
    T1, z1 = float(moist.get_env("T")[0]), float(moist.get_env("z")[0])
    assert (T0 - T1) / (z1 - z0) < 0.6 * 9.8e-3


def test_subsaturated_haze_equilibrium():
    """with a weak updraft, droplets stay near Koehler equilibrium and qv is
    unchanged"""
    p = _parcel("torch", n_sd=8, qv0=0.0158, w=0.01)
    p.run(50)
    assert float(p.get_counter("condensation_RH_max")[0]) < 1.0
    np.testing.assert_allclose(float(p.get_env("qv")[0]), 0.0158, rtol=1e-7)


def test_equilibrate_wet_radii_matches_jax_package():
    r_dry = np.logspace(np.log10(10e-9), np.log10(500e-9), 16)
    kappa_times_dry_volume = 0.5 * 4 / 3 * np.pi * r_dry**3
    radii = []
    for package in ("jax", "torch"):
        p = _parcel(package, n_sd=4, qv0=0.0158)
        radii.append(np.asarray((
            pysdm_tpu.initialisation.equilibrate_wet_radii
            if package == "jax" else equilibrate_wet_radii
        )(
            r_dry=r_dry, environment=p.environment,
            kappa_times_dry_volume=kappa_times_dry_volume,
        )))
    np.testing.assert_allclose(radii[1], radii[0], rtol=1e-12)
    assert (radii[1] > r_dry).all()


def test_counter_without_dtype_takes_the_backends():
    p = _parcel("torch", n_sd=4, qv0=0.0158)
    assert p.sim_state["counters"]["condensation_RH_max"].dtype == torch.float64
    builder = pysdm_tpu_torch.Builder(
        n_sd=4, backend=CPU(pysdm_tpu_torch.Formulae(seed=1)),
        environment=Parcel(dt=1.0, mass_of_dry_air=1.0, p0=1e5,
                           initial_water_vapour_mixing_ratio=0.01, T0=290.0,
                           w=1.0),
    )
    builder.add_counter("untyped", 1)
    assert builder._counters["untyped"].dtype == torch.float64


def test_multi_cell_and_other_ventilation_are_refused():
    """neither is refused any more: the other ventilation variants came
    with the rest of physics/ and bind, and multi-cell condensation
    registers per-cell counters"""
    assert pysdm_tpu_torch.Formulae(
        ventilation="Froessling1938"
    ).ventilation.variant == "Froessling1938"
    builder = pysdm_tpu_torch.Builder(
        n_sd=4, backend=CPU(pysdm_tpu_torch.Formulae(seed=1)),
        environment=Parcel(dt=1.0, mass_of_dry_air=1.0, p0=1e5,
                           initial_water_vapour_mixing_ratio=0.01, T0=290.0,
                           w=1.0),
    )
    builder.particulator.mesh.n_cell = 2
    builder.add_dynamic(Condensation())
    builder.particulator.dynamics["Condensation"].register(builder)
    assert builder._counters["condensation_n_substeps"].shape == (2,)
