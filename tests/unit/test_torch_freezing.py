"""Freezing, thaw and vapour deposition on ice in the port against the JAX
package, on the CPU in float64, on the same numpy inputs made from seeds:

- the three freezing functions of ``ops/freezing.py`` on the same u01 rows:
  the frozen masks (and the signed masses) equal;
- the tests of ``tests/unit/test_freezing.py`` and
  ``tests/unit/test_deposition.py`` and
  ``tests/unit/test_golden_traces.py::TestTimeDependentFreezingGolden``
  replayed on the port at their bounds;
- a parcel with condensation, deposition and homogeneous freezing, 40
  steps under u01 injection: signed masses, T and qv equal step by step at
  rtol 1e-10, the frozen masks equal;
- every freezing product on a mixed-phase box state, rtol 1e-12;
- a JAX mixed-phase state carried across by ``sim_state_from_numpy``, its
  maximum rows included, then run on in both packages;
- K3's twin on rows with ice drops: the ice bit-equal and solved, the
  liquid drops bit-equal to the same drops without the ice, and against
  the TPU kernel in interpret mode;
- the refusal of collisions on a state with maximum rows, and the ice
  models' entry points defaulting to the card.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
import pysdm_tpu.products
from pysdm_tpu.ops import freezing as jax_frz
from pysdm_tpu.ops.pallas.condensation import make_fused_masses_new

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
import pysdm_tpu_torch  # noqa: E402
import pysdm_tpu_torch.dynamics  # noqa: E402
import pysdm_tpu_torch.environments  # noqa: E402
import pysdm_tpu_torch.products  # noqa: E402
from pysdm_tpu_torch.backends import CPU  # noqa: E402
from pysdm_tpu_torch.impl.mesh import Mesh  # noqa: E402
from pysdm_tpu_torch.impl.state import sim_state_from_numpy  # noqa: E402
from pysdm_tpu_torch.initialisation import spectra  # noqa: E402
from pysdm_tpu_torch.initialisation.sampling.spectro_glacial_sampling import (  # noqa: E402
    SpectroGlacialSampling,
)
from pysdm_tpu_torch.ops import freezing as frz  # noqa: E402
from pysdm_tpu_torch.ops.condensation import DropSolveSettings  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402
from pysdm_tpu_torch.physics import si  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs (the tests run in several
    processes at once)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- ops/freezing.py ---------------------------------------------------------
N = 512
_rng = np.random.default_rng(77)
MASS = np.exp(_rng.uniform(np.log(1e-15), np.log(1e-9), N)) * np.where(
    _rng.uniform(size=N) < 0.3, -1.0, 1.0
)
T_DROP = _rng.uniform(225.0, 280.0, N)
RH_DROP = _rng.uniform(0.9, 1.1, N)
U01 = _rng.uniform(size=N)


def _both(fn_name, formulae_kwargs, **kwargs):
    out = {}
    for name, module, package, to in (
        ("jax", jax_frz, pysdm_tpu, jnp.asarray),
        ("torch", frz, pysdm_tpu_torch, torch.from_numpy),
    ):
        formulae = package.Formulae(seed=1, **formulae_kwargs)
        args = {
            k: to(v) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()
        }
        out[name] = np.asarray(getattr(module, fn_name)(formulae=formulae, **args))
    return out["jax"], out["torch"]


def _assert_same_freezing(expected, got):
    np.testing.assert_array_equal(got < 0, expected < 0)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("thaw", (False, True))
def test_freeze_singular_matches_jax_package(thaw):
    t_fz = np.where(_rng.uniform(size=N) < 0.2, 0.0, _rng.uniform(230, 270, N))
    expected, got = _both(
        "freeze_singular", dict(particle_shape_and_density="MixedPhaseSpheres"),
        signed_mass=MASS, freezing_temperature=t_fz, T_drop=T_DROP,
        RH_drop=RH_DROP, thaw=thaw,
    )
    assert 0 < (got < 0).sum() < N
    _assert_same_freezing(expected, got)


@pytest.mark.parametrize("thaw", (False, True))
@pytest.mark.parametrize("variant, constants", (
    ("Constant", {"J_HET": 1e9}),
    ("ABIFM", {"ABIFM_M": 54.48, "ABIFM_C": -10.67}),
))
def test_freeze_time_dependent_matches_jax_package(variant, constants, thaw):
    area = np.where(_rng.uniform(size=N) < 0.2, 0.0,
                    np.exp(_rng.uniform(np.log(1e-12), np.log(1e-9), N)))
    expected, got = _both(
        "freeze_time_dependent",
        dict(particle_shape_and_density="MixedPhaseSpheres",
             heterogeneous_ice_nucleation_rate=variant, constants=constants),
        rand=U01, signed_mass=MASS, immersed_surface_area=area,
        T_drop=T_DROP, RH_drop=RH_DROP,
        a_w_ice_drop=_rng.uniform(0.7, 1.0, N), dt=1.0, thaw=thaw,
    )
    assert (got < 0).sum() > (MASS < 0).sum() * (not thaw)
    _assert_same_freezing(expected, got)


@pytest.mark.parametrize("thaw", (False, True))
@pytest.mark.parametrize("variant, constants", (
    ("Koop2000", None), ("Koop_Correction", None), ("KoopMurray2016", None),
    ("Constant", {"J_HOM": 1e16}),
))
def test_freeze_homogeneous_matches_jax_package(variant, constants, thaw):
    a_w_ice = _rng.uniform(0.6, 0.8, N)
    expected, got = _both(
        "freeze_time_dependent_homogeneous",
        dict(particle_shape_and_density="MixedPhaseSpheres",
             homogeneous_ice_nucleation_rate=variant, constants=constants),
        rand=U01, signed_mass=MASS, volume=np.abs(MASS) / 1e3, T_drop=T_DROP,
        RH_ice_drop=_rng.uniform(1.3, 1.6, N), a_w_ice_drop=a_w_ice, dt=1.0,
        thaw=thaw,
    )
    _assert_same_freezing(expected, got)


def test_a_w_ice_and_rh_ice_match_jax_package():
    jax_f = pysdm_tpu.Formulae(seed=1)
    port_f = pysdm_tpu_torch.Formulae(seed=1)
    for want, got in zip(
        jax_frz.a_w_ice_and_rh_ice(jax_f, jnp.asarray(T_DROP), jnp.asarray(RH_DROP)),
        frz.a_w_ice_and_rh_ice(port_f, torch.from_numpy(T_DROP),
                               torch.from_numpy(RH_DROP)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


# --- tests/unit/test_freezing.py on the port ---------------------------------
def make_box(formulae, n_sd, attributes, dt=1.0, T=250.0, RH=1.05):
    env = pysdm_tpu_torch.environments.Box(dt=dt, dv=1 * si.m**3)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(formulae), environment=env
    )
    env["T"] = np.asarray([T])
    env["RH"] = np.asarray([RH])
    builder.add_dynamic(
        pysdm_tpu_torch.dynamics.Freezing(**attributes.pop("__freezing_kwargs__"))
    )
    return builder, env, builder.build(attributes)


def test_singular_freezing_follows_spectrum():
    n_sd = 4096
    formulae = pysdm_tpu_torch.Formulae(
        seed=303,
        particle_shape_and_density="MixedPhaseSpheres",
        freezing_temperature_spectrum="Niemand_et_al_2012",
        constants={"NIEMAND_A": -0.517, "NIEMAND_B": 8.934},
    )
    sampling = SpectroGlacialSampling(
        freezing_temperature_spectrum=formulae.freezing_temperature_spectrum,
        insoluble_surface_spectrum=spectra.Lognormal(
            norm_factor=1.0, m_mode=1e-9, s_geom=2.0
        ),
        seed=303,
    )
    T_fz, A_insol, _ = sampling.sample(n_sd=n_sd)
    assert (T_fz < 273.15).all() and (T_fz > 200).all()

    attributes = {
        "multiplicity": np.ones(n_sd),
        "water mass": np.full(n_sd, 1e-12),
        "freezing temperature": T_fz,
        "__freezing_kwargs__": dict(singular=True),
    }
    _, _, particulator = make_box(formulae, n_sd, attributes, T=250.0)
    particulator.run(1)
    frozen = particulator.attributes["signed water mass"] < 0
    np.testing.assert_array_equal(frozen, T_fz >= 250.0)

    attributes2 = {
        "multiplicity": np.ones(n_sd),
        "water mass": np.full(n_sd, 1e-12),
        "freezing temperature": T_fz,
        "__freezing_kwargs__": dict(singular=True),
    }
    _, _, p2 = make_box(formulae, n_sd, attributes2, T=250.0, RH=0.9)
    p2.run(1)
    assert (p2.attributes["signed water mass"] > 0).all()


@pytest.mark.parametrize("mode", ("het", "hom"))
def test_time_dependent_freezing_poisson_statistics(mode):
    """constant J: the frozen fraction after t is 1 - exp(-J X t) within 4
    binomial sigma, the u01 rows drawn from the port's device generator"""
    n_sd = 8192
    dt, n_steps = 0.5, 20
    if mode == "het":
        area, j = 1e-10, 1e8
        formulae = pysdm_tpu_torch.Formulae(
            seed=404, particle_shape_and_density="MixedPhaseSpheres",
            heterogeneous_ice_nucleation_rate="Constant",
            constants={"J_HET": j},
        )
        rate = j * area
        kwargs = dict(singular=False)
        extra = {"immersed surface area": np.full(n_sd, area)}
    else:
        volume, j = 1e-15, 1e13
        formulae = pysdm_tpu_torch.Formulae(
            seed=404, particle_shape_and_density="MixedPhaseSpheres",
            homogeneous_ice_nucleation_rate="Constant",
            constants={"J_HOM": j},
        )
        rate = j * volume
        kwargs = dict(
            singular=False, immersion_freezing=False, homogeneous_freezing=True
        )
        extra = {}
    attributes = {
        "multiplicity": np.ones(n_sd),
        "water mass": np.full(n_sd, 1e-15 * 1e3),
        **extra,
        "__freezing_kwargs__": kwargs,
    }
    _, _, particulator = make_box(
        formulae, n_sd, attributes, dt=dt, T=230.0, RH=1.5
    )
    particulator.run(n_steps)
    frozen_fraction = float((particulator.attributes["signed water mass"] < 0).mean())
    expected = 1.0 - np.exp(-rate * dt * n_steps)
    assert abs(frozen_fraction - expected) < 4 * np.sqrt(
        expected * (1 - expected) / n_sd
    ), f"{frozen_fraction} vs {expected}"


def test_thaw_above_freezing_point():
    n_sd = 16
    formulae = pysdm_tpu_torch.Formulae(
        seed=1, particle_shape_and_density="MixedPhaseSpheres"
    )
    attributes = {
        "multiplicity": np.ones(n_sd),
        "signed water mass": np.full(n_sd, -1e-12),
        "freezing temperature": np.full(n_sd, 250.0),
        "__freezing_kwargs__": dict(singular=True, thaw=True),
    }
    _, _, particulator = make_box(formulae, n_sd, attributes, T=280.0, RH=0.5)
    particulator.run(1)
    assert (particulator.attributes["signed water mass"] > 0).all()


def test_time_dependent_freezing_golden_trace():
    """``TestTimeDependentFreezingGolden``: 3 cells, J_het A dt = 1, so a
    drop freezes where its u01 is below 1 - exp(-1) = 0.632, its cell
    water-supersaturated and its insoluble area nonzero"""
    n_sd = 6
    formulae = pysdm_tpu_torch.Formulae(
        seed=7, particle_shape_and_density="MixedPhaseSpheres",
        heterogeneous_ice_nucleation_rate="Constant", constants={"J_HET": 1e5},
    )
    env = pysdm_tpu_torch.environments.Box(dt=1 * si.s, dv=1 * si.m**3)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(formulae), environment=env
    )
    builder.particulator.mesh = Mesh((3,), (3.0,))
    builder.enable_u01_injection()
    builder.add_dynamic(
        pysdm_tpu_torch.dynamics.Freezing(singular=False, immersion_freezing=True)
    )
    env["T"] = np.full(3, 250.0)
    env["RH"] = np.asarray([1.05, 0.90, 1.05])
    p = builder.build({
        "multiplicity": np.ones(n_sd, dtype=np.int64),
        "water mass": np.full(n_sd, 1e-12),
        "immersed surface area": np.asarray([1e-5, 1e-5, 1e-5, 1e-5, 0.0, 1e-5]),
        "cell id": np.repeat(np.arange(3, dtype=np.int64), 2),
    })
    p.inject_u01({"freezing_immersion": np.asarray(
        [0.50, 0.70, 0.10, 0.10, 0.10, 0.64]
    )})
    p.run(1)
    frozen = p.attributes["signed water mass"] < 0
    np.testing.assert_array_equal(
        frozen, [True, False, False, False, False, False]
    )
    np.testing.assert_allclose(np.abs(p.attributes["signed water mass"]), 1e-12)


# --- tests/unit/test_deposition.py on the port ------------------------------
def _deposition_parcel(package, formulae_kwargs, *, T0, p0, RH_w, dt, mass,
                       n_sd=64, backend=None):
    formulae = package.Formulae(
        seed=5, particle_shape_and_density="MixedPhaseSpheres",
        **formulae_kwargs,
    )
    svp = formulae.saturation_vapour_pressure
    pvs_w = float(svp.pvs_water(T0))
    qv0 = formulae.constants.eps * RH_w * pvs_w / (p0 - RH_w * pvs_w)
    env = package.environments.Parcel(
        dt=dt, mass_of_dry_air=1e3 * si.kg, p0=p0,
        initial_water_vapour_mixing_ratio=float(qv0), T0=T0, w=0.0,
    )
    backend = backend or package.backends.CPU
    builder = package.Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic(package.dynamics.AmbientThermodynamics())
    builder.add_dynamic(package.dynamics.VapourDepositionOnIce())
    particulator = builder.build({
        "multiplicity": np.full(n_sd, 1e6),
        "signed water mass": np.full(n_sd, mass),
    })
    return formulae, env, particulator


def test_deposition_grows_ice_and_depletes_vapour():
    T0, ice_mass0 = 255.0 * si.K, 1e-10
    formulae, env, particulator = _deposition_parcel(
        pysdm_tpu_torch, {}, T0=T0, p0=600 * si.hPa, RH_w=0.9, dt=1 * si.s,
        mass=-ice_mass0,
    )
    svp = formulae.saturation_vapour_pressure
    pvs_w, pvs_i = float(svp.pvs_water(T0)), float(svp.pvs_ice(T0))
    S_ice0 = float(env["RH"][0]) * pvs_w / pvs_i
    assert S_ice0 > 1.05
    qv_start = float(env["qv"][0])

    particulator.run(100)
    signed = particulator.attributes["signed water mass"]
    assert (signed < 0).all()
    assert (-signed > ice_mass0).all()
    assert float(env["qv"][0]) < qv_start
    ice_gain = float(np.sum((-signed - ice_mass0) * 1e6))
    vapour_loss = (qv_start - float(env["qv"][0])) * 1e3
    np.testing.assert_allclose(ice_gain, vapour_loss, rtol=2e-2)
    T1 = float(env["T"][0])
    S_ice1 = float(env["RH"][0]) * float(svp.pvs_water(T1)) / float(svp.pvs_ice(T1))
    assert 1.0 <= S_ice1 < S_ice0


def test_tiny_fresh_crystal_log_coordinate_stays_finite():
    """a femtogram crystal at dt = 100 s in the log coordinate: the
    explicit-Euler mass overflows exp() to inf, and the per-drop vapour
    cap keeps the increment finite"""
    _, env, particulator = _deposition_parcel(
        pysdm_tpu_torch, dict(diffusion_coordinate="WaterMassLogarithm"),
        T0=240.0 * si.K, p0=500 * si.hPa, RH_w=1.0, dt=100.0 * si.s,
        mass=-1e-18, n_sd=8,
    )
    qv_start = float(env["qv"][0])
    particulator.run(3)
    assert np.isfinite(particulator.attributes["signed water mass"]).all()
    qv1 = float(env["qv"][0])
    assert np.isfinite(qv1) and 0.0 <= qv1 <= qv_start
    assert np.isfinite(float(env["T"][0]))


def test_deposition_matches_jax_package_step_by_step():
    """the deposition parcel of the test above, in both packages, 20 steps:
    signed masses and the env equal at rtol 1e-10"""
    kwargs = dict(T0=255.0 * si.K, p0=600 * si.hPa, RH_w=0.9, dt=1 * si.s,
                  mass=-1e-10)
    _, _, jp = _deposition_parcel(pysdm_tpu, {}, **kwargs)
    _, _, tp = _deposition_parcel(pysdm_tpu_torch, {}, **kwargs)
    for _ in range(20):
        jp.run(1)
        tp.run(1)
        np.testing.assert_allclose(
            tp.attributes["signed water mass"],
            np.asarray(jp.attributes["signed water mass"]), rtol=1e-10,
        )
        for key in ("qv", "thd", "T", "RH"):
            np.testing.assert_allclose(
                tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-10
            )


# --- a mixed-phase parcel under u01 injection --------------------------------
def _mixed_phase_parcel(package, n_sd=48):
    """a cold, ice-supersaturated parcel rising at 2 m/s with solution drops
    and a few crystals: AmbientThermodynamics, Condensation, deposition and
    homogeneous freezing (Koop_Correction), u01 injected"""
    formulae = package.Formulae(
        seed=44, particle_shape_and_density="MixedPhaseSpheres",
        homogeneous_ice_nucleation_rate="Koop_Correction",
    )
    T0, p0 = 222.0, 250 * si.hPa
    pvs_i = float(formulae.saturation_vapour_pressure.pvs_ice(T0))
    qv0 = formulae.constants.eps * 1.5 * pvs_i / (p0 - 1.5 * pvs_i)
    env = package.environments.Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=p0,
        initial_water_vapour_mixing_ratio=qv0, T0=T0, w=2.0, mixed_phase=True,
    )
    builder = package.Builder(
        n_sd=n_sd, backend=package.backends.CPU(formulae), environment=env
    )
    builder.enable_u01_injection()
    builder.add_dynamic(package.dynamics.AmbientThermodynamics())
    builder.add_dynamic(package.dynamics.Condensation())
    builder.add_dynamic(package.dynamics.VapourDepositionOnIce())
    builder.add_dynamic(package.dynamics.Freezing(
        singular=False, homogeneous_freezing=True, immersion_freezing=False,
    ))
    rng = np.random.default_rng(11)
    r_dry = np.exp(rng.uniform(np.log(2e-8), np.log(2e-7), n_sd))
    attributes = env.init_attributes(
        n_in_dv=np.full(n_sd, 2e5), kappa=0.64, r_dry=r_dry
    )
    mass = attributes.pop("volume") * 1e3
    mass[::8] = -np.exp(rng.uniform(np.log(1e-15), np.log(1e-12), n_sd))[::8]
    attributes["signed water mass"] = mass
    return builder.build(attributes)


def test_mixed_phase_parcel_matches_jax_package_under_u01_injection():
    jp, tp = _mixed_phase_parcel(pysdm_tpu), _mixed_phase_parcel(pysdm_tpu_torch)
    rng = np.random.default_rng(5)
    grew = False
    for _ in range(40):
        u01 = {"freezing_homogeneous": rng.uniform(size=jp.n_sd)}
        jp.inject_u01(u01)
        tp.inject_u01(u01)
        jp.run(1)
        tp.run(1)
        want = np.asarray(jp.attributes["signed water mass"])
        got = tp.attributes["signed water mass"]
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_allclose(got, want, rtol=1e-10)
        for key in ("qv", "T", "thd", "RH"):
            np.testing.assert_allclose(
                tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-10
            )
        grew = grew or (got < 0).sum() > jp.n_sd // 8
    assert grew, "no drop froze: the parcel tests nothing of J_hom"
    assert tp.dynamics["Condensation"].solver.host_reads > 0


# --- the freezing products ---------------------------------------------------
PRODUCT_NAMES = (
    "IceWaterContent", "SpecificIceWaterContent", "FrozenParticleConcentration",
    "FrozenFraction", "FrozenParticleSpecificConcentration",
    "IceNucleiConcentration", "SpecificIceNucleiConcentration",
    "TotalUnfrozenImmersedSurfaceArea", "CoolingRate",
)


def _product_box(package, singular):
    n_sd = 256
    formulae = package.Formulae(
        seed=3, particle_shape_and_density="MixedPhaseSpheres",
        heterogeneous_ice_nucleation_rate="Constant", constants={"J_HET": 1e9},
    )
    env = package.environments.Box(dt=2.0, dv=1e-3)
    builder = package.Builder(
        n_sd=n_sd, backend=package.backends.CPU(formulae), environment=env
    )
    env["T"] = np.asarray([250.0])
    env["RH"] = np.asarray([1.02])
    env["rhod"] = np.asarray([1.1])
    if not singular:
        builder.enable_u01_injection()
    builder.add_dynamic(package.dynamics.Freezing(singular=singular))
    rng = np.random.default_rng(8)
    mass = np.exp(rng.uniform(np.log(1e-14), np.log(1e-10), n_sd))
    mass[::3] *= -1
    attributes = {
        "multiplicity": rng.integers(1, 10**6, n_sd),
        "signed water mass": mass,
        "immersed surface area": np.where(
            rng.uniform(size=n_sd) < 0.5, 0.0, rng.uniform(1e-12, 1e-10, n_sd)
        ),
    }
    if singular:
        attributes["freezing temperature"] = np.where(
            rng.uniform(size=n_sd) < 0.3, 0.0, rng.uniform(235.0, 265.0, n_sd)
        )
    products = [
        getattr(package.products, name)(name=name) for name in PRODUCT_NAMES
    ]
    if singular:
        products.append(package.products.FreezableSpecificConcentration(
            np.linspace(230.0, 270.0, 9), name="FreezableSpecificConcentration"
        ))
    builder.request_attribute("temperature of last freezing")
    p = builder.build(attributes, products=products)
    if not singular:
        p.inject_u01({"freezing_immersion": rng.uniform(size=n_sd)})
    p.run(1)
    env["T"] = np.asarray([248.5])  # a cooling rate of 0.75 K/s
    return p


@functools.cache
def _product_boxes(singular):
    return _product_box(pysdm_tpu, singular), _product_box(pysdm_tpu_torch, singular)


@pytest.fixture(params=(True, False), ids=("singular", "time"))
def product_boxes(request):
    return _product_boxes(request.param)


def _assert_same_product(jp, tp, name):
    want = np.asarray(jp.products[name].get())
    got = tp.products[name].get()
    assert got.shape == want.shape
    assert np.isfinite(want).all() and want.any()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", PRODUCT_NAMES)
def test_freezing_product_matches_jax_package(product_boxes, name):
    _assert_same_product(*product_boxes, name)


def test_freezable_specific_concentration_matches_jax_package():
    _assert_same_product(
        *_product_boxes(singular=True), "FreezableSpecificConcentration"
    )


def test_freezing_records_match_jax_package(product_boxes):
    jp, tp = product_boxes
    for name in ("temperature of last freezing", "cooling rate prev T",
                 "cooling rate"):
        np.testing.assert_array_equal(
            tp.attributes[name], np.asarray(jp.attributes[name])
        )
    frozen = tp.attributes["signed water mass"] < 0
    assert np.isnan(tp.attributes["temperature of last freezing"][~frozen]).all()
    assert (tp.attributes["temperature of last freezing"][frozen] == 250.0).all()


def test_jax_mixed_phase_state_carried_across_runs_on():
    jp = _product_box(pysdm_tpu, singular=True)
    tp = _product_box(pysdm_tpu_torch, singular=True)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    particles = tp.sim_state["particles"]
    assert particles.max_names == jp.sim_state["particles"].max_names
    assert "freezing temperature" in particles.max_names
    for p in (jp, tp):
        p.environment["T"] = np.asarray([245.0])
        p.run(2)
    for name in ("signed water mass", "freezing temperature",
                 "temperature of last freezing", "cooling rate"):
        np.testing.assert_array_equal(
            tp.attributes[name], np.asarray(jp.attributes[name])
        )
    assert (tp.attributes["temperature of last freezing"] == 245.0).any()


# --- K3 on rows with ice ------------------------------------------------------
K3_SETTINGS = DropSolveSettings(1e-2, 1e-7, 16, 64)


@functools.cache
def _k3_rows_with_ice():
    """``chip_smoke.k3_rows`` at 4096 drops, settled, and the same rows with
    every fourth drop frozen (its mass negated)"""
    rows = chip_smoke.settle_haze(
        pysdm_tpu_torch.Formulae(seed=44), chip_smoke.k3_rows(4096), "cpu"
    )
    return rows, chip_smoke.k3_rows_with_ice(rows)


def test_k3_twin_leaves_ice_alone_and_the_liquid_as_it_was():
    rows, mixed = _k3_rows_with_ice()
    ice = mixed["water_mass"] < 0
    # every fourth drop, but for the zero-mass ones among them
    assert 0.23 < ice.mean() <= 0.25
    liquid_f = pysdm_tpu_torch.Formulae(seed=44)
    mixed_f = pysdm_tpu_torch.Formulae(
        seed=44, particle_shape_and_density="MixedPhaseSpheres"
    )
    k3.check_variants(mixed_f)
    all_liquid = chip_smoke.k3_call(k3.masses_new, liquid_f, K3_SETTINGS, rows, "cpu")
    with np.errstate(invalid="raise"):
        got = chip_smoke.k3_call(k3.masses_new, mixed_f, K3_SETTINGS, mixed, "cpu")
    assert np.isfinite(got[0]).all()
    chip_smoke.check_k3_ice(mixed, *got)
    np.testing.assert_array_equal(got[0][~ice], all_liquid[0][~ice])
    np.testing.assert_array_equal(got[1][~ice], all_liquid[1][~ice])
    same = chip_smoke.k3_call(k3.masses_new, liquid_f, K3_SETTINGS, mixed, "cpu")
    for a, b in zip(got, same):
        np.testing.assert_array_equal(a, b)


def test_k3_twin_matches_pallas_kernel_on_rows_with_ice():
    _, rows = _k3_rows_with_ice()
    cell = rows["cell_id"]
    act_d = np.where(rows["multiplicity"] > 0, rows["active"][cell], False)
    zeros = np.zeros_like(rows["water_mass"])
    fused = make_fused_masses_new(
        pysdm_tpu.Formulae(seed=44, particle_shape_and_density="MixedPhaseSpheres"),
        RH_rtol=K3_SETTINGS.RH_rtol, max_iters=K3_SETTINGS.max_iters,
        bisect_iters=K3_SETTINGS.bisect_iters, rtol_x=K3_SETTINGS.rtol_x,
    )
    pallas = fused(
        *(jnp.asarray(a, jnp.float32) for a in (
            rows["water_mass"], rows["vdry"], rows["kappa"], zeros, zeros,
            rows["thd"][cell], rows["qv"][cell], rows["rhod"][cell],
            rows["dt_sub"][cell], act_d, rows["rho_air"][cell],
            rows["mu_air"][cell],
        )),
        interpret=True,
    )
    pallas = (np.asarray(pallas[0]), np.asarray(pallas[1]))
    twin = chip_smoke.k3_call(
        k3.masses_new,
        pysdm_tpu_torch.Formulae(seed=44, particle_shape_and_density="MixedPhaseSpheres"),
        K3_SETTINGS, rows, "cpu",
    )
    chip_smoke.check_k3_ice(rows, *pallas)
    chip_smoke.check_k3_ice(rows, *twin)
    np.testing.assert_array_equal(twin[1], pallas[1])
    ice = rows["water_mass"] < 0
    moved = ~ice & ((twin[0] != rows["water_mass"]) | (pallas[0] != rows["water_mass"]))
    x_old = np.abs(np.log(np.abs(rows["water_mass"][moved]).astype(np.float64)))
    dx = np.abs(np.log(twin[0][moved].astype(np.float64))
                - np.log(pallas[0][moved].astype(np.float64)))
    assert (dx <= 2 * K3_SETTINGS.rtol_x * x_old + 2e-5).all()


# --- refusals and defaults ----------------------------------------------------
def test_collision_on_a_state_with_maximum_rows_is_refused():
    """coalescence on a state with max-merged rows (the freezing records),
    which was refused before the float64 collision path was ported: both
    packages take their plain coalescence with ``max_s`` on the mirror
    croupier; five steps of the port, drawing the JAX key chain's K and
    gamma rows, against the JAX package's: multiplicities equal, masses and
    the records (NaN where none was made) to rtol 1e-12, and a merged
    droplet carries the pair's larger record"""
    rng = np.random.default_rng(16)
    t_freeze = rng.uniform(240.0, 260.0, 16)
    t_freeze[::3] = np.nan
    attributes = {
        "multiplicity": rng.integers(10**8, 10**9, 16),
        "signed water mass": rng.uniform(0.5e-12, 2e-12, 16),
        "freezing temperature": t_freeze,
    }
    pair = []
    for pkg, backend in ((pysdm_tpu, pysdm_tpu.backends.CPU), (pysdm_tpu_torch, CPU)):
        kernels = pkg.dynamics.collisions.collision_kernels
        builder = pkg.Builder(
            n_sd=16,
            backend=backend(pkg.Formulae(
                seed=1, particle_shape_and_density="MixedPhaseSpheres"
            )),
            environment=pkg.environments.Box(dt=1.0, dv=1.0),
        )
        builder.add_dynamic(pkg.dynamics.Coalescence(
            collision_kernel=kernels.Golovin(b=1.5e3), adaptive=False
        ))
        pair.append(builder.build(dict(attributes)))
    jp, tp = pair
    assert tp.dynamics["Collision"].route() == "float64"
    state = {"key": jp.sim_state["key"]}

    def draw_mirror(n_sd, n_rows=0):
        key, k_sh, k_gam, _, _ = jax.random.split(state["key"], 5)
        state["key"] = key
        K = int(jax.random.randint(k_sh, (), 0, n_sd, dtype=jnp.int32))
        rows = [torch.from_numpy(np.array(
            jax.random.uniform(k_gam, (n_sd,), dtype=jnp.float64)
        ))][:n_rows]
        return K, 0, rows

    tp.dynamics["Collision"]._draw_mirror = draw_mirror
    for _ in range(5):
        jp.run(1)
        tp.run(1)
        np.testing.assert_array_equal(
            tp.attributes["multiplicity"],
            np.asarray(jp.attributes["multiplicity"]),
        )
        for name in ("signed water mass", "freezing temperature"):
            np.testing.assert_allclose(
                tp.attributes[name], np.asarray(jp.attributes[name]),
                rtol=1e-12, err_msg=name,
            )
    got = tp.attributes["freezing temperature"]
    assert tp.get_counter("coalescence_rate")[0] > 0
    assert np.isnan(got).sum() < np.isnan(t_freeze).sum()
    assert np.nanmax(got) == np.nanmax(t_freeze)


def _ice_entry_points():
    from pysdm_tpu_torch.initialisation import spectra as spc
    from pysdm_tpu_torch.models import (
        abade_and_albuquerque_2024,
        alpert_and_knopf_2016,
        niedermeier_et_al_2014,
        spichtinger_et_al_2023,
    )

    yield lambda: alpert_and_knopf_2016.simulation(
        constants={"J_HET": 1e7}, seed=1, n_sd=10, time_step=10.0,
        volume=1e-8,
        spectrum=spc.Lognormal(norm_factor=10 / 1e-8, m_mode=1e-9, s_geom=1.0),
        droplet_volume=1e-18, multiplicity=1, total_time=10.0,
        number_of_real_droplets=10, initial_temperature=240.0,
    )
    yield lambda: spichtinger_et_al_2023.Simulation(
        spichtinger_et_al_2023.Settings(n_sd=8, w_updraft=1.0, T0=220.0,
                                        seed=1, dt=1.0)
    )
    yield lambda: abade_and_albuquerque_2024.Simulation(
        abade_and_albuquerque_2024.Settings(n_sd=8, timestep=10.0, seed=1)
    )
    yield lambda: niedermeier_et_al_2014.Simulation(
        niedermeier_et_al_2014.Settings(
            formulae=pysdm_tpu_torch.Formulae(
                seed=1, particle_shape_and_density="MixedPhaseSpheres",
                heterogeneous_ice_nucleation_rate="Constant",
                constants={"J_HET": 1e12},
            ),
            initial_temperature=250.0, timestep=5.0,
            ccn_sampling_n=5, in_sampling_n=4,
        )
    )


@pytest.mark.parametrize("which", range(4), ids=(
    "alpert_and_knopf_2016", "spichtinger_et_al_2023",
    "abade_and_albuquerque_2024", "niedermeier_et_al_2014",
))
def test_ice_entry_points_default_to_the_card(monkeypatch, which):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        list(_ice_entry_points())[which]()
