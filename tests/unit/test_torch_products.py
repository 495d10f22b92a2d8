"""The port's liquid-phase products (``pysdm_tpu_torch/products/``) against
the JAX package's on the same states, in float64 on the CPU.

Three scenarios, each built alike in both packages and run in the JAX
package; its state (particles, env, counters, flags) is then carried into
the port (``sim_state_from_numpy``) with the step count, and every product
is read in both:
- a box (Golovin, adaptive, 512 super-droplets, 4 steps of 50 s) with the
  spectra, concentrations, radii, standard deviations, water contents,
  moments, collision timesteps and timers that need no ambient state;
- an adiabatic parcel (64 drops, 17 s from near saturation, so that 43
  of them have activated) with the activation-filtered products, the activable
  fraction, the condensation timesteps, the ambient fields and the parcel's
  displacement and liquid water path;
- the Shipway and Hill 2012 column (37 cells x 16, 10 steps of 5 s) with
  the Courant number, the flow velocity, the terminal velocities and the
  activation-filtered concentration.
Bounds: rtol 1e-12 (the two packages sum per-cell moments in another
order), 0 for the integer counts and the time. Also: the timers, the
per-dynamic timing mode (``tests/unit/test_products.py``'s test on the
port) and the "terminal velocity" attribute of the three terminal-velocity
variants against the JAX package.
"""

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu import products as jax_products
from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.models import shipway_and_hill_2012 as jax_column

import pysdm_tpu_torch
from pysdm_tpu_torch import products as port_products
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Coalescence, Condensation
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
from pysdm_tpu_torch.environments import Box, Parcel
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.initialisation import spectra as port_spectra
from pysdm_tpu_torch.initialisation.sampling import (
    spectral_sampling as port_sampling,
)
from pysdm_tpu_torch.models import shipway_and_hill_2012 as port_column
from pysdm_tpu_torch.physics import si

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-12
RADIUS_BINS = np.logspace(np.log10(5 * si.um), np.log10(5e3 * si.um), num=33)
R_RANGE = (20 * si.um, 200 * si.um)
CLOUD = (1 * si.um, np.inf)


def _box_products(pkg):
    arbitrary = pkg.make_arbitrary_moment_product(
        rank=3, attr="radius", attr_unit="m", skip_division_by_dv=True
    )
    return (
        pkg.ParticleSizeSpectrumPerVolume(RADIUS_BINS, name="dN/dr"),
        pkg.ParticleSizeSpectrumPerMassOfDryAir(RADIUS_BINS, name="dN/dr/rhod"),
        pkg.RadiusBinnedNumberAveragedTerminalVelocity(RADIUS_BINS, name="vt bins"),
        pkg.TotalParticleConcentration(name="N"),
        pkg.TotalParticleSpecificConcentration(name="n"),
        pkg.ParticleConcentration(radius_range=R_RANGE, name="N range"),
        pkg.ParticleSpecificConcentration(radius_range=R_RANGE, name="n range"),
        pkg.MeanRadius(name="mean r"),
        pkg.MeanRadius(name="mean r range", radius_range=R_RANGE),
        pkg.MeanVolumeRadius(name="mean volume r"),
        pkg.MeanVolumeRadius(radius_range=R_RANGE, name="mean volume r range"),
        pkg.RadiusStandardDeviation(name="sd r"),
        pkg.AreaStandardDeviation(radius_range=R_RANGE, name="sd area range"),
        pkg.VolumeStandardDeviation(name="sd v"),
        pkg.SpecificCloudWaterContent(name="scwc"),
        pkg.LiquidWaterContent(name="lwc"),
        pkg.SpecificLiquidWaterContent(name="slwc"),
        pkg.ZerothMoment(name="M0"),
        pkg.VolumeFirstMoment(name="M1"),
        pkg.VolumeSecondMoment(name="M2"),
        pkg.RadiusFirstMoment(name="R1"),
        pkg.RadiusSixthMoment(name="R6"),
        arbitrary(name="R3"),
        pkg.CollisionTimestepMean(name="dt coll mean"),
        pkg.CollisionTimestepMin(name="dt coll min"),
        pkg.AveragedTerminalVelocity(name="vt", radius_range=R_RANGE),
        pkg.Time(name="time"),
    )


def _parcel_products(pkg):
    activated = dict(count_activated=True, count_unactivated=False)
    unactivated = dict(count_activated=False, count_unactivated=True)
    return (
        pkg.ActivatedParticleConcentration(**activated, name="N act"),
        pkg.ActivatedParticleConcentration(**unactivated, name="N unact"),
        pkg.ActivatedParticleConcentration(**activated, stp=True, name="N act stp"),
        pkg.ActivatedParticleSpecificConcentration(**activated, name="n act"),
        pkg.ActivatedMeanRadius(**activated, name="mean r act"),
        pkg.ActivatedMeanRadius(**unactivated, name="mean r unact"),
        pkg.ActivatedEffectiveRadius(**activated, name="reff act"),
        pkg.RadiusStandardDeviation(**activated, name="sd r act"),
        pkg.VolumeStandardDeviation(**unactivated, name="sd v unact"),
        pkg.CondensationTimestepMin(name="dt cond min"),
        pkg.CondensationTimestepMax(name="dt cond max"),
        pkg.AmbientPressure(name="p"),
        pkg.AmbientRelativeHumidityWrtIce(name="RH ice"),
        pkg.AmbientRelativeHumidityWrtIce(name="RH ice %", unit="%"),
        pkg.AmbientDryAirDensity(name="rhod"),
        pkg.AmbientDryAirPotentialTemperature(name="thd"),
        pkg.AmbientWaterVapourMixingRatio(name="qv"),
        pkg.ParcelDisplacement(name="z"),
        pkg.ActivableFraction(name="activable"),
        pkg.ParcelLiquidWaterPath(**activated, name="lwp"),
    )


def _column_products(pkg):
    return (
        pkg.MaxCourantNumber(name="max courant"),
        pkg.FlowVelocityComponent(0, name="w"),
        pkg.AveragedTerminalVelocity(name="vt", radius_range=CLOUD),
        pkg.RadiusBinnedNumberAveragedTerminalVelocity(RADIUS_BINS, name="vt bins"),
        pkg.ActivatedParticleConcentration(
            count_activated=False, count_unactivated=True, name="N unact"
        ),
        pkg.MeanRadius(name="mean r"),
        pkg.CondensationTimestepMin(name="dt cond min"),
        pkg.AmbientPressure(name="p"),
        pkg.SpecificLiquidWaterContent(name="slwc"),
    )


def _names(products):
    return [p.name for p in products(port_products)]


def _carry(jp, tp):
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    tp.n_steps = jp.n_steps


def _box(package, products_of=_box_products):
    if package == "jax":
        pkg, backend, dynamics, envs = (
            pysdm_tpu, pysdm_tpu.backends.CPU, pysdm_tpu.dynamics,
            pysdm_tpu.environments,
        )
        kernel, spectra, sampling, products = (
            jax_kernels.Golovin, jax_spectra, jax_sampling, jax_products
        )
    else:
        pkg, backend, kernel = pysdm_tpu_torch, CPU, Golovin
        dynamics = envs = None
        spectra, sampling, products = port_spectra, port_sampling, port_products
    formulae = pkg.Formulae(seed=44)
    env = (envs.Box if envs else Box)(dv=1e6 * si.m**3, dt=50 * si.s)
    builder = pkg.Builder(n_sd=512, backend=backend(formulae), environment=env)
    builder.particulator.environment["rhod"] = 1.1
    builder.add_dynamic(
        (dynamics.Coalescence if dynamics else Coalescence)(
            collision_kernel=kernel(b=1.5e3), adaptive=True
        )
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = (
        sampling.ConstantMultiplicity(
            spectra.Exponential(norm_factor=2**23 * 1e6, scale=x_0)
        ).sample(512)
    )
    return builder.build(attributes, products_of(products))


def _parcel(package):
    """``tests/smoke/test_torch_parcel.py``'s parcel from qv0 = 0.0225"""
    if package == "jax":
        pkg, backend, dynamics, envs = (
            pysdm_tpu, pysdm_tpu.backends.CPU, pysdm_tpu.dynamics,
            pysdm_tpu.environments,
        )
        spectra, sampling, products = jax_spectra, jax_sampling, jax_products
        thermo, condensation, parcel = (
            dynamics.AmbientThermodynamics, dynamics.Condensation, envs.Parcel
        )
    else:
        pkg, backend = pysdm_tpu_torch, CPU
        spectra, sampling, products = port_spectra, port_sampling, port_products
        thermo, condensation, parcel = AmbientThermodynamics, Condensation, Parcel
    env = parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.0225, T0=300.0, w=2.0,
    )
    builder = pkg.Builder(
        n_sd=64, backend=backend(pkg.Formulae(seed=44)), environment=env
    )
    builder.add_dynamic(thermo())
    builder.add_dynamic(condensation(adaptive=True))
    r_dry, n_in_dv = sampling.ConstantMultiplicity(
        spectra.Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    ).sample(64)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes, _parcel_products(products))


def _column(package):
    model, backend, products = (
        (jax_column, pysdm_tpu.backends.CPU, jax_products)
        if package == "jax" else (port_column, CPU, port_products)
    )
    settings = model.Settings(n_sd_per_gridbox=16, dz=100 * si.m, dt=5 * si.s)
    return model.Simulation(
        settings, backend_class=backend, products=_column_products(products)
    ).particulator


@pytest.fixture(scope="module", name="box")
def _box_pair():
    jp, tp = _box("jax"), _box("port")
    jp.run(4)
    _carry(jp, tp)
    assert (tp.get_counter("collision_n_substep") >= 4).all()
    return jp, tp


@pytest.fixture(scope="module", name="parcel")
def _parcel_pair():
    jp, tp = _parcel("jax"), _parcel("port")
    jp.run(17)
    _carry(jp, tp)
    lwp = tp.products["lwp"]
    jax_lwp = jp.products["lwp"]
    lwp.previous = {k: np.array(v) for k, v in jax_lwp.previous.items()}
    lwp.cwp = np.array(jax_lwp.cwp)
    ratio = tp.attributes["volume"] / tp.get_attribute("critical volume").numpy()
    assert (ratio > 1).any() and (ratio < 1).any()
    return jp, tp


@pytest.fixture(scope="module", name="column")
def _column_pair():
    jp, tp = _column("jax"), _column("port")
    jp.run(10)
    _carry(jp, tp)
    return jp, tp


def _assert_product_equal(pair, name, **kwargs):
    jp, tp = pair
    expected = np.asarray(jp.products[name].get(**kwargs), dtype=float)
    got = np.asarray(tp.products[name].get(**kwargs), dtype=float)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=0, equal_nan=True)
    return got


@pytest.mark.parametrize("name", _names(_box_products))
def test_box_product_matches_jax_package(box, name):
    got = _assert_product_equal(box, name)
    assert np.isfinite(got).any()


@pytest.mark.parametrize("name", _names(_parcel_products))
def test_parcel_product_matches_jax_package(parcel, name):
    if name == "lwp":
        # the path integrates after every step: one more JAX step, carried
        # across, then the port's own notify on that state
        jp, tp = parcel
        jp.run(1)
        _carry(jp, tp)
        tp.products["lwp"].notify()
    kwargs = {"S_max": 0.5} if name == "activable" else {}
    got = _assert_product_equal(parcel, name, **kwargs)
    assert np.isfinite(got).all()
    if name in ("lwp", "activable", "N act", "N unact"):
        assert (got > 0).all()


@pytest.mark.parametrize("name", _names(_column_products))
def test_column_product_matches_jax_package(column, name):
    got = _assert_product_equal(column, name)
    assert np.isfinite(got).all()


def _timers(pkg):
    return (pkg.WallTime(), pkg.CPUTime(), pkg.DynamicWallTime("Collision"))


def test_timers():
    """``WallTime`` and ``CPUTime`` positive and restarted by ``reset``"""
    tp = _box("port", _timers)
    tp.run(2)
    wall = tp.products["wall time"].get()
    assert 0 < wall < 60 and tp.products["CPU time"].get() > 0
    tp.products["wall time"].reset()
    assert tp.products["wall time"].get() < wall


def test_per_dynamic_timing_mode():
    """``tests/unit/test_products.py::test_per_dynamic_timing_mode`` on the
    port: without the opt-in ``DynamicWallTime`` is NaN; with it positive
    per dynamic, and zero when read again at once (reset on read)"""
    tp = _box("port", _timers)
    tp.run(3)
    assert np.isnan(float(tp.products["Collision wall time"].get()))

    tp = _box("port", _timers)
    tp.enable_per_dynamic_timing()
    tp.run(3)
    t1 = float(tp.products["Collision wall time"].get())
    assert np.isfinite(t1) and t1 > 0
    assert float(tp.products["Collision wall time"].get()) == 0.0
    assert tp.timers["total"] >= t1


@pytest.mark.parametrize("variant", ("GunnKinzer1949", "PowerSeries", "RogersYau"))
def test_terminal_velocity_variants_match_jax_package(variant):
    """the "terminal velocity" attribute of each terminal-velocity variant,
    radii 1 um-5 mm across the RogersYau branches, float64, rtol 1e-12"""
    radius = np.logspace(-6, np.log10(5e-3), 257)
    volume = 4 / 3 * np.pi * radius**3
    pair = []
    for pkg, backend, box in (
        (pysdm_tpu, pysdm_tpu.backends.CPU, pysdm_tpu.environments.Box),
        (pysdm_tpu_torch, CPU, Box),
    ):
        formulae = pkg.Formulae(seed=1, terminal_velocity=variant)
        builder = pkg.Builder(
            n_sd=radius.size, backend=backend(formulae),
            environment=box(dv=1.0, dt=1.0),
        )
        builder.request_attribute("terminal velocity")
        pair.append(builder.build(
            {"multiplicity": np.ones(radius.size), "volume": volume}
        ))
    expected = np.asarray(pair[0].attributes["terminal velocity"])
    got = pair[1].attributes["terminal velocity"]
    np.testing.assert_allclose(got, expected, rtol=1e-12)
    assert (np.diff(got) > 0).all()
