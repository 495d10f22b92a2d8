"""The port's 1D column (config #4, ``pysdm_tpu_torch/models/
shipway_and_hill_2012.py``) against the JAX package on the CPU, float64 on
both sides, through both packages' ``Simulation``:
``Settings(n_sd_per_gridbox=16, dz=100 m, dt=5 s, seed=44)``, 37 cells
(a 700 m particle reservoir below 3 km) and 592 super-droplets.

The column's ``Simulation`` always adds adaptive Coalescence, whose draws
the two packages take from different generators. So both ``Simulation``s
are built here with u01 injection switched on before build and with
non-adaptive coalescence (both packages refuse injection with adaptive
coalescence), and the same u01 streams are injected into both before every
step. The JAX side runs its TPU kernels in interpret mode
(``PYSDM_TPU_PALLAS_INTERPRET``, the condensation kernel off), so its
coalescence is ``fused_coalesce``, whose float32 semantics the port's K2
twin shares.

- 20 steps (100 s, below cloud): thd, qv and RH to rtol 1e-12, the
  attributes to rtol 1e-9.
- 10 more steps, every other one with its gamma draws on [0, 1e-8) so
  that pairs of haze particles merge (with uniform draws none does below
  cloud): multiplicities equal, masses and ``precipitated_mass`` to rtol
  1e-9, the float32 rate counters (per-cell sums taken in another order)
  to rtol 1e-5 beside an absolute 2^-20 of their total, nonzero in
  several cells.
- 50 more steps, to t = 400 s, where the cloud has formed: the state as
  above, then each of the ten products the column reads (and the two
  other event rates), on the same state, to rtol 1e-10.
- A JAX state carried across with ``sim_state_from_numpy`` (the host clock
  included), then one step on each side, to rtol 1e-10.
"""

import jax
import numpy as np
import pytest
import torch

import pysdm_tpu
from pysdm_tpu import products as jax_products
from pysdm_tpu.models import shipway_and_hill_2012 as jax_model
import pysdm_tpu_torch
from pysdm_tpu_torch import products as port_products
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.models import shipway_and_hill_2012 as port_model
from pysdm_tpu_torch.physics import si

SPIN_UP_STEPS = 20
RAIN_STEPS = 10
# on to t = 400 s, where the cloud has formed
CLOUD_STEPS = 50
# the gamma draws' range in the coalescence steps that merge pairs
MERGING_GAMMA_SCALE = 1e-8
SETTINGS = dict(n_sd_per_gridbox=16, dz=100 * si.m, dt=5 * si.s, seed=44)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _products(pkg):
    """the ten products the column reads (the model's seven, and the three
    more of the published-profile test), and the two other event rates"""
    return (
        pkg.AmbientRelativeHumidity(name="RH"),
        pkg.AmbientTemperature(name="T"),
        pkg.WaterMixingRatio(name="qc", radius_range=(1 * si.um, np.inf)),
        pkg.CloudWaterContent(name="cwc"),
        pkg.EffectiveRadius(name="reff", radius_range=(1 * si.um, np.inf)),
        pkg.PeakSupersaturation(name="S_max"),
        pkg.SurfacePrecipitation(name="surf_precip"),
        pkg.SuperDropletCountPerGridbox(name="sd_count"),
        pkg.PeakSaturation(name="peak saturation"),
        pkg.ActivatingRate(name="activating"),
        pkg.RipeningRate(name="ripening"),
        pkg.DeactivatingRate(name="deactivating"),
    )


def _simulation(mp, model, backend, products):
    """``model.Simulation`` with u01 injection and non-adaptive
    coalescence (the model module's Builder and Coalescence patched for the
    build only)"""
    builder_class, coalescence = model.Builder, model.Coalescence

    class InjectingBuilder(builder_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.enable_u01_injection()

    with mp.context() as patch:
        patch.setattr(model, "Builder", InjectingBuilder)
        patch.setattr(
            model, "Coalescence",
            lambda **kwargs: coalescence(**{**kwargs, "adaptive": False}),
        )
        settings = model.Settings(**SETTINGS)
        return model.Simulation(settings, backend_class=backend, products=products)


def _inject(particulators, rng, n_sd, gamma_scale=1.0):
    """the same u01 streams in both packages: shuffle draws tie-free in
    the packed key (k / 2^20 + 2^-22, exact in float32), gamma draws
    uniform on [0, gamma_scale)"""
    shuffle = (rng.permutation(2**20)[:n_sd] / 2**20 + 2**-22).astype(np.float32)
    gamma = rng.uniform(size=n_sd) * gamma_scale
    for p in particulators:
        p.inject_u01({"collision_shuffle": shuffle, "collision_gamma": gamma})


def _run(pair, rng, steps, gamma_scale=1.0):
    jp, tp = pair
    for _ in range(steps):
        _inject(pair, rng, tp.n_sd, gamma_scale)
        jp.run(1)
        tp.run(1)


@pytest.fixture(scope="module", name="pair")
def _pair():
    """(jax particulator, port particulator) after the spin-up"""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("PYSDM_TPU_NO_PALLAS_COND", "1")
    jp = _simulation(
        mp, jax_model, pysdm_tpu.backends.CPU, _products(jax_products)
    ).particulator
    tp = _simulation(mp, port_model, CPU, _products(port_products)).particulator
    assert (tp.mesh.n_cell, tp.n_sd) == (37, 592)
    _run((jp, tp), np.random.default_rng(0), SPIN_UP_STEPS)
    yield jp, tp
    mp.undo()


def _assert_same(jp, tp, rtol_attr, rtol_env=1e-12):
    for key in ("thd", "qv", "RH"):
        np.testing.assert_allclose(
            tp.get_env(key), np.asarray(jp.get_env(key)), rtol=rtol_env,
            err_msg=key,
        )
    for name in ("multiplicity", "cell id", "cell origin"):
        np.testing.assert_array_equal(
            tp.attributes[name], np.asarray(jp.attributes[name]), err_msg=name
        )
    for name in ("water mass", "dry volume", "position in cell"):
        np.testing.assert_allclose(
            tp.attributes[name], np.asarray(jp.attributes[name]),
            rtol=rtol_attr, err_msg=name,
        )
    np.testing.assert_array_equal(
        tp.get_counter("condensation_n_substeps"),
        np.asarray(jp.get_counter("condensation_n_substeps")),
    )
    np.testing.assert_allclose(
        tp.get_counter("precipitated_mass"),
        np.asarray(jp.get_counter("precipitated_mass")), rtol=rtol_attr,
    )


def test_spin_up_matches_jax_package(pair):
    jp, tp = pair
    _assert_same(jp, tp, rtol_attr=1e-9)
    assert tp.get_counter("condensation_success").all()
    assert float(tp.get_env("t")) == SPIN_UP_STEPS * SETTINGS["dt"]
    assert tp.sim_state["host"]["t"] == SPIN_UP_STEPS * SETTINGS["dt"]
    # the updraft has moved the column: its courant field is the JAX one
    np.testing.assert_allclose(
        tp.get_env("courant_0"), np.asarray(jp.get_env("courant_0")),
        rtol=1e-12,
    )
    assert tp.get_env("courant_0").max() > 0


def test_coalescence_steps_with_injected_u01_match_jax_package(pair):
    jp, tp = pair
    mult0 = tp.attributes["multiplicity"]
    substeps0 = tp.dynamics["Collision"].substeps_run
    rng = np.random.default_rng(1)
    # below cloud the haze's collision probabilities (~1e-8) stay far under
    # uniform gamma draws: every other step draws gamma on [0, 1e-8), so
    # that pairs merge where p exceeds the draw, in both packages
    for step in range(RAIN_STEPS):
        _run(pair, rng, 1, gamma_scale=MERGING_GAMMA_SCALE if step % 2 else 1.0)
    _assert_same(jp, tp, rtol_attr=1e-9)
    for name in ("collision_rate", "coalescence_rate", "collision_rate_deficit"):
        want = np.asarray(jp.get_counter(name))
        # per-cell float32 sums taken in another order: a cell's sum is a
        # difference of two prefixes over the whole column (K4's semantics)
        # and is off by a few ulps of the total, which a cell whose rate is
        # 0 sees as an absolute difference
        np.testing.assert_allclose(
            tp.get_counter(name), want, rtol=1e-5,
            atol=2**-20 * float(want.sum()), err_msg=name,
        )
    # pairs merged in several cells, in both packages
    assert (tp.get_counter("coalescence_rate") > 0).sum() > 1
    assert (np.asarray(jp.get_counter("coalescence_rate")) > 0).sum() > 1
    # multiplicities fell through merging, and through droplets that left
    # through the top and the reservoir's bottom
    assert tp.attributes["multiplicity"].sum() < mult0.sum()
    assert tp.dynamics["Collision"].substeps_run - substeps0 == RAIN_STEPS


def test_products_in_cloud_match_jax_package(pair):
    jp, tp = pair
    _run(pair, np.random.default_rng(3), CLOUD_STEPS)
    assert tp.get_env("RH").max() > 1
    _assert_same(jp, tp, rtol_attr=1e-9)
    assert tp.products["qc"].get().max() > 0
    for name, product in tp.products.items():
        got = product.get()
        want = np.asarray(jp.products[name].get())
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0, err_msg=name)
    # read again: the reset-on-read products are zero in both, the others
    # unchanged
    for name in (
        "S_max", "peak saturation", "activating", "ripening", "deactivating",
        "surf_precip",
    ):
        np.testing.assert_array_equal(
            tp.products[name].get(), np.asarray(jp.products[name].get()),
            err_msg=name,
        )


def test_state_carried_from_jax_package(pair):
    jp, tp = pair
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    assert tp.sim_state["host"]["t"] == float(np.asarray(jp.get_env("t")))
    _run(pair, np.random.default_rng(2), 1)
    # the states start equal: what differs is one step's summation order
    _assert_same(jp, tp, rtol_attr=1e-10, rtol_env=1e-10)
