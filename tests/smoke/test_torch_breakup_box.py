"""The port's breakup box slice (config #2, de Jong/Mackay et al. 2023) as
a whole against the JAX package on the CPU, its products, and its model.

The JAX side runs ``bench.py``'s config #2 recipe (``_bench_breakup``) on
the ``CPU`` backend with ``PYSDM_TPU_PALLAS_INTERPRET=1``; at n_sd = 2^15
its dispatch takes ``fused_breakup_mirror_blocks``. The port replays the
JAX key chain's (K, seed) through ``Collision._draw_mirror``, as
``test_torch_box.py`` does. Bounds:
- after one step, slot by slot: multiplicities equal except at breakup
  slots, which hold the kernel test's bound (rel 1e-4 on > 99.9% of the
  slots); water masses to rtol 1e-6 where the multiplicities agree (the
  breakup transfer rounds through float32 exp/log, an ulp apart between
  XLA and torch); ``collision_n_substep`` exactly; counters to rtol 1e-5
  (float32 sums in another order);
- after the further steps, aggregates: total number to rtol 1e-5, water
  mass to rtol 1e-6 of the start on both sides, the five counters to rtol
  1e-4, because one slot that differs changes the next adaptive substep.
  (Measured: every slot equal after 10 steps, counters exact.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.models import dejong_mackay_et_al_2023 as jax_model
from pysdm_tpu.ops import moments as jax_moments

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Breakup, Coalescence, Collision
from pysdm_tpu_torch.dynamics.collisions.breakup_efficiencies import ConstEb
from pysdm_tpu_torch.dynamics.collisions.breakup_fragmentations import AlwaysN
from pysdm_tpu_torch.dynamics.collisions.coalescence_efficiencies import ConstEc
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import (
    ConstantK,
    Geometric,
)
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as port_model
from pysdm_tpu_torch.ops import moments as port_moments
from pysdm_tpu_torch.physics import si

N_SD = 2**15
COUNTERS = (
    "collision_rate", "collision_rate_deficit", "coalescence_rate",
    "breakup_rate", "breakup_rate_deficit",
)


def _jax_box(adaptive, dt):
    s = jax_model.Settings0D(seed=44, warn_overflows=False)
    builder = pysdm_tpu.Builder(
        n_sd=N_SD, backend=pysdm_tpu.backends.CPU(s.formulae),
        environment=pysdm_tpu.environments.Box(dv=s.dv, dt=dt),
    )
    builder.add_dynamic(pysdm_tpu.dynamics.Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
        adaptive=adaptive, warn_overflows=False,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = (
        jax_sampling.ConstantMultiplicity(s.spectrum).sample(N_SD)
    )
    return builder.build(attributes)


def _port_box(adaptive, dt, n_sd=N_SD):
    s = port_model.Settings0D(seed=44, warn_overflows=False)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(s.formulae), environment=Box(dv=s.dv, dt=dt)
    )
    builder.add_dynamic(Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
        adaptive=adaptive, warn_overflows=False,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def _replay_jax_draws(particulator, key):
    """feed the port the (K, seed) pairs the JAX collision substeps draw
    from ``key`` on (the same 5-way split as the coalescence box)"""
    state = {"key": key}

    def draw_mirror(n_sd):
        key, k_sh, k_gam, _, _ = jax.random.split(state["key"], 5)
        state["key"] = key
        K = jax.random.randint(k_sh, (), 0, n_sd, dtype=jnp.int32)
        seed = jax.random.bits(k_gam, (), jnp.uint32)
        return int(K), int(seed)

    particulator.dynamics["Collision"]._draw_mirror = draw_mirror


def _assert_slots_agree(jp, tp):
    expected = np.asarray(jp.attributes["multiplicity"])
    got = tp.attributes["multiplicity"]
    same = got == expected
    rel = np.abs(got - expected.astype(float)) / np.maximum(
        np.maximum(got, expected), 1
    )
    assert (rel < 1e-4).mean() > 0.999, rel.max()
    np.testing.assert_allclose(
        tp.attributes["water mass"][same],
        np.asarray(jp.attributes["water mass"])[same], rtol=1e-6,
    )
    np.testing.assert_array_equal(
        tp.get_counter("collision_n_substep"),
        jp.get_counter("collision_n_substep"),
    )
    for name in COUNTERS:
        np.testing.assert_allclose(
            tp.get_counter(name), jp.get_counter(name), rtol=1e-5
        )


def _totals(p):
    mult = np.asarray(p.attributes["multiplicity"])
    return float(mult.sum()), float((mult * p.attributes["water mass"]).sum())


@pytest.mark.parametrize(
    "adaptive, dt, n_steps",
    ((False, 1.0, 10), (True, 1.0, 10), (True, 5.0, 3)),
    ids=("non-adaptive", "adaptive", "adaptive-dt5"),
)
def test_breakup_box_matches_jax_package(adaptive, dt, n_steps, monkeypatch):
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp = _jax_box(adaptive, dt)
    tp = _port_box(adaptive, dt)
    _replay_jax_draws(tp, jp.sim_state["key"])
    number0, water0 = _totals(tp)
    jp.run(1)
    tp.run(1)
    _assert_slots_agree(jp, tp)
    assert tp.get_counter("breakup_rate")[0] > 0
    jp.run(n_steps - 1)
    tp.run(n_steps - 1)
    (number_j, water_j), (number_t, water_t) = _totals(jp), _totals(tp)
    np.testing.assert_allclose(number_t, number_j, rtol=1e-5)
    np.testing.assert_allclose([water_t, water_j], water0, rtol=1e-6)
    for name in COUNTERS:
        np.testing.assert_allclose(
            tp.get_counter(name), jp.get_counter(name), rtol=1e-4
        )
    assert number_t < number0
    if adaptive:
        substeps = tp.get_counter("collision_n_substep")[0]
        assert substeps == jp.get_counter("collision_n_substep")[0]
        assert substeps >= n_steps


def test_state_carried_from_jax_package(monkeypatch):
    """one JAX step, the whole sim_state (the two breakup counters
    included) carried across with ``sim_state_from_numpy``, then two more
    steps on each side"""
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp = _jax_box(True, 1.0)
    jp.run(1)
    tp = _port_box(True, 1.0)
    tp.sim_state = sim_state_from_numpy(jax.device_get(jp.sim_state), tp)
    assert tp.sim_state["counters"]["breakup_rate"].dtype == torch.float64
    _replay_jax_draws(tp, jp.sim_state["key"])
    jp.run(2)
    tp.run(2)
    _assert_slots_agree(jp, tp)


def _moment_inputs(n=4096, n_cell=3, seed=0):
    rng = np.random.default_rng(seed)
    mult = rng.integers(0, 10**9, n)
    volume = 10.0 ** rng.uniform(-18, -9, n)
    return {
        "multiplicity": mult, "attr_data": volume, "x_attr": volume,
        "cell_id": rng.integers(0, n_cell, n), "n_cell": n_cell,
        "weight": rng.uniform(0.5, 2.0, n),
    }


@pytest.mark.parametrize("rank, weighted", ((0, False), (1, False), (1, True)))
def test_spectrum_moments_match_jax_package(rank, weighted):
    """per-(bin, cell) moments in float64 against ``pysdm_tpu/ops/moments.py``
    (rtol 1e-12: sums in another order)"""
    x = _moment_inputs()
    bins = 10.0 ** np.linspace(-17, -10, 33)

    def kwargs(wrap):
        return dict(
            multiplicity=wrap(x["multiplicity"]), attr_data=wrap(x["attr_data"]),
            x_attr=wrap(x["x_attr"]), cell_id=wrap(x["cell_id"]),
            x_bins=wrap(bins), rank=rank, n_cell=x["n_cell"],
            weighting_attribute=wrap(x["weight"]) if weighted else None,
            weighting_rank=2 if weighted else 0,
        )

    expected = jax_moments.spectrum_moments(**kwargs(jnp.asarray))
    got = port_moments.spectrum_moments(**kwargs(torch.from_numpy))
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12)
    assert (got[0].numpy() > 0).mean() > 0.5


def test_moments_match_jax_package():
    x = _moment_inputs(seed=1)

    def kwargs(wrap):
        return dict(
            multiplicity=wrap(x["multiplicity"]), attr_data=wrap(x["attr_data"]),
            cell_id=wrap(x["cell_id"]), ranks=(0, 1, 3),
            filter_attr_data=wrap(x["x_attr"]), min_x=1e-15, max_x=1e-11,
            n_cell=x["n_cell"],
        )

    expected = jax_moments.moments(**kwargs(jnp.asarray))
    got = port_moments.moments(**kwargs(torch.from_numpy))
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12)


class TestDeJongMackay2023:
    """``tests/smoke/test_models.py:56-70`` on the port's CPU backend (n_sd =
    2^9: the JAX package takes its XLA breakup path there, the port K5's
    semantics, as at every N)"""

    @staticmethod
    def test_breakup_rates_reported():
        settings = port_model.Settings0D()
        settings.n_sd = 2**9
        settings._steps = [0, 16]
        out = port_model.run_box_breakup(
            settings, backend_class=CPU, return_nv=True
        )
        collision, deficit, coalescence, breakup = out.rates[-1]
        assert collision > 0 and coalescence > 0 and breakup > 0
        np.testing.assert_allclose(collision, coalescence + breakup, rtol=1e-6)
        assert out.y.shape == (2, len(settings.radius_bins_edges) - 1)
        assert out.core.device.type == "cpu"

    @staticmethod
    def test_spectra_conserve_mass_and_rerun_bit_equal():
        """the liquid under dv/dlnr is conserved (rtol 1e-7: every substep
        rounds each drop's mass to float32, as the TPU kernel does), and a
        second run of the same seed gives the same spectra bit for bit
        (deterministic moments)"""
        runs = []
        for _ in range(2):
            settings = port_model.Settings0D()
            settings._steps = [0, 10, 30]
            runs.append(port_model.run_box_breakup(
                settings, backend_class=CPU, return_nv=True
            ))
        np.testing.assert_array_equal(runs[0].y, runs[1].y)
        np.testing.assert_array_equal(runs[0].y2, runs[1].y2)
        edges = runs[0].core.products["dv/dlnr"].radius_bins_edges
        liquid = (runs[0].y * np.diff(np.log(edges))).sum(axis=1)
        np.testing.assert_allclose(liquid, liquid[0], rtol=1e-7)
        number = runs[0].y2.sum(axis=1)
        assert number[-1] < number[0]


def _run_box(dynamic, n_sd, steps, seed=44):
    """``tests/smoke/test_box_breakup.py:run_box`` on the port"""
    rng = np.random.default_rng(seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(pysdm_tpu_torch.Formulae(seed=seed)),
        environment=Box(dt=1 * si.s, dv=1 * si.m**3),
    )
    builder.add_dynamic(dynamic)
    attributes = {
        "multiplicity": np.full(n_sd, 1e8),
        "volume": rng.uniform(0.5, 2.0, n_sd) * (20 * si.um) ** 3,
    }
    particulator = builder.build(attributes, products=())
    mass0 = _totals(particulator)[1]
    particulator.run(steps)
    return particulator, mass0


def test_pure_breakup_grows_multiplicity_conserves_mass():
    dyn = Breakup(
        collision_kernel=ConstantK(a=1e-9 * si.m**3 / si.s),
        fragmentation_function=AlwaysN(n=4), adaptive=False, substeps=1,
    )
    particulator, mass0 = _run_box(dyn, n_sd=2**10, steps=10)
    np.testing.assert_allclose(_totals(particulator)[1], mass0, rtol=1e-6)
    assert _totals(particulator)[0] > 1e8 * 2**10
    assert float(np.sum(particulator.get_counter("breakup_rate"))) > 0


def test_collision_mixed_coalescence_breakup():
    dyn = Collision(
        collision_kernel=Geometric(), coalescence_efficiency=ConstEc(Ec=0.5),
        breakup_efficiency=ConstEb(Eb=1.0), fragmentation_function=AlwaysN(n=2),
        adaptive=False, substeps=1,
    )
    particulator, mass0 = _run_box(dyn, n_sd=2**10, steps=20)
    np.testing.assert_allclose(_totals(particulator)[1], mass0, rtol=1e-6)
    assert float(np.sum(particulator.get_counter("coalescence_rate"))) > 0
    assert float(np.sum(particulator.get_counter("breakup_rate"))) > 0
    assert (particulator.attributes["multiplicity"] >= 0).all()


class _CustomFragmentation:
    """a fragmentation function K5 has no body for"""

    required_attributes = ("water mass",)

    def register(self, builder):
        pass


def _breakup(**kwargs):
    return Collision(
        collision_kernel=Geometric(), coalescence_efficiency=ConstEc(0.5),
        breakup_efficiency=ConstEb(1.0),
        fragmentation_function=kwargs.pop("frag", AlwaysN(2)), **kwargs,
    )


@pytest.mark.parametrize(
    "changes, handle_all_breakups, u01_injection, match",
    (
        ({"frag": _CustomFragmentation()}, False, False, "no body in K5"),
        ({}, True, False, "handle_all_breakups"),
        ({"croupier": "sort"}, False, False, "sort croupier"),
        ({"adaptive": False}, False, True, "sort croupier"),
    ),
    ids=("function", "handle_all_breakups", "croupier-sort", "u01-injection"),
)
def test_register_refuses_what_k5_does_not_run(
    changes, handle_all_breakups, u01_injection, match
):
    """breakup runs only where the JAX package takes K5; the rest needs its
    float64 breakup path, which is not ported"""
    formulae = pysdm_tpu_torch.Formulae(handle_all_breakups=handle_all_breakups)
    builder = pysdm_tpu_torch.Builder(
        n_sd=64, backend=CPU(formulae), environment=Box(dt=1.0, dv=1.0)
    )
    if u01_injection:
        builder.enable_u01_injection()
    builder.add_dynamic(_breakup(**changes))
    with pytest.raises(NotImplementedError, match=match):
        builder.build({
            "multiplicity": np.full(64, 100), "volume": np.full(64, 1e-15),
        })


def test_geometric_still_has_no_k1_body():
    """coalescence alone on the mirror croupier: K1 evaluates Geometric in
    its body since the geometric kernels came into it, so the box builds;
    a kernel K1 has no body for (one without a ``kernel_id``, as the JAX
    package's ``Parameterized`` kernels would be) is still refused"""

    class NoBody(Geometric):
        kernel_id = None

    for kernel, refused in ((Geometric(), False), (NoBody(), True)):
        builder = pysdm_tpu_torch.Builder(
            n_sd=64, backend=CPU(), environment=Box(dt=1.0, dv=1.0)
        )
        builder.add_dynamic(Coalescence(collision_kernel=kernel))
        build = functools.partial(builder.build, {
            "multiplicity": np.full(64, 100), "volume": np.full(64, 1e-15),
        })
        if refused:
            with pytest.raises(NotImplementedError, match="has no K1 body"):
                build()
        else:
            build().run(1)


def _config2_builder(n_sd):
    s = port_model.Settings0D()
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(s.formulae), environment=Box(dv=s.dv, dt=s.dt)
    )
    builder.add_dynamic(Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder, attributes


def test_rate_products_read_and_reset():
    """a rate product returns the counter since its last read and resets
    it; the returned array does not change with the state; product names
    are unique"""
    from pysdm_tpu_torch.products import (
        BreakupRateDeficitPerGridbox,
        BreakupRatePerGridbox,
        CollisionRatePerGridbox,
    )

    builder, attributes = _config2_builder(2**9)
    p = builder.build(attributes, (
        CollisionRatePerGridbox(), BreakupRatePerGridbox(name="br"),
        BreakupRateDeficitPerGridbox(),
    ))
    assert sorted(p.products) == ["br", "breakup_rate_deficit", "collision_rate"]
    p.run(3)
    first = p.products["collision_rate"].get()
    kept = first.copy()
    assert first.shape == (1,) and first[0] > 0
    p.run(1)
    np.testing.assert_array_equal(first, kept)
    second = p.products["collision_rate"].get()
    assert 0 < second[0] < first[0]
    assert p.products["br"].get()[0] > 0
    builder, attributes = _config2_builder(2**9)
    with pytest.raises(ValueError, match="duplicate"):
        builder.build(attributes, (CollisionRatePerGridbox(),) * 2)
