"""The port's general collision path as a whole against the JAX package on
the CPU: K1a (the mirror coalescence with kernel values as rows) under the
Berry 1967 box's ``Hydrodynamic`` and ``Electric`` kernels, the float64
breakup path under the Straub 2010 and Bieli 2022 boxes, on the sort
croupier and under u01 injection, and the boxes of
``tests/smoke/test_box_breakup.py`` at that test's bounds.

Both packages build the same state; the port draws what the JAX substeps
draw from the JAX key chain (``Collision._draw_mirror`` and
``Collision._draw_sorted`` replaced by a replay of ``jax.random.split(key,
5)``: K or the shuffle bits from ``k_sh``, the gamma, process and fragment
rows from ``k_gam``, ``k_proc`` and ``k_frag``), or both take the same
injected u01 rows. Bounds: multiplicities equal at every step; extensive
rows to rtol 1e-12 (the same float64 operations on both sides); counters to
rtol 1e-6 of the sum over the cells (float32 sums in another order; a
per-cell sum is a difference of one float32 prefix over all the cells). For Berry 1967 the JAX package
runs its Pallas K1a in interpret mode (``PYSDM_TPU_PALLAS_INTERPRET=1``, as
on the TPU), on the same float32 kernel x norm and u01 rows as the port's
K1a twin; the extensive rows there hold rtol 1e-12 too, since a float64
row absorbs gamma e_j in one rounding either way.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
import pysdm_tpu.impl.mesh
from pysdm_tpu.dynamics.collisions import breakup_efficiencies as jax_eb
from pysdm_tpu.dynamics.collisions import breakup_fragmentations as jax_frag
from pysdm_tpu.dynamics.collisions import coalescence_efficiencies as jax_ec
from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.models import berry_1967 as jax_berry
from pysdm_tpu.models import bieli_et_al_2022 as jax_bieli
from pysdm_tpu.models import dejong_mackay_et_al_2023 as jax_dejong

import pysdm_tpu_torch
import pysdm_tpu_torch.impl.mesh
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics.collisions import breakup_efficiencies as port_eb
from pysdm_tpu_torch.dynamics.collisions import breakup_fragmentations as port_frag
from pysdm_tpu_torch.dynamics.collisions import coalescence_efficiencies as port_ec
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as port_kernels
from pysdm_tpu_torch.initialisation.sampling import spectral_sampling as port_sampling
from pysdm_tpu_torch.models import berry_1967 as port_berry
from pysdm_tpu_torch.models import bieli_et_al_2022 as port_bieli
from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as port_dejong
from pysdm_tpu_torch.ops import segments as port_seg
from pysdm_tpu_torch.physics import si

JAX = types.SimpleNamespace(
    pkg=pysdm_tpu, backend=pysdm_tpu.backends.CPU,
    dynamics=pysdm_tpu.dynamics, box=pysdm_tpu.environments.Box,
    mesh=pysdm_tpu.impl.mesh.Mesh, kernels=jax_kernels, ec=jax_ec,
    eb=jax_eb, frag=jax_frag, sampling=jax_sampling, berry=jax_berry,
    bieli=jax_bieli, dejong=jax_dejong,
)
PORT = types.SimpleNamespace(
    pkg=pysdm_tpu_torch, backend=CPU, dynamics=pysdm_tpu_torch.dynamics,
    box=pysdm_tpu_torch.environments.Box, mesh=pysdm_tpu_torch.impl.mesh.Mesh,
    kernels=port_kernels, ec=port_ec, eb=port_eb, frag=port_frag,
    sampling=port_sampling, berry=port_berry, bieli=port_bieli,
    dejong=port_dejong,
)
COUNTERS = (
    "collision_rate", "collision_rate_deficit", "coalescence_rate",
    "breakup_rate", "breakup_rate_deficit",
)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """eager torch on small tensors: one intra-op thread, so that the test
    workers running beside this one keep their cores (many threads per
    worker slow every small op down by orders of magnitude)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def replay_jax_draws(particulator, key):
    """the port draws what the JAX collision substeps draw from ``key`` on,
    on either croupier (under u01 injection both read the injected rows)"""
    state = {"key": key}
    collision = particulator.dynamics["Collision"]

    def chain(n_sd, n_rows):
        key, *subkeys = jax.random.split(state["key"], 5)
        state["key"] = key
        rows = [
            torch.from_numpy(np.array(
                jax.random.uniform(k, (n_sd,), dtype=jnp.float64)
            ))
            for k in subkeys[1 : 1 + n_rows]
        ]
        return subkeys[0], subkeys[1], rows

    def draw_mirror(n_sd, n_rows=0):
        k_sh, k_gam, rows = chain(n_sd, n_rows)
        K = jax.random.randint(k_sh, (), 0, n_sd, dtype=jnp.int32)
        return int(K), int(jax.random.bits(k_gam, (), jnp.uint32)), rows

    injected = collision._draw_sorted

    def draw_sorted(sim, n_rows):
        if collision.u01_injection:
            return injected(sim, n_rows)
        n_sd = particulator.n_sd
        k_sh, _, rows = chain(n_sd, n_rows)
        nbits = port_seg.rand_bits_for(particulator.mesh.n_cell)
        bits = np.asarray(jax.random.bits(k_sh, (n_sd,), jnp.uint32))
        return torch.from_numpy((bits >> (32 - nbits)).astype(np.int64)), rows

    collision._draw_mirror = draw_mirror
    collision._draw_sorted = draw_sorted


def _environment(lib, dt, dv, n_cell):
    """a box, or a row of ``n_cell`` boxes of volume ``dv`` each (a 1D
    mesh, which takes the sort croupier)"""
    env = lib.box(dt=dt, dv=dv)
    if n_cell > 1:
        register = env.register

        def register_cells(builder):
            register(builder)
            builder.particulator.mesh = lib.mesh(grid=(n_cell,), size=(n_cell * dv,))

        env.register = register_cells
    return env


def build_pair(dynamic_of, attributes, *, dt=1.0, dv=1.0, n_cell=1,
               inject=False, formulae=None):
    """(JAX particulator, port particulator) of one collision dynamic
    (``dynamic_of(lib)``) on the same attributes, the port replaying the
    JAX draws"""
    pair = []
    for lib in (JAX, PORT):
        builder = lib.pkg.Builder(
            n_sd=attributes["multiplicity"].shape[0],
            backend=lib.backend(lib.pkg.Formulae(**(formulae or {}))),
            environment=_environment(lib, dt, dv, n_cell),
        )
        if inject:
            builder.enable_u01_injection()
        builder.add_dynamic(dynamic_of(lib))
        pair.append(builder.build(dict(attributes)))
    replay_jax_draws(pair[1], pair[0].sim_state["key"])
    return pair


def assert_same(jp, tp, counters=COUNTERS):
    np.testing.assert_array_equal(
        tp.attributes["multiplicity"], np.asarray(jp.attributes["multiplicity"])
    )
    np.testing.assert_allclose(
        tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
        rtol=1e-12,
    )
    for name in counters:
        want = np.asarray(jp.get_counter(name), dtype=float)
        np.testing.assert_allclose(
            tp.get_counter(name), want, rtol=1e-6,
            atol=1e-6 * np.abs(want).sum(), err_msg=name,
        )


def totals(p):
    mult = np.asarray(p.attributes["multiplicity"])
    return float(mult.sum()), float((mult * p.attributes["water mass"]).sum())


# --- Berry 1967 on K1a --------------------------------------------------------
BERRY_N_SD = 2**12


def _berry_pair(kernel):
    attributes = {}
    settings = PORT.berry.Settings()
    attributes["volume"], attributes["multiplicity"] = (
        port_sampling.ConstantMultiplicity(settings.spectrum).sample(BERRY_N_SD)
    )
    return build_pair(
        lambda lib: lib.dynamics.Coalescence(
            collision_kernel=getattr(lib.kernels, kernel)(), adaptive=False
        ),
        attributes, dt=settings.dt, dv=settings.dv,
        formulae={"seed": 44, "terminal_velocity": "GunnKinzer1949"},
    )


@pytest.mark.parametrize("kernel", ("Hydrodynamic", "Electric"))
def test_berry_kernels_match_jax_package_step_by_step(kernel, monkeypatch):
    """Berry 1967's box at 2^12 with the Berry kernels: the JAX package
    takes its Pallas K1a, the port K1a's twin, on the same float32 rows;
    multiplicities equal at every one of 30 steps (for Hydrodynamic after
    its slow start: 300 steps)"""
    monkeypatch.setenv("PYSDM_TPU_PALLAS_INTERPRET", "1")
    jp, tp = _berry_pair(kernel)
    assert tp.dynamics["Collision"].route() == "rows"
    mult0 = tp.attributes["multiplicity"]
    steps = 300 if kernel == "Hydrodynamic" else 30
    for step in range(steps):
        jp.run(1)
        tp.run(1)
        if step % 10 == 9:
            assert_same(jp, tp, COUNTERS[:3])
    assert (tp.attributes["multiplicity"] != mult0).sum() > 10
    assert tp.dynamics["Collision"].substeps_run == steps


@pytest.mark.parametrize("kernel", ("Hydrodynamic", "Electric"))
def test_berry_model_runs_the_berry_kernels(kernel):
    """``berry_1967.run`` with ``settings.kernel`` set (the reference
    example's variants) at 2^11: the mean radius of dv/dlnr grows, one
    substep a step. Hydrodynamic's efficiency is zero for all but ~0.3% of
    the initial pairs, so it runs the example's full 1800 s"""
    end = 1800 if kernel == "Hydrodynamic" else 400
    settings = port_berry.Settings(steps=[0, end])
    settings.n_sd = 2**11
    settings.kernel = getattr(port_kernels, kernel)()
    vals, p = port_berry.run(settings, backend_class=CPU)
    r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
    mean_r = [(vals[s] * r_mid).sum() / vals[s].sum() for s in (0, end)]
    assert mean_r[1] > 1.05 * mean_r[0]
    assert p.dynamics["Collision"].substeps_run == end
    assert p.dynamics["Collision"].route() == "rows"


# --- the Straub 2010 box on the float64 breakup path --------------------------
def _straub_settings(lib, n_sd, handle_all=False):
    settings = lib.dejong.Settings0D(
        fragmentation=lib.frag.Straub2010Nf(vmin=(1 * si.um) ** 3, nfmax=100),
        warn_overflows=False,
    )
    settings.coal_eff = lib.ec.Straub2010Ec()
    settings.n_sd = n_sd
    if handle_all:
        settings.formulae = lib.pkg.Formulae(
            seed=settings.seed, fragmentation_function="Straub2010Nf",
            handle_all_breakups=True,
        )
    return settings


def _straub_pair(n_sd, handle_all=False, croupier=None):
    attributes = {}
    settings = _straub_settings(PORT, n_sd)
    attributes["volume"], attributes["multiplicity"] = (
        port_sampling.ConstantMultiplicity(settings.spectrum).sample(n_sd)
    )

    def dynamic_of(lib):
        s = _straub_settings(lib, n_sd)
        return lib.dynamics.Collision(
            collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
            breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
            adaptive=True, croupier=croupier,
        )

    return build_pair(
        dynamic_of, attributes, dv=settings.dv,
        formulae={
            "seed": 44, "fragmentation_function": "Straub2010Nf",
            "handle_all_breakups": handle_all,
        },
    )


@pytest.mark.parametrize(
    "handle_all, croupier", ((False, None), (True, None), (False, "sort")),
    ids=("closed-form", "handle_all_breakups", "croupier-sort"),
)
def test_straub_box_matches_jax_package(handle_all, croupier):
    """de Jong/Mackay 2023's box with Straub 2010's Ec and fragments at
    2^11, adaptive: both packages on their float64 breakup path, five steps
    equal slot by slot"""
    jp, tp = _straub_pair(2**11, handle_all, croupier)
    assert tp.dynamics["Collision"].route() == "float64"
    number0, water0 = totals(tp)
    for _ in range(5):
        jp.run(1)
        tp.run(1)
        assert_same(jp, tp)
    np.testing.assert_array_equal(
        tp.get_counter("collision_n_substep"), jp.get_counter("collision_n_substep")
    )
    number, water = totals(tp)
    np.testing.assert_allclose(water, water0, rtol=1e-9)
    assert number < number0 and tp.get_counter("coalescence_rate")[0] > 0
    # breakups are rare at this width: the mirror's draws break up within
    # these steps (the many-cell test below breaks up on the sort croupier)
    if croupier is None:
        assert tp.get_counter("breakup_rate")[0] > 0
    assert tp.dynamics["Collision"].host_reads >= 5


def test_straub_model_entry_point():
    """``run_box_breakup`` with the Straub configuration and
    ``handle_all_breakups``: rates reported, the liquid conserved"""
    for handle_all in (False, True):
        settings = _straub_settings(PORT, 2**10, handle_all)
        settings._steps = [0, 10]
        out = port_dejong.run_box_breakup(settings, backend_class=CPU)
        collision, _, coalescence, breakup = out.rates[-1]
        assert collision > 0 and coalescence > 0 and breakup > 0
        edges = settings.radius_bins_edges
        liquid = (out.y * np.diff(np.log(edges))).sum(axis=1)
        np.testing.assert_allclose(liquid, liquid[0], rtol=1e-9)
        assert out.core.dynamics["Collision"].route() == "float64"


# --- Bieli et al. 2022 ----------------------------------------------------------
@pytest.mark.parametrize("ec", (0.8, 0.9, 1.0))
def test_bieli_moments_match_jax_package_step_by_step(ec):
    """Bieli 2022's box at 2^10 (Golovin, Feingold 1988 fragments, Ec 0.8,
    0.9, 1.0): the three moments M0, M1, M2 at each of 30 steps to rtol
    1e-12, the multiplicities equal"""
    pair = []
    for lib in (JAX, PORT):
        settings = lib.bieli.Settings()
        settings.n_sd = 2**10
        pair.append(lib.bieli.make_core(
            settings, lib.ec.ConstEc(Ec=ec),
            **({"backend_class": CPU} if lib is PORT else {}),
        ))
    jp, tp = pair
    replay_jax_draws(tp, jp.sim_state["key"])
    moments = []
    for _ in range(30):
        jp.run(1)
        tp.run(1)
        np.testing.assert_array_equal(
            tp.attributes["multiplicity"],
            np.asarray(jp.attributes["multiplicity"]),
        )
        got = [float(tp.products[f"M{k}"].get().reshape(-1)[0]) for k in range(3)]
        want = [float(np.asarray(jp.products[f"M{k}"].get()).reshape(-1)[0])
                for k in range(3)]
        np.testing.assert_allclose(got, want, rtol=1e-12)
        moments.append(got)
    m0, m1 = np.array(moments)[:, 0], np.array(moments)[:, 1]
    assert m0[-1] < m0[0] if ec == 1.0 else m0[-1] != m0[0]
    np.testing.assert_allclose(m1, m1[0], rtol=1e-6)


def test_bieli_model_run():
    """``tests/smoke/test_models.py``'s Bieli test on the port: net
    coalescence lowers M0 at Ec = 1, volume conserved"""
    settings = port_bieli.Settings()
    settings.n_sd = 2**10
    settings._steps = [0, 30]
    out = port_bieli.run(settings, coal_eff=settings.coal_effs[2], backend_class=CPU)
    m0, m1 = np.asarray(out["M0"]), np.asarray(out["M1"])
    assert m0[-1] < m0[0]
    np.testing.assert_allclose(m1[-1], m1[0], rtol=1e-6)


# --- many cells, u01 injection --------------------------------------------------
@pytest.mark.parametrize("handle_all", (False, True))
def test_multi_cell_breakup_under_injection_matches_jax_package(handle_all):
    """config #2's functions on 4 cells x 64 super-droplets under u01
    injection (the sort croupier, the float64 path), five steps with fresh
    injected rows each"""
    n_cell, n_per = 4, 64
    n_sd = n_cell * n_per
    rng = np.random.default_rng(4)
    attributes = {
        "multiplicity": rng.integers(1, 10**6, n_sd).astype(float),
        "volume": 4 / 3 * np.pi * rng.uniform(5e-6, 500e-6, n_sd) ** 3,
        "cell id": np.repeat(np.arange(n_cell), n_per),
    }

    def dynamic_of(lib):
        return lib.dynamics.Collision(
            collision_kernel=lib.kernels.Geometric(),
            coalescence_efficiency=lib.ec.Berry1967(),
            breakup_efficiency=lib.eb.ConstEb(1.0),
            fragmentation_function=lib.frag.Exponential(
                scale=4 / 3 * np.pi * (100e-6) ** 3
            ),
            adaptive=False,
        )

    jp, tp = build_pair(
        dynamic_of, attributes, dv=1e-3, n_cell=n_cell, inject=True,
        formulae={"seed": 44, "handle_all_breakups": handle_all},
    )
    assert tp.dynamics["Collision"].route() == "float64"
    _, water0 = totals(tp)
    for _ in range(5):
        streams = {
            name: rng.uniform(size=n_sd)
            for name in (
                "collision_shuffle", "collision_gamma", "collision_process",
                "collision_fragmentation",
            )
        }
        jp.inject_u01(streams)
        tp.inject_u01(streams)
        jp.run(1)
        tp.run(1)
        assert_same(jp, tp)
    np.testing.assert_array_equal(
        tp.attributes["cell id"], np.asarray(jp.attributes["cell id"])
    )
    assert (tp.get_counter("breakup_rate") > 0).sum() >= 2
    np.testing.assert_allclose(totals(tp)[1], water0, rtol=1e-9)


# --- the boxes of tests/smoke/test_box_breakup.py -------------------------------
def run_box(dynamic, n_sd, steps, seed=44, dv=1 * si.m**3, formulae=None):
    """``tests/smoke/test_box_breakup.py:run_box`` on the port"""
    rng = np.random.default_rng(seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=CPU(formulae or pysdm_tpu_torch.Formulae(seed=seed)),
        environment=pysdm_tpu_torch.environments.Box(dt=1 * si.s, dv=dv),
    )
    builder.add_dynamic(dynamic)
    attributes = {
        "multiplicity": np.full(n_sd, 1e8),
        "volume": rng.uniform(0.5, 2.0, n_sd) * (20 * si.um) ** 3,
    }
    particulator = builder.build(attributes, products=())
    mass0 = totals(particulator)[1]
    particulator.run(steps)
    return particulator, mass0


def test_pure_breakup_with_handle_all_breakups():
    """``test_pure_breakup_grows_multiplicity_conserves_mass[True]``: the
    loop of ``handle_all_breakups`` on the float64 path over the JAX test's
    10 steps, the 10th of which loops 18,327 times (the loop reads its
    condition after each of its first 32 iterations and then about every
    32, so it runs a few idle iterations more and reads ~600 times)"""
    dyn = pysdm_tpu_torch.dynamics.Breakup(
        collision_kernel=port_kernels.ConstantK(a=1e-9 * si.m**3 / si.s),
        fragmentation_function=port_frag.AlwaysN(n=4), adaptive=False,
        substeps=1,
    )
    particulator, mass0 = run_box(
        dyn, n_sd=2**10, steps=10,
        formulae=pysdm_tpu_torch.Formulae(seed=44, handle_all_breakups=True),
    )
    assert dyn.route() == "float64" and dyn.breakup_iterations > 18_327
    assert 100 < dyn.host_reads < dyn.breakup_iterations / 16
    np.testing.assert_allclose(totals(particulator)[1], mass0, rtol=1e-6)
    assert totals(particulator)[0] > 1e8 * 2**10
    assert float(np.sum(particulator.get_counter("breakup_rate"))) > 0


def test_straub_2010_breakup_config():
    """config #2 analogue (de Jong & Mackay et al. 2023): Straub 2010
    coalescence efficiency and fragmentation"""
    dyn = pysdm_tpu_torch.dynamics.Collision(
        collision_kernel=port_kernels.Geometric(),
        coalescence_efficiency=port_ec.Straub2010Ec(),
        breakup_efficiency=port_eb.ConstEb(Eb=1.0),
        fragmentation_function=port_frag.Straub2010Nf(
            vmin=(1e-6) ** 3, nfmax=100
        ),
        adaptive=False, substeps=1,
    )
    particulator, mass0 = run_box(dyn, n_sd=2**12, steps=30, dv=0.1 * si.m**3)
    np.testing.assert_allclose(totals(particulator)[1], mass0, rtol=1e-6)
    assert float(np.sum(particulator.get_counter("coalescence_rate"))) > 0
    assert np.isfinite(particulator.attributes["water mass"]).all()
    assert (particulator.attributes["multiplicity"] >= 0).all()


@pytest.mark.parametrize("name", ("Feingold1988", "SLAMS"))
def test_feingold_and_slams_fragmentation_run(name):
    frag = (
        port_frag.Feingold1988(scale=(30 * si.um) ** 3 * 4.19)
        if name == "Feingold1988" else port_frag.SLAMS()
    )
    dyn = pysdm_tpu_torch.dynamics.Breakup(
        collision_kernel=port_kernels.ConstantK(a=1e-9 * si.m**3 / si.s),
        fragmentation_function=frag, adaptive=False, substeps=1,
    )
    particulator, mass0 = run_box(dyn, n_sd=2**9, steps=5)
    np.testing.assert_allclose(totals(particulator)[1], mass0, rtol=1e-6)
    mult = particulator.attributes["multiplicity"]
    assert (mult >= 0).all() and float(np.sum(mult)) > 0
    assert float(np.sum(particulator.get_counter("breakup_rate"))) > 0


def test_bieli_entry_points_default_to_the_card(monkeypatch):
    """without ``backend_class`` Bieli's ``run`` and ``make_core`` build on
    ``GPU``, which raises where torch sees no CUDA device"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = port_bieli.Settings()
    for call in (
        lambda: port_bieli.run(settings),
        lambda: port_bieli.make_core(settings, settings.coal_effs[0]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_general_collision_modules_leave_jax_out():
    """the modules of this path import neither JAX nor the JAX package"""
    import pathlib
    import subprocess
    import sys

    code = (
        "import sys, pysdm_tpu_torch.ops.breakup,"
        " pysdm_tpu_torch.ops.collisions,"
        " pysdm_tpu_torch.dynamics.collisions.collision,"
        " pysdm_tpu_torch.dynamics.collisions.breakup_fragmentations,"
        " pysdm_tpu_torch.dynamics.collisions.coalescence_efficiencies,"
        " pysdm_tpu_torch.models.bieli_et_al_2022;"
        " bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'pysdm_tpu')]; print(bad); assert not bad"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=pathlib.Path(__file__).resolve().parents[2],
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
