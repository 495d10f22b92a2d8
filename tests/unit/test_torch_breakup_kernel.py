"""The port's breakup kernel module (``pysdm_tpu_torch/ops/cuda/breakup.py``)
against the JAX package's TPU kernel ``fused_breakup_mirror_blocks`` run in
interpret mode on the CPU, and its functions against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch twin (the CUDA kernel
runs only on the card; ``test_torch_cuda_breakup.py`` holds it against the
twin there). Tolerances, twin against the Pallas kernel:
- multiplicities equal at every slot that did not break up. The breakup
  transfer runs in float32 through exp, log and log1p, whose CPU
  implementations in XLA and in torch differ by an ulp on ~10% of
  arguments; at breakup slots the multiplicities hold the JAX package's own
  bound (``tests/unit/test_pallas_breakup.py:118-126``): within rel 1e-4 on
  > 99.9% of the slots (measured: all slots within 9e-5, 99.2% equal);
- extensive rows to rtol 1e-6 where the multiplicities agree (measured
  2.3e-7: a float32 ulp or two through the rescale);
- the five rate sums to rtol 1e-5 (another summation order; measured
  4.8e-7); total water mass conserved to 5e-6 (the JAX test's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.dynamics.collisions import breakup_efficiencies as jax_eb
from pysdm_tpu.dynamics.collisions import breakup_fragmentations as jax_frag
from pysdm_tpu.dynamics.collisions import coalescence_efficiencies as jax_ec
from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.ops.pallas.breakup import (
    _fragmentation_limiters_f32,
    fused_breakup_mirror_blocks,
)
from pysdm_tpu.physics import Formulae as JaxFormulae
from pysdm_tpu_torch.dynamics.collisions import breakup_efficiencies as port_eb
from pysdm_tpu_torch.dynamics.collisions import breakup_fragmentations as port_frag
from pysdm_tpu_torch.dynamics.collisions import coalescence_efficiencies as port_ec
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as port_kernels
from pysdm_tpu_torch.ops.cuda import breakup as port
from pysdm_tpu_torch.ops.cuda import collision as port_collision
from pysdm_tpu_torch.physics import Formulae as PortFormulae

N = 4096
BLOCK_R = 8  # N % (BLOCK_R * 128) == 0: the blocks kernel's geometry
MAX_MULTIPLICITY = 2**63 // int(2e5)
FRAG_SCALE = 4 / 3 * np.pi * (100e-6) ** 3


def _function_set(name):
    """(JAX functions, port functions, attribute names): config #2's set,
    one that bounces and coalesces too, or that one with SimpleGeometric"""
    if name == "config2":
        jax_set = (
            jax_kernels.Geometric(), jax_ec.Berry1967(), jax_eb.ConstEb(1.0),
            jax_frag.Exponential(scale=FRAG_SCALE),
        )
        port_set = (
            port_kernels.Geometric(), port_ec.Berry1967(), port_eb.ConstEb(1.0),
            port_frag.Exponential(scale=FRAG_SCALE),
        )
        return jax_set, port_set, ("radius", "relative fall velocity")
    if name == "simplegeometric":
        jax_set = (
            jax_kernels.SimpleGeometric(C=2e3), jax_ec.ConstEc(0.5),
            jax_eb.ConstEb(0.5), jax_frag.AlwaysN(4),
        )
        port_set = (
            port_kernels.SimpleGeometric(C=2e3), port_ec.ConstEc(0.5),
            port_eb.ConstEb(0.5), port_frag.AlwaysN(4),
        )
        return jax_set, port_set, ("area", "radius")
    jax_set = (
        jax_kernels.ConstantK(a=1e-9), jax_ec.ConstEc(0.5), jax_eb.ConstEb(0.5),
        jax_frag.AlwaysN(4),
    )
    port_set = (
        port_kernels.ConstantK(a=1e-9), port_ec.ConstEc(0.5),
        port_eb.ConstEb(0.5), port_frag.AlwaysN(4),
    )
    return jax_set, port_set, ("volume",)


def _state(seed, K, big, n_ext, ext_dtype):
    """multiplicities up to 2^40 with 5% ties with the partner (big) or up
    to 2^30, dead slots; radii 10-500 um; water mass and tracer rows; a
    monotone stand-in fall velocity (as the JAX test)"""
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40 if big else 2**30, size=N).astype(np.int64)
    if big:
        partner = (K - np.arange(N)) % N
        tie = rng.uniform(size=N) < 0.05
        mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=N) < (0.05 if big else 0.03)] = 0
    r = np.exp(rng.uniform(np.log(10e-6), np.log(500e-6), N))
    volume = 4 / 3 * np.pi * r**3
    ext = np.concatenate(
        [volume[None, :] * 1e3, rng.uniform(1e-18, 1e-16, (n_ext - 1, N))]
    ).astype(ext_dtype)
    attrs = {
        "radius": r, "relative fall velocity": (r / 50e-6) ** 0.5 * 4.0,
        "volume": volume, "area": 4 * np.pi * r**2,
    }
    return mult, ext, attrs


def _run_both(mult, ext, attrs, names, jax_set, port_set, scale, K, seed):
    formulae = JaxFormulae(seed=1, fragmentation_function="Exponential")
    kernel, ec, eb, frag = jax_set
    expected = fused_breakup_mirror_blocks(
        jnp.asarray(mult), jnp.asarray(ext), 0,
        jnp.stack([jnp.asarray(attrs[name]) for name in names]), names,
        lambda a, b: kernel.pairwise(formulae, a, b),
        lambda a, b: ec.pairwise(formulae, a, b),
        lambda a, b: eb.pairwise(formulae, a, b),
        lambda a, b, u: frag.pairwise(formulae, a, b, u)[1],
        scale, K, jnp.uint32(seed), MAX_MULTIPLICITY,
        block_r=BLOCK_R, interpret=True,
    )
    processes = {}
    got = port.coalesce_breakup_mirror_reference(
        torch.from_numpy(mult), torch.from_numpy(ext), 0,
        {
            name: torch.from_numpy(attrs[name].astype(np.float32))
            for name in names
        },
        port.PairFunctions.of(*port_set),
        torch.tensor([scale], dtype=torch.float32), K, seed, MAX_MULTIPLICITY,
        processes=processes,
    )
    return (
        [np.asarray(x) for x in expected], [x.numpy() for x in got],
        {k: v.numpy() for k, v in processes.items()},
    )


CASES = (
    # functions, seed, big multiplicities and ties, extensive rows, dtype
    ("config2", 0, False, 1, np.float64),
    ("config2", 5, True, 2, np.float32),
    ("mixed", 1, False, 1, np.float64),
    ("mixed", 7, True, 2, np.float32),
    ("simplegeometric", 3, True, 2, np.float32),
)


@pytest.mark.parametrize(
    "functions, seed, big, n_ext, ext_dtype", CASES,
    ids=[f"{c[0]}-{c[1]}-{'big' if c[2] else 'small'}" for c in CASES],
)
def test_twin_matches_pallas_kernel(functions, seed, big, n_ext, ext_dtype):
    K = int(np.random.default_rng(seed).integers(0, N))
    mult, ext, attrs = _state(seed, K, big, n_ext, ext_dtype)
    jax_set, port_set, names = _function_set(functions)
    # config #2: the JAX test's scale; the mixed set: the median pair near
    # one expected collision
    scale = 5e8 if functions == "config2" else float(
        1 / (np.median(mult[mult > 0]) * 1e-9)
    )
    expected, got, processes = _run_both(
        mult, ext, attrs, names, jax_set, port_set, scale, K, 17 + seed
    )
    broke = processes["breakup"]
    assert broke.sum() > 20 and processes["coalescence"].sum() > 20
    same = got[0] == expected[0]
    assert (same | broke).all()
    rel = np.abs(got[0] - expected[0].astype(float)) / np.maximum(
        np.maximum(got[0], expected[0]), 1
    )
    assert (rel < 1e-4).mean() > 0.999, rel.max()
    assert 0.05 < (got[0] != mult).mean() < 0.95
    assert got[1].dtype == ext_dtype
    np.testing.assert_allclose(got[1][:, same], expected[1][:, same], rtol=1e-6)
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e, rtol=1e-5)
    water0 = float((mult * ext[0].astype(float)).sum())
    water = float((got[0] * got[1][0].astype(float)).sum())
    np.testing.assert_allclose(water, water0, rtol=5e-6)


def test_extensive_rows_pass_through_float32():
    """reference behaviour, kept: the TPU kernel rounds every extensive row
    to float32 on every substep, at slots with no event too, and hands it
    back in the state's dtype (``pysdm_tpu/ops/pallas/breakup.py:370,449``);
    with a zero scale no pair collides and only that rounding is left"""
    mult, ext, attrs = _state(3, 11, False, 2, np.float64)
    jax_set, port_set, names = _function_set("config2")
    expected, got, _ = _run_both(
        mult, ext, attrs, names, jax_set, port_set, 0.0, 11, 3
    )
    rounded = ext.astype(np.float32).astype(np.float64)
    assert not np.array_equal(rounded, ext)
    np.testing.assert_array_equal(got[0], mult)
    np.testing.assert_array_equal(got[1], rounded)
    np.testing.assert_array_equal(expected[1], rounded)


def test_large_quotient_regime_port_is_exact():
    """floor(xi_j/xi_k) between ~2^26 and the cap: the TPU kernel's f32
    quotient estimate is off by more than its 5 correction steps, so its
    gamma misses the exact floor (ROADMAP.md, queue 3). The port divides in
    int64 and is exact; pairs that always coalesce show it as K1's test
    does"""
    pairs = (
        (1057166230302, 4467),  # estimate 15 above the floor
        (1067892856719, 1973),  # estimate 28 above the floor
        (623967171686, 5461),  # estimate 7 below the floor
    )
    K = 101
    mult = np.zeros(N, np.int64)
    for i, (mj, mk) in enumerate(pairs):
        mult[10 + i], mult[K - 10 - i] = mj, mk
    ext = np.full((1, N), 1e-12)
    attrs = {"volume": np.full(N, 1e-12)}
    jax_set = (
        jax_kernels.ConstantK(a=1e-9), jax_ec.ConstEc(1.0), jax_eb.ConstEb(0.0),
        jax_frag.AlwaysN(2),
    )
    port_set = (
        port_kernels.ConstantK(a=1e-9), port_ec.ConstEc(1.0),
        port_eb.ConstEb(0.0), port_frag.AlwaysN(2),
    )
    # gamma_f far above every quotient: the cap 2^31 - 128 binds, then the
    # multiplicity ratio
    expected, got, processes = _run_both(
        mult, ext, attrs, ("volume",), jax_set, port_set, 1e15, K, 5
    )
    assert not processes["breakup"].any()
    for i, (mj, mk) in enumerate(pairs):
        assert got[0][10 + i] == mj - (mj // mk) * mk
        assert got[0][K - 10 - i] == mk
    assert (got[0] != expected[0]).any()
    assert (got[0] >= 0).all()


def loop_oracle(gamma, mult_j, mult_k, mass_j, mass_k, fm, max_mult):
    """event-by-event transfer semantics (``tests/unit/test_breakup_ops.py``
    ``loop_oracle``; de Jong et al. 2023): each of up to ``gamma`` events
    turns the pair's mass into fragments of mass ``fm``, bounded by j's
    multiplicity and the multiplicity cap"""
    take_test = mult_k
    take = 0.0
    nmk_test = (mass_j + mass_k) / fm * mult_k
    nmk = mult_k
    gjk = 0
    for m in range(int(gamma)):
        if nmk_test > max_mult or take_test > mult_j:
            break
        take = take_test
        nmk = nmk_test
        gjk = m + 1
        take_test += nmk_test
        nmk_test = nmk_test * (mass_j / fm) + nmk_test
    return take, nmk, gjk


@pytest.mark.parametrize("seed", range(3))
def test_transfer_f32_matches_loop(seed):
    """the float32 closed form against the float64 per-event loop (the JAX
    test's inputs): the event count equal, take and new xi_k to rtol 2e-6
    (log-space rounding grows with the event count; measured 5.9e-7)"""
    rng = np.random.default_rng(seed)
    n = 256
    gamma = rng.integers(0, 50, n).astype(float)
    mult_k = rng.integers(1, 10**6, n).astype(float)
    mult_j = mult_k * rng.integers(1, 100, n)
    mass_k = 10.0 ** rng.uniform(-15, -9, n)
    mass_j = mass_k * rng.uniform(1, 100, n)
    fm = (mass_j + mass_k) * 10.0 ** rng.uniform(-3, 0, n)
    max_mult = 2**63 / 2e5
    take, nmk, gjk = port.transfer_closed_form_f32(*(
        torch.tensor(x, dtype=torch.float32)
        for x in (gamma, mult_j, mult_k, mass_j, mass_k, fm, max_mult)
    ))
    oracle = np.array([
        loop_oracle(*args, max_mult)
        for args in zip(gamma, mult_j, mult_k, mass_j, mass_k, fm)
    ])
    np.testing.assert_array_equal(gjk.numpy(), oracle[:, 2])
    np.testing.assert_allclose(take.numpy(), oracle[:, 0], rtol=2e-6)
    np.testing.assert_allclose(nmk.numpy(), oracle[:, 1], rtol=2e-6)


def test_fragmentation_limiters_f32_match_pallas_helper():
    frag = np.array([np.nan, 0.0, -1.0, 5.0, 0.5, 2.0], np.float32)
    mass_sum = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    expected = np.asarray(
        _fragmentation_limiters_f32(jnp.asarray(frag), jnp.asarray(mass_sum))
    )
    got = port.fragmentation_limiters_f32(
        torch.from_numpy(frag), torch.from_numpy(mass_sum)
    ).numpy()
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, [1.0, 1.0, 1.0, 1.0, 0.5, 1.0])


def _pair_attrs(seed, n=512):
    rng = np.random.default_rng(seed)
    r = np.exp(rng.uniform(np.log(1e-6), np.log(2e-3), (2, n)))
    r[1, :8] = r[0, :8]  # equal radii: p = 1
    return [
        {
            "radius": r[i], "volume": 4 / 3 * np.pi * r[i] ** 3,
            "water mass": 4 / 3 * np.pi * r[i] ** 3 * 1e3,
        }
        for i in (0, 1)
    ], rng.uniform(size=n)


FUNCTIONS = {
    "Berry1967": (jax_ec.Berry1967(), port_ec.Berry1967()),
    "ConstEc": (jax_ec.ConstEc(0.3), port_ec.ConstEc(0.3)),
    "ConstEb": (jax_eb.ConstEb(0.7), port_eb.ConstEb(0.7)),
    "AlwaysN": (jax_frag.AlwaysN(5), port_frag.AlwaysN(5)),
    "ConstantMass": (jax_frag.ConstantMass(1e-9), port_frag.ConstantMass(1e-9)),
    "Exponential": (
        jax_frag.Exponential(FRAG_SCALE), port_frag.Exponential(FRAG_SCALE)
    ),
    "Exponential-vmin-nfmax": (
        jax_frag.Exponential(FRAG_SCALE, vmin=1e-13, nfmax=20),
        port_frag.Exponential(FRAG_SCALE, vmin=1e-13, nfmax=20),
    ),
    "ExponFrag": (jax_frag.ExponFrag(FRAG_SCALE), port_frag.ExponFrag(FRAG_SCALE)),
}


@pytest.mark.parametrize("name", FUNCTIONS)
def test_functions_match_jax_package(name):
    """each function of K5's set in float64, as the port's dynamics evaluate
    it outside the kernel, against the JAX package's (rtol 1e-13: libm
    ulps in pow and log)"""
    jax_fn, port_fn = FUNCTIONS[name]
    (attrs_a, attrs_b), u01 = _pair_attrs(len(name))

    def call(fn, wrap, formulae):
        a = {k: wrap(v) for k, v in attrs_a.items()}
        b = {k: wrap(v) for k, v in attrs_b.items()}
        if name.startswith(("Berry", "Const")) and "Mass" not in name:
            return [fn.pairwise(formulae, a, b)]
        return list(fn.pairwise(formulae, a, b, wrap(u01)))

    expected = call(jax_fn, jnp.asarray, JaxFormulae())
    got = call(port_fn, torch.from_numpy, PortFormulae())
    got = [g.numpy() if isinstance(g, torch.Tensor) else g for g in got]
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-13)
    if name == "Berry1967":
        assert 0 <= got[0].min() and got[0].max() <= 1 and got[0].max() > 0


def test_apply_limiters_matches_jax_package():
    rng = np.random.default_rng(0)
    total = rng.uniform(1, 2, 64)
    frag = total * rng.uniform(-0.5, 1.5, 64)
    frag[:4] = np.nan
    for kwargs in ({}, {"vmin": 0.3}, {"vmin": 0.1, "nfmax": 4}):
        expected = jax_frag.apply_limiters(
            jnp.asarray(frag), jnp.asarray(total), **kwargs
        )
        got = port_frag.apply_limiters(
            torch.from_numpy(frag), torch.from_numpy(total), **kwargs
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def _drop_pairs(seed, n=2048):
    """pairs of drops of 1 um to 3 mm radius with fall velocities near
    Gunn and Kinzer's (up to 9 m/s, jittered), some with equal radii, and
    their u01 draws: slow and fast pairs, large and small drops, every
    regime of the Straub and Low-List functions"""
    rng = np.random.default_rng(seed)
    r = np.exp(rng.uniform(np.log(1e-6), np.log(3e-3), (2, n)))
    r[1, :16] = r[0, :16]
    v = np.minimum(9.0, 8e3 * r) * rng.uniform(0.8, 1.2, (2, n))
    return [
        {
            "radius": r[i], "volume": 4 / 3 * np.pi * r[i] ** 3,
            "water mass": 4 / 3 * np.pi * r[i] ** 3 * 1e3,
            "relative fall velocity": v[i],
        }
        for i in (0, 1)
    ], rng.uniform(size=n)


# the functions K5 has no body for: a collision with them takes the float64
# breakup path (``ops/breakup.py``)
FLOAT64_PATH_FUNCTIONS = {
    "SpecifiedEff": lambda m: m.SpecifiedEff(A=0.7),
    "Straub2010Ec": lambda m: m.Straub2010Ec(),
    "LowList1982Ec": lambda m: m.LowList1982Ec(),
    "Gaussian": lambda m: m.Gaussian(
        mu=FRAG_SCALE, sigma=FRAG_SCALE / 2, vmin=1e-15, nfmax=50
    ),
    "Feingold1988": lambda m: m.Feingold1988(
        scale=FRAG_SCALE, fragtol=1e-3, vmin=1e-15, nfmax=10
    ),
    "LowList1982Nf": lambda m: m.LowList1982Nf(nfmax=1e4),
    "SLAMS": lambda m: m.SLAMS(vmin=1e-15, nfmax=12),
    "Straub2010Nf": lambda m: m.Straub2010Nf(vmin=(1e-6) ** 3, nfmax=100),
}


@pytest.mark.parametrize(
    "cls",
    (
        port_ec.SpecifiedEff, port_ec.Straub2010Ec, port_ec.LowList1982Ec,
        port_frag.Gaussian, port_frag.Feingold1988, port_frag.LowList1982Nf,
        port_frag.SLAMS, port_frag.Straub2010Nf,
    ),
)
def test_functions_outside_k5_raise(cls):
    """the functions K5 has no body for, which raised on construction
    before the float64 breakup path was ported: each now builds, registers
    no ``kernel_id`` (so the dynamics take the float64 path) and its
    ``pairwise`` in float64 matches the JAX package's at rtol 1e-12 on
    pairs across every regime (and atol the smallest normal float64: XLA's
    CPU backend flushes subnormal results to zero, torch keeps them, as in
    LowList1982Ec's exp of a large collision energy)"""
    name = cls.__name__
    port_fn = FLOAT64_PATH_FUNCTIONS[name](
        port_ec if cls.__module__ == port_ec.__name__ else port_frag
    )
    jax_fn = FLOAT64_PATH_FUNCTIONS[name](
        jax_ec if cls.__module__ == port_ec.__name__ else jax_frag
    )
    assert isinstance(port_fn, cls) and not hasattr(port_fn, "kernel_id")
    (attrs_a, attrs_b), u01 = _drop_pairs(len(name))

    def call(fn, wrap, formulae):
        a = {k: wrap(v) for k, v in attrs_a.items()}
        b = {k: wrap(v) for k, v in attrs_b.items()}
        if name.endswith(("Eff", "Ec")):
            return [fn.pairwise(formulae, a, b)]
        return list(fn.pairwise(formulae, a, b, wrap(u01)))

    expected = call(jax_fn, jnp.asarray, JaxFormulae())
    got = [g.numpy() for g in call(port_fn, torch.from_numpy, PortFormulae())]
    for g, e in zip(got, expected):
        assert g.dtype == np.float64
        np.testing.assert_allclose(
            g, np.asarray(e), rtol=1e-12, atol=np.finfo(np.float64).tiny
        )
        assert np.isfinite(g).all()
    if name.endswith("Nf") or name in ("Gaussian", "Feingold1988", "SLAMS"):
        n_fragment, mass = got
        total = attrs_a["water mass"] + attrs_b["water mass"]
        np.testing.assert_allclose(n_fragment * mass, total, rtol=1e-9)
        assert (n_fragment > 1.5).any()


def _wrapper_args(**changes):
    mult, ext, attrs = _state(0, 5, False, 1, np.float32)
    args = {
        "mult": torch.from_numpy(mult), "ext": torch.from_numpy(ext),
        "wm_index": 0,
        "attrs": {"volume": torch.from_numpy(attrs["volume"].astype(np.float32))},
        "functions": port.PairFunctions.of(*_function_set("mixed")[1]),
        "scale": torch.tensor([1.0], dtype=torch.float32), "K": 5, "seed": 1,
        "max_multiplicity": MAX_MULTIPLICITY,
    }
    args.update(changes)
    return args


@pytest.mark.parametrize(
    "changes, error",
    (
        ({"mult": torch.zeros(N, dtype=torch.int32)}, TypeError),
        ({"ext": torch.zeros((1, N), dtype=torch.float16)}, TypeError),
        ({"wm_index": 1}, ValueError),
        ({"attrs": {}}, ValueError),
        ({"attrs": {"volume": torch.zeros(N, dtype=torch.float64)}}, TypeError),
        ({"scale": torch.tensor([1.0])[None]}, TypeError),
        ({"K": N}, ValueError),
        ({"seed": 2**32}, ValueError),
    ),
    ids=("mult", "ext", "wm_index", "attrs", "attr_dtype", "scale", "K", "seed"),
)
def test_wrapper_refuses_bad_input(changes, error):
    with pytest.raises(error):
        port.coalesce_breakup_mirror(**_wrapper_args(**changes))


def test_wrapper_takes_the_twin_on_the_cpu():
    args = _wrapper_args()
    before = port.coalesce_breakup_mirror.launches
    got = port.coalesce_breakup_mirror(**args)
    want = port.coalesce_breakup_mirror_reference(**args)
    assert port.coalesce_breakup_mirror.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "params",
    (
        (1, 1, -27, 1.65, -58, 1.9, 15, 1.13, 16.7, 1, 0.004, 4, 8),
        (1, 1, -7, 1.78, -20.5, 1.73, 0.26, 1.47, 1, 0.82, -0.003, 4.4, 8),
    ),
    ids=("hydrodynamic", "electric"),
)
def test_berry_1967_fit_matches_jax_package(params):
    """the fit beside K1a's twin in ``ops/cuda/collision.py`` (the one
    ``Parameterized.pairwise`` and K5's ``Berry1967`` Ec take), float64,
    with Berry's hydrodynamic and electric-field parameters (rtol 1e-13:
    libm ulps in pow)"""
    (attrs_a, attrs_b), _ = _pair_attrs(1)
    r_big = np.maximum(attrs_a["radius"], attrs_b["radius"])
    r_small = np.minimum(attrs_a["radius"], attrs_b["radius"])
    expected = jax_kernels.berry_1967_linear_collection_efficiency(
        params, jnp.asarray(r_big), jnp.asarray(r_small)
    )
    got = port_collision.berry_1967_linear_collection_efficiency(
        params, torch.from_numpy(r_big), torch.from_numpy(r_small)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-13)
