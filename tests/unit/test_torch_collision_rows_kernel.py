"""K1a, the port's mirror coalescence with the kernel values given as rows
(``pysdm_tpu_torch/ops/cuda/collision.py`` ``coalesce_mirror_rows``),
against the JAX package's TPU kernel ``fused_coalesce_mirror`` run in
interpret mode on the CPU.

On the CPU the wrapper takes its plain PyTorch twin
(``coalesce_mirror_rows_reference``); the CUDA kernel runs only on the card,
where ``test_torch_cuda_kernel.py`` holds it against the twin. Both sides
take the same float32 kernel x norm and u01 rows. Tolerances:
multiplicities bit-equal; extensive rows bit-equal where each row's value is
a multiple of 2^-40 below 2^-28 (exact products and sums in float32, like
the volumes of 1-40 um drops), and exact on arbitrary floats in another
sense: XLA's CPU backend, which runs the interpreted TPU kernel here,
contracts e_k + gamma e_j into one fused multiply-add, where the twin and
the CUDA kernel round the product and the sum apart (one slot in a hundred
differs by an ulp), so every slot where the two differ is a merged slot,
the Pallas value there is fma(gamma, e_j, e_k) rounded once and the twin's
is round(round(gamma e_j) + e_k), each computed exactly from the pair's
gamma (read off the multiplicities, which are bit-equal); rate sums to
rtol 1e-5, since the float32 sums run in another order. The draws keep gamma's cap below 2^26
wherever the quotient xi_j / xi_k binds, where the TPU kernel's quotient
walk is exact (ROADMAP, "large-quotient gamma").

K1a's Parameterized form (``coalesce_mirror_parameterized``), which
evaluates the Berry 1967 kernels in its body, is held the same way: its
twin on float64 radius and fall-velocity rows against the Pallas kernel fed
the JAX package's ``Hydrodynamic`` and ``Electric`` values (its
``Parameterized.pairwise`` in float64, times the scale, cast to float32),
with the same bounds; and the Collision dynamic takes it in Berry 1967's
non-adaptive substep, K1a with the values given in the adaptive one.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.ops.pairing import MirrorPairing as JaxMirrorPairing
from pysdm_tpu.ops.pallas.collision import fused_coalesce_mirror
from pysdm_tpu_torch.dynamics.collisions import collision as port_collision
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as port_kernels
from pysdm_tpu_torch.models import berry_1967
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.ops.cuda import collision as port


def _state(n, K, n_ext, ext_dtype, seed, big=False, dyadic=True):
    """a random single-cell state: 5% dead slots, 5% ties with the partner,
    multiplicities up to 2^40 (big) or 1000; extensive rows of 1e-12 to
    1e-9, multiples of 2^-40 (dyadic) or arbitrary floats; kernel x norm
    rows that give up to ~8 collisions a pair, u01 rows"""
    rng = np.random.default_rng(seed)
    top = 2**40 if big else 1000
    mult = rng.integers(1, top, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, size=(n_ext, n))
    if dyadic:
        ext = np.round(ext * 2.0**40) * 2.0**-40
    ext = ext.astype(ext_dtype)
    kernnorm = (rng.uniform(0.0, 8.0, size=n) / top).astype(np.float32)
    u01 = rng.uniform(size=n).astype(np.float32)
    return mult, ext, kernnorm, u01


def _run_both(mult, ext, kernnorm, u01, K):
    n = mult.shape[0]
    pairing = JaxMirrorPairing(K, n, jnp.asarray(mult > 0))
    expected = fused_coalesce_mirror(
        jnp.asarray(mult), jnp.asarray(ext), jnp.asarray(kernnorm),
        jnp.asarray(u01), pairing.is_first, pairing.shift, interpret=True,
    )
    got = port.coalesce_mirror_rows(
        torch.from_numpy(mult), torch.from_numpy(ext),
        torch.from_numpy(kernnorm), torch.from_numpy(u01), K,
    )
    return [np.asarray(x) for x in expected], [x.numpy() for x in got]


@pytest.mark.parametrize("n", (4096, 1000))
@pytest.mark.parametrize("K_of", ("zero", "odd", "last"))
@pytest.mark.parametrize("n_ext", (1, 3))
@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
def test_twin_bit_equal_to_pallas_kernel(n, K_of, n_ext, ext_dtype):
    K = {"zero": 0, "odd": 777, "last": n - 1}[K_of]
    mult, ext, kernnorm, u01 = _state(n, K, n_ext, ext_dtype, seed=n + K)
    expected, got = _run_both(mult, ext, kernnorm, u01, K)
    np.testing.assert_array_equal(got[0], expected[0])
    assert got[1].dtype == ext_dtype
    np.testing.assert_array_equal(got[1], expected[1])
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e.sum(dtype=np.float32), rtol=1e-5)
    assert (got[0] != mult).sum() > n // 20
    assert got[2] > 0  # the collision rate


def _merged_slot(mult, mult_new, K, s):
    """(gamma, j, k) of slot ``s``'s pair, gamma read off the multiplicities
    before (``mult``) and after (``mult_new``): j - gamma k, or the split
    of k in halves where j - gamma k = 0"""
    n = mult.shape[0]
    po = (K - s) % n
    a, b = int(mult[s]), int(mult[po])
    a_is_j = a >= b if po > s else a > b
    j, k = (s, po) if a_is_j else (po, s)
    mj, mk = int(mult[j]), int(mult[k])
    nj, nk = int(mult_new[j]), int(mult_new[k])
    if mj % mk == 0 and (nj, nk) == (mk // 2, mk - mk // 2):
        return mj // mk, j, k
    assert nk == mk and (mj - nj) % mk == 0, (s, mj, mk, nj, nk)
    return (mj - nj) // mk, j, k


@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
@pytest.mark.parametrize("n", (4096, 1000))
def test_twin_within_one_rounding_on_arbitrary_rows(n, ext_dtype):
    """the two differ only where the Pallas kernel fuses gamma e_j + e_k"""
    K = 321
    mult, ext, kernnorm, u01 = _state(
        n, K, 2, ext_dtype, seed=n, dyadic=False
    )
    expected, got = _run_both(mult, ext, kernnorm, u01, K)
    np.testing.assert_array_equal(got[0], expected[0])
    rows, slots = np.nonzero(got[1] != expected[1])
    for r, s in zip(rows, slots):
        gamma, j, k = _merged_slot(mult, got[0], K, s)
        assert gamma > 0 and s in (j, k)
        ej, ek = ext[r, j], ext[r, k]
        exact = Fraction(gamma) * Fraction(float(ej)) + Fraction(float(ek))
        fused = float(exact)
        # in float64 a float32 fma is exact, so the cast rounds once
        assert ext_dtype == np.float64 or Fraction(fused) == exact
        assert expected[1][r, s] == ext_dtype(fused), (r, s)
        assert got[1][r, s] == ext_dtype(gamma) * ej + ek, (r, s)


@pytest.mark.parametrize("K", (0, 4095))
def test_twin_bit_equal_with_multiplicities_up_to_2_40(K):
    mult, ext, kernnorm, u01 = _state(4096, K, 2, np.float32, seed=K, big=True)
    expected, got = _run_both(mult, ext, kernnorm, u01, K)
    np.testing.assert_array_equal(got[0], expected[0])
    np.testing.assert_array_equal(got[1], expected[1])
    assert (got[0] != mult).sum() > 100


def test_twin_conserves_extensive_content():
    """sum(xi * ext) is conserved exactly in float64 rows"""
    n, K = 4096, 1234
    mult, ext, kernnorm, u01 = _state(n, K, 2, np.float64, seed=3)
    _, got = _run_both(mult, ext, kernnorm, u01, K)
    before = (mult * ext).sum(axis=1)
    after = (got[0] * got[1]).sum(axis=1)
    np.testing.assert_allclose(after, before, rtol=1e-12)
    assert (got[0] >= 0).all()


@pytest.mark.parametrize(
    "changes, error",
    (
        ({"mult": torch.zeros(8, dtype=torch.int32)}, TypeError),
        ({"ext": torch.zeros((1, 8), dtype=torch.float16)}, TypeError),
        ({"kernnorm": torch.zeros(8, dtype=torch.float64)}, TypeError),
        ({"u01": torch.zeros(7, dtype=torch.float32)}, TypeError),
        ({"K": 8}, ValueError),
    ),
    ids=("mult", "ext", "kernnorm", "u01", "K"),
)
def test_wrapper_checks_its_inputs(changes, error):
    args = {
        "mult": torch.ones(8, dtype=torch.int64),
        "ext": torch.ones((1, 8), dtype=torch.float32),
        "kernnorm": torch.ones(8, dtype=torch.float32),
        "u01": torch.ones(8, dtype=torch.float32),
        "K": 3,
    }
    args.update(changes)
    with pytest.raises(error):
        port.coalesce_mirror_rows(**args)


def test_launch_count_only_on_the_card():
    """the CPU twin leaves the launch count alone"""
    before = port.coalesce_mirror_rows.launches
    mult, ext, kernnorm, u01 = _state(64, 5, 1, np.float32, seed=1)
    port.coalesce_mirror_rows(
        torch.from_numpy(mult), torch.from_numpy(ext),
        torch.from_numpy(kernnorm), torch.from_numpy(u01), 5,
    )
    assert port.coalesce_mirror_rows.launches == before


# --- K1a's Parameterized form ------------------------------------------------
def _berry_rows(n, seed):
    """float64 radius and fall-velocity rows of cloud and rain drops: radii
    log-uniform over 1-300 um (2% dead at radius 0), fall velocities rising
    with the radius"""
    rng = np.random.default_rng(seed)
    radius = np.exp(rng.uniform(np.log(1e-6), np.log(300e-6), n))
    radius[rng.uniform(size=n) < 0.02] = 0.0
    fall = 8e3 * radius * rng.uniform(0.9, 1.1, n)
    return radius, fall


def _jax_kernnorm(kernel, radius, fall, scale, K):
    """the float32 kernel x norm row the JAX package makes for its Pallas
    K1a: ``Parameterized.pairwise`` in float64 at every slot's view of its
    pair, times the scale, cast to float32"""
    n = radius.shape[0]
    partner = (K - np.arange(n)) % n
    attrs = {"radius": jnp.asarray(radius), "relative fall velocity": jnp.asarray(fall)}
    attrs_b = {k: jnp.asarray(np.asarray(v)[partner]) for k, v in attrs.items()}
    values = np.asarray(getattr(jax_kernels, kernel)().pairwise(None, attrs, attrs_b))
    assert values.dtype == np.float64
    return (values * scale).astype(np.float32)


@pytest.mark.parametrize("kernel", ("Hydrodynamic", "Electric"))
@pytest.mark.parametrize("n", (4096, 1000))
@pytest.mark.parametrize("K_of", ("zero", "odd", "last"))
@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
def test_parameterized_twin_bit_equal_to_pallas_kernel(kernel, n, K_of,
                                                       ext_dtype):
    K = {"zero": 0, "odd": 777, "last": n - 1}[K_of]
    mult, ext, _, u01 = _state(n, K, 2, ext_dtype, seed=n + K + 1)
    radius, fall = _berry_rows(n, seed=n + K)
    # a scale that gives the median live pair ~2 collisions at xi ~ 500
    partner = (K - np.arange(n)) % n
    probe = _jax_kernnorm(kernel, radius, fall, 1.0, K).astype(np.float64)
    scale = 4.0 / (1000 * np.median(probe[(probe > 0) & (partner > np.arange(n))]))
    kernnorm = _jax_kernnorm(kernel, radius, fall, scale, K)
    pairing = JaxMirrorPairing(K, n, jnp.asarray(mult > 0))
    expected = [np.asarray(x) for x in fused_coalesce_mirror(
        jnp.asarray(mult), jnp.asarray(ext), jnp.asarray(kernnorm),
        jnp.asarray(u01), pairing.is_first, pairing.shift, interpret=True,
    )]
    launches = port.coalesce_mirror_parameterized.launches
    got = [x.numpy() for x in port.coalesce_mirror_parameterized(
        torch.from_numpy(mult), torch.from_numpy(ext),
        torch.from_numpy(radius), torch.from_numpy(fall),
        getattr(port_kernels, kernel)().params,
        torch.tensor([scale], dtype=torch.float64), torch.from_numpy(u01), K,
    )]
    assert port.coalesce_mirror_parameterized.launches == launches
    np.testing.assert_array_equal(got[0], expected[0])
    assert got[1].dtype == ext_dtype
    np.testing.assert_array_equal(got[1], expected[1])
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e.sum(dtype=np.float32), rtol=1e-5)
    assert (got[0] != mult).sum() > n // 50


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_parameterized_twin_is_the_rows_route(dtype):
    """the twin is the row the rows route made, then K1a's twin: the partner
    gathers, ``Parameterized.pairwise`` in the rows' dtype, times the scale,
    cast to float32"""
    n, K = 1000, 333
    mult, ext, _, u01 = _state(n, K, 2, np.float32, seed=5)
    radius, fall = (torch.from_numpy(r).to(dtype) for r in _berry_rows(n, 6))
    scale = torch.tensor([3e5], dtype=dtype)
    params = port_kernels.Electric().params
    po = torch.remainder(K - torch.arange(n), n)
    attrs = {"radius": radius, "relative fall velocity": fall}
    values = port_kernels.Electric().pairwise(
        None, attrs, {k: v[po] for k, v in attrs.items()}
    )
    want = port.coalesce_mirror_rows(
        torch.from_numpy(mult), torch.from_numpy(ext),
        (values * scale[0]).to(torch.float32), torch.from_numpy(u01), K,
    )
    got = port.coalesce_mirror_parameterized(
        torch.from_numpy(mult), torch.from_numpy(ext), radius, fall, params,
        scale, torch.from_numpy(u01), K,
    )
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "changes, error",
    (
        ({"fall": torch.zeros(8, dtype=torch.float32)}, TypeError),
        ({"scale": torch.zeros(1, dtype=torch.float32)}, TypeError),
        ({"radius": torch.zeros(8, dtype=torch.int64)}, TypeError),
        ({"u01": torch.zeros(8, dtype=torch.float64)}, TypeError),
        ({"params": (1,) * 12}, ValueError),
        ({"params": (1,) * 11 + (0, 8)}, ValueError),
        ({"fall": torch.zeros(8, dtype=torch.float64, device="meta")},
         ValueError),
    ),
    ids=("fall dtype", "scale dtype", "radius dtype", "u01", "12 params",
         "int exponent 0", "fall on meta"),
)
def test_parameterized_wrapper_checks_its_inputs(changes, error):
    args = {
        "mult": torch.ones(8, dtype=torch.int64),
        "ext": torch.ones((1, 8), dtype=torch.float32),
        "radius": torch.full((8,), 1e-5, dtype=torch.float64),
        "fall": torch.ones(8, dtype=torch.float64),
        "params": port_kernels.Hydrodynamic().params,
        "scale": torch.ones(1, dtype=torch.float64),
        "u01": torch.ones(8, dtype=torch.float32),
        "K": 3,
    }
    args.update(changes)
    with pytest.raises(error):
        port.coalesce_mirror_parameterized(**args)


def test_int_exponents_are_the_python_ints():
    """D2, E2, Mf and Mg go to the kernel as ints where ``_power`` squares
    them (Hydrodynamic's Mf 4 and Mg 8; Electric's Mg 8), else 0 (pow)"""
    assert port._int_exponents(port_kernels.Hydrodynamic().params) == [0, 0, 4, 8]
    assert port._int_exponents(port_kernels.Electric().params) == [0, 0, 0, 8]


@pytest.mark.parametrize("adaptive", (False, True))
def test_berry_substep_takes_the_parameterized_form_when_fixed(adaptive,
                                                               monkeypatch):
    """Berry 1967's box with Hydrodynamic: the fixed substep takes K1a's
    Parameterized form and reads no kernel values; the adaptive one, whose
    substep choice reads them, hands them to K1a as a row"""
    calls = {"parameterized": 0, "rows": 0, "pairwise": 0}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(port_collision, "coalesce_mirror_parameterized",
                        counting("parameterized",
                                 port_collision.coalesce_mirror_parameterized))
    monkeypatch.setattr(port_collision, "coalesce_mirror_rows",
                        counting("rows", port_collision.coalesce_mirror_rows))
    kernel = port_kernels.Hydrodynamic()
    monkeypatch.setattr(kernel, "pairwise", counting("pairwise", kernel.pairwise))
    settings = berry_1967.Settings(steps=[0, 3])
    settings.n_sd = 2**8
    settings.kernel = kernel
    settings.adaptive = adaptive
    _, p = berry_1967.run(settings, backend_class=CPU)
    dyn = p.dynamics["Collision"]
    assert dyn.route() == "rows"
    if adaptive:
        assert calls["parameterized"] == 0
        assert calls["rows"] == dyn.substeps_run >= 3
        assert calls["pairwise"] == calls["rows"]
    else:
        assert calls["parameterized"] == dyn.substeps_run == 3
        assert calls["rows"] == calls["pairwise"] == 0
