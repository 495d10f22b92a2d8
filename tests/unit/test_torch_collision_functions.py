"""The collision kernels K1 has no body for (``Parameterized``,
``Hydrodynamic``, ``Electric``) and the Low and List 1982 fragmentation's
branches, against the JAX package in float64, and the cases of
``tests/unit/test_breakup_ops.py``'s ``TestLowList1982Nf`` on the port.

Tolerances: rtol 1e-12 (the same float64 operations; pow, exp, log and erf
may round an ulp apart between XLA and torch), and atol the smallest normal
float64 where a result underflows (XLA's CPU backend flushes subnormal
results to zero). The functions are where-selections over every branch;
the inputs reach each branch, which the tests check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import erf as jax_erf

from pysdm_tpu.dynamics.collisions import breakup_fragmentations as jax_frag
from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.physics import Formulae as JaxFormulae
from pysdm_tpu_torch.dynamics.collisions import breakup_fragmentations as port_frag
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as port_kernels
from pysdm_tpu_torch.physics import Formulae as PortFormulae

TINY = np.finfo(np.float64).tiny


def _close(got, expected):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), rtol=1e-12, atol=TINY
    )


def _drops(seed, n=4096, r_min=1e-6, r_max=3e-3):
    """pairs of drops (radius log-uniform, fall velocities near Gunn and
    Kinzer's, jittered; some with equal radii) and u01 draws"""
    rng = np.random.default_rng(seed)
    r = np.exp(rng.uniform(np.log(r_min), np.log(r_max), (2, n)))
    r[1, :16] = r[0, :16]
    v = np.minimum(9.0, 8e3 * r) * rng.uniform(0.8, 1.2, (2, n))
    attrs = [
        {
            "radius": r[i], "volume": 4 / 3 * np.pi * r[i] ** 3,
            "water mass": 4 / 3 * np.pi * r[i] ** 3 * 1e3,
            "relative fall velocity": v[i],
        }
        for i in (0, 1)
    ]
    return attrs, rng.uniform(size=n)


def _both(attrs):
    """the attribute dicts as JAX and as torch arrays"""
    return (
        [{k: jnp.asarray(v) for k, v in a.items()} for a in attrs],
        [{k: torch.from_numpy(v) for k, v in a.items()} for a in attrs],
    )


KERNELS = {
    "Hydrodynamic": (jax_kernels.Hydrodynamic(), port_kernels.Hydrodynamic()),
    "Electric": (jax_kernels.Electric(), port_kernels.Electric()),
    "Parameterized": (
        jax_kernels.Parameterized(
            (1, 1, -20, 1.7, -40, 1.8, 10, 1.2, 12, 1, 0.002, 4, 8)
        ),
        port_kernels.Parameterized(
            (1, 1, -20, 1.7, -40, 1.8, 10, 1.2, 12, 1, 0.002, 4, 8)
        ),
    ),
}


@pytest.mark.parametrize("name", KERNELS)
def test_berry_kernels_match_jax_package(name):
    """the Berry 1967 kernels over drops of 1 um to 3 mm, equal radii
    included; no ``kernel_id``: the mirror croupier runs them on K1a"""
    jax_kernel, port_kernel = KERNELS[name]
    (j_a, j_b), (t_a, t_b) = _both(_drops(len(name))[0])
    expected = jax_kernel.pairwise(JaxFormulae(), j_a, j_b)
    got = port_kernel.pairwise(PortFormulae(), t_a, t_b)
    assert got.dtype == torch.float64
    _close(got.numpy(), expected)
    assert (got.numpy() > 0).mean() > 0.3 and (got.numpy()[:16] == 0).all()
    assert not hasattr(port_kernel, "kernel_id")
    assert port_kernel.required_attributes == ("radius", "relative fall velocity")


def _ll82_inputs(seed, n=4096):
    """diameters in cm (0.01 to 0.6 cm, the small one below the large),
    collision energies 1e-9 to 1e-4 J, Weber numbers 0.1 to 10, surface
    energies: with the degenerate exits of f3 and d2 among them"""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(0.01, 0.6, n)
    ds = dl * rng.uniform(0.05, 1.0, n)
    CKE = 10.0 ** rng.uniform(-9, -4, n)
    dcoal = (dl**3 + ds**3) ** (1 / 3)
    W1 = 10.0 ** rng.uniform(-1, 1, n)
    St = np.pi * 0.072 * ((ds / 100) ** 2 + (dl / 100) ** 2)
    return {"dl": dl, "ds": ds, "dcoal": dcoal, "CKE": CKE, "W1": W1, "St": St}


LL82_HELPERS = {
    "f1": ("dl", "dcoal"),
    "f2": ("ds",),
    "f3": ("ds", "dl"),
    "s1": ("dl", "ds", "dcoal"),
    "s2": ("dl", "ds", "St"),
    "d1": ("W1", "dl", "dcoal", "CKE"),
    "d2": ("ds", "dl", "CKE"),
}


@pytest.mark.parametrize("mode", LL82_HELPERS)
def test_ll82_modes_match_jax_package(mode):
    """each Low-List mode's (H, mu, sigma) in float64, to rtol 1e-10: the
    sigma of s2 and d2 goes through ten fixed-point iterations of erf, exp
    and log, which carry an ulp apart between XLA and torch into ~4e-12
    (the whole fragmentation function holds 1e-12, below); the dead lanes
    of f3 and d2 (sigma -> 0, H -> 0) are selected as in the JAX package.
    f3 has both kinds of lanes here; every d2 lane dies in both packages
    on these inputs"""
    inputs = _ll82_inputs(len(mode))
    names = LL82_HELPERS[mode]
    jax_fn = getattr(jax_frag, f"_ll82_{mode}")
    port_fn = getattr(port_frag, f"_ll82_{mode}")
    jax_args = [jnp.asarray(inputs[name]) for name in names]
    if mode != "f2":
        jax_args = [jax_erf] + jax_args
    expected = jax_fn(*jax_args)
    got = port_fn(*(torch.from_numpy(inputs[name]) for name in names))
    for g, e in zip(got, expected):
        g, e = g.numpy(), np.asarray(e)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(e))
        np.testing.assert_allclose(
            g[np.isfinite(g)], e[np.isfinite(e)], rtol=1e-10, atol=TINY
        )
    if mode in ("f3", "d2"):
        dead = got[0].numpy() == 0.0
        assert dead.sum() > 0 and (mode == "d2" or not dead.all())


def _ll82_regimes(attrs, u01):
    """the fractions of pairs in the small-drop exit and in the filament,
    sheet and disk regimes (reference ``ll82_Nr``), in numpy"""
    a, b = attrs
    dl = 2 * np.maximum(a["radius"], b["radius"])
    ds = 2 * np.minimum(a["radius"], b["radius"])
    total = a["volume"] + b["volume"]
    Sc = np.pi * 0.072 * (6 / np.pi) ** (2 / 3) * total ** (2 / 3)
    St = np.pi * 0.072 * (ds**2 + dl**2)
    CKE = np.maximum(
        1e3 / 2 * (a["volume"] * b["volume"] / total)
        * (a["relative fall velocity"] - b["relative fall velocity"]) ** 2,
        1e-300,
    )
    Rf = np.where(CKE >= 0.893e-6, 1.11e-4 * CKE ** (-0.654), 1.0)
    Rs = np.where(
        CKE / Sc >= 0.86, 0.685 * (1 - np.exp(-1.63 * (CKE / St - 0.86))), 0.0
    )
    big = dl > 0.4e-3
    return {
        "small": (~big).mean(),
        "filament": (big & (u01 <= Rf)).mean(),
        "sheet": (big & (u01 > Rf) & (u01 <= Rf + Rs)).mean(),
        "disk": (big & (u01 > Rf + Rs)).mean(),
    }


def test_lowlist_1982_every_branch_matches_jax_package():
    """LowList1982Nf over pairs that reach the small-drop exit and each of
    the filament, sheet and disk regimes: (n_fragment, fragment mass) in
    float64 as the JAX package's, finite, mass-conserving"""
    attrs, u01 = _drops(82, n=8192, r_min=1e-4, r_max=3e-3)
    # fast large drops against slow small ones: the energies of sheets and
    # disks
    attrs[0]["relative fall velocity"][:4096] *= 3.0
    regimes = _ll82_regimes(attrs, u01)
    assert min(regimes.values()) > 0.01, regimes
    (j_a, j_b), (t_a, t_b) = _both(attrs)
    jax_fn = jax_frag.LowList1982Nf(nfmax=1e4)
    port_fn = port_frag.LowList1982Nf(nfmax=1e4)
    expected = jax_fn.pairwise(JaxFormulae(), j_a, j_b, jnp.asarray(u01))
    got = port_fn.pairwise(PortFormulae(), t_a, t_b, torch.from_numpy(u01))
    for g, e in zip(got, expected):
        _close(g.numpy(), e)
        assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(
        got[0].numpy() * got[1].numpy(),
        (attrs[0]["volume"] + attrs[1]["volume"]) * 1e3, rtol=1e-9,
    )


class TestLowList1982Nf:
    @staticmethod
    def test_mass_conservation_and_finiteness():
        """LL82 fragment sampling (reference ``lowlist82.py`` +
        ``_ll82_fragmentation_body``): nf * fragment_mass == pair mass, all
        outputs finite, nfmax honoured"""
        frag = port_frag.LowList1982Nf(nfmax=1e4)
        n = 256
        rng = np.random.default_rng(5)
        ra = torch.from_numpy(rng.uniform(0.3e-3, 1.5e-3, n))
        rb = torch.from_numpy(rng.uniform(0.1e-3, 1.0e-3, n))
        va = 4 / 3 * np.pi * ra**3
        vb = 4 / 3 * np.pi * rb**3
        attrs_a = {
            "volume": va, "radius": ra, "water mass": va * 1e3,
            "relative fall velocity": torch.from_numpy(rng.uniform(4.0, 9.0, n)),
        }
        attrs_b = {
            "volume": vb, "radius": rb, "water mass": vb * 1e3,
            "relative fall velocity": torch.from_numpy(rng.uniform(1.0, 5.0, n)),
        }
        u01 = torch.from_numpy(rng.uniform(0, 1, n))
        nf, fmass = frag.pairwise(PortFormulae(), attrs_a, attrs_b, u01)
        nf, fmass = nf.numpy(), fmass.numpy()
        assert np.isfinite(nf).all() and np.isfinite(fmass).all()
        assert (nf >= 1 - 1e-9).all() and (nf <= 1e4 + 1e-6).all()
        np.testing.assert_allclose(nf * fmass, (va + vb).numpy() * 1e3, rtol=1e-6)

    @staticmethod
    def test_small_drops_coalesce():
        """pairs below the 0.4 mm large-drop threshold produce a single
        coalesced fragment (reference ``_ll82_fragmentation_body``, first
        branch)"""
        r = torch.tensor([50e-6, 20e-6], dtype=torch.float64)
        v = 4 / 3 * np.pi * r**3

        def attrs(rr, vv):
            return {
                "volume": vv, "radius": rr, "water mass": vv * 1e3,
                "relative fall velocity": torch.tensor([1.0, 0.3]).double(),
            }

        nf, _ = port_frag.LowList1982Nf().pairwise(
            PortFormulae(), attrs(r, v),
            attrs(torch.roll(r, -1), torch.roll(v, -1)),
            torch.tensor([0.5, 0.5], dtype=torch.float64),
        )
        np.testing.assert_allclose(nf.numpy(), 1.0, rtol=1e-9)
