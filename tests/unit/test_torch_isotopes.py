"""The port's isotope physics against the JAX package, in float64 on the
CPU: every function of every variant of the eight isotope families (one
case per variant and function) on tensors and on NumPy arrays, the
"+"-composition of variants, the isotope trivia, the "delta_*" and "moles
light water" attributes, ``IsotopicFractionation``'s wiring, and the JAX
package's ``tests/unit/test_isotopes.py`` replayed on the port.

Tolerance: rtol 1e-12. Both packages evaluate the same expressions in the
same order; XLA's and torch's (or NumPy's) exp, log and pow may differ by
an ulp.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
from pysdm_tpu.backends import CPU as JaxCPU
from pysdm_tpu.dynamics import Condensation as JaxCondensation
from pysdm_tpu.dynamics import IsotopicFractionation as JaxIsotopicFractionation
from pysdm_tpu.environments import Box as JaxBox
from pysdm_tpu.physics import isotopes as jax_isotopes

import pysdm_tpu_torch
from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Condensation, IsotopicFractionation
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.physics import si

RTOL = 1e-12
N = 12
_rng = np.random.default_rng(20261017)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u(lo, hi):
    return _rng.uniform(lo, hi, N)


# each formula argument by name, over the range the isotope models use
ARGUMENTS = {
    "T": _u(230.0, 310.0),
    "temperature": _u(230.0, 310.0),
    "_": np.full(N, np.nan),
    "alpha_l_18O": _u(1.005, 1.02),
    "relative_humidity": _u(0.0, 1.0),
    "turbulence_parameter_n": _u(0.5, 1.0),
    "delta_diff": _u(0.01, 0.05),
    "theta": _u(0.5, 1.0),
    "alpha_equilibrium": _u(1.0, 1.2),
    "saturation": _u(1.0, 1.4),
    "D_ratio_heavy_to_light": _u(0.97, 0.99),
    "delta_17O": _u(-0.05, 0.01),
    "delta_18O": _u(-0.1, 0.02),
    "delta_2H": _u(-0.4, 0.0),
    "alpha": _u(1.0, 1.1),
    "d_alpha": _u(-1e-5, 1e-5),
    "n_vapour": _u(1e-3, 2e-2),
    "d_n_vapour": _u(-1e-5, 0.0),
    "n_liquid": _u(1e-4, 1e-3),
    "X_over_X0": _u(0.05, 1.0),
    "a": _u(1.0, 1.1),
    "diff_rat": _u(1.0, 1.03),
    "iso_ratio_x": _u(1e-4, 2e-4),
    "iso_ratio_r": _u(1e-4, 2e-4),
    "iso_ratio_v": _u(1e-4, 2e-4),
    "b": _u(0.5, 3.0),
    "alpha_w": _u(1.0, 1.1),
    "dm_dt_over_m": _u(1e-3, 1.0),
    "rho_s": _u(3e-3, 3e-2),
    "radius": np.exp(_u(np.log(1e-5), np.log(2e-3))),
    "D_iso": _u(2e-5, 3e-5),
    "D": _u(2e-5, 3e-5),
    "S": _u(0.5, 1.0),
    "R_liq": _u(0.9, 1.1),
    "R_vap": _u(0.9, 1.1),
    "Fk": _u(1e8, 1e10),
    "ventilation_coefficient": _u(1.0, 10.0),
    "diffusivity_ratio": _u(0.97, 1.03),
}

FAMILIES = {
    "isotope_equilibrium_fractionation_factors": "EQUILIBRIUM_VARIANTS",
    "isotope_kinetic_fractionation_factors": "KINETIC_VARIANTS",
    "isotope_diffusivity_ratios": "DIFFUSIVITY_RATIO_VARIANTS",
    "isotope_meteoric_water_line": "MWL_VARIANTS",
    "isotope_ratio_evolution": "RATIO_EVOLUTION_VARIANTS",
    "isotope_relaxation_timescale": "RELAXATION_TIMESCALE_VARIANTS",
    "isotope_temperature_inference": "TEMPERATURE_INFERENCE_VARIANTS",
    "isotope_ventilation_ratio": "VENTILATION_RATIO_VARIANTS",
}
CASES = [
    (family, variant, name)
    for family, table in FAMILIES.items()
    for variant, cls in getattr(jax_isotopes, table).items()
    for name in dir(cls)
    if not name.startswith("_")
]


def _call(package, family, variant, name, wrap):
    """``package``'s bound formula on the arguments its signature names"""
    fn = getattr(getattr(package.Formulae(**{family: variant}), family), name)
    cls = getattr(jax_isotopes, FAMILIES[family])[variant]
    params = list(inspect.signature(getattr(cls, name)).parameters.values())
    args = [wrap(ARGUMENTS[p.name]) for p in params[1:]
            if p.kind is not p.KEYWORD_ONLY]
    kwargs = {p.name: wrap(ARGUMENTS[p.name]) for p in params[1:]
              if p.kind is p.KEYWORD_ONLY}
    return fn(*args, **kwargs)


def test_every_isotope_variant_is_bound_as_in_the_jax_package():
    from pysdm_tpu.physics import formulae as jax_formulae
    from pysdm_tpu_torch.physics import formulae

    for family in FAMILIES:
        assert (set(formulae._FAMILIES[family][0])
                == set(jax_formulae._FAMILIES[family][0])), family
        assert formulae._FAMILIES[family][1] == jax_formulae._FAMILIES[family][1]
        assert (getattr(Formulae(), family).variant
                == getattr(pysdm_tpu.Formulae(), family).variant)
    assert len({(f, v) for f, v, _ in CASES}) == 26


@pytest.mark.parametrize(
    "family, variant, name", CASES,
    ids=[f"{v}.{n}" for _, v, n in CASES],
)
def test_isotope_formula_matches_jax_package(family, variant, name):
    want = np.asarray(_call(pysdm_tpu, family, variant, name, jnp.asarray))
    got = _call(pysdm_tpu_torch, family, variant, name, torch.from_numpy)
    on_numpy = _call(pysdm_tpu_torch, family, variant, name, np.asarray)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.float64
        got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(on_numpy, want, rtol=RTOL, atol=0)


ISOTOPE_TRIVIA = (
    ("isotopic_delta_2_ratio", (_u(-0.5, 0.1), 1.5e-4)),
    ("isotopic_ratio_2_delta", (_u(1e-4, 3e-3), 2.0e-3)),
    ("isotopic_enrichment_to_delta_SMOW", (_u(-0.1, 0.1), -0.01)),
)


@pytest.mark.parametrize("name, args", ISOTOPE_TRIVIA,
                         ids=[t[0] for t in ISOTOPE_TRIVIA])
def test_isotope_trivia_matches_jax_package(name, args):
    want = getattr(pysdm_tpu.Formulae().trivia, name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    got = getattr(Formulae().trivia, name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_formulae_plus_composition():
    """``test_isotope_papers.py::test_formulae_plus_composition`` on the
    port, against the JAX package (the JAX test itself is replayed on the
    port in ``test_torch_isotope_models.py``)"""
    name = "HoritaAndWesolowski1994+BarkanAndLuz2005"
    fam = Formulae(
        isotope_equilibrium_fractionation_factors=name
    ).isotope_equilibrium_fractionation_factors
    assert fam.variant == name
    a18 = float(fam.alpha_l_18O(283.15))
    assert 1.0 < a18 < 1.02
    a17 = float(fam.alpha_l_17O(np.nan, a18))
    assert 1.0 < a17 < a18
    jax_fam = pysdm_tpu.Formulae(
        isotope_equilibrium_fractionation_factors=name
    ).isotope_equilibrium_fractionation_factors
    np.testing.assert_allclose(a17, float(jax_fam.alpha_l_17O(np.nan, a18)),
                               rtol=RTOL)


def _isotope_box(package, n_sd=6):
    """a box of drops holding every isotope's moles, in either package"""
    rng = np.random.default_rng(3)
    if package == "jax":
        formulae, box, builder, backend = (
            pysdm_tpu.Formulae(seed=3), JaxBox, pysdm_tpu.Builder, JaxCPU
        )
    else:
        formulae, box, builder, backend = Formulae(seed=3), Box, Builder, CPU
    const = formulae.constants
    mass = rng.uniform(1e-15, 1e-9, n_sd)
    moles_water = mass / (2 * const.M_1H + const.M_16O)
    attributes = {
        "multiplicity": np.ones(n_sd),
        "water mass": mass,
        "moles_1H": 2 * moles_water,
        "moles_16O": moles_water,
    }
    for heavy in ("2H", "3H", "17O", "18O"):
        light = "moles_1H" if heavy.endswith("H") else "moles_16O"
        attributes[f"moles_{heavy}"] = (
            attributes[light] * getattr(const, f"VSMOW_R_{heavy}")
            * (1 + rng.uniform(-0.3, 0.05, n_sd))
        )
    b = builder(n_sd=n_sd, backend=backend(formulae),
                environment=box(dt=1 * si.s, dv=1 * si.m**3))
    return b.build(attributes)


@pytest.mark.parametrize(
    "name", ("delta_2H", "delta_3H", "delta_17O", "delta_18O",
             "moles light water")
)
def test_isotope_attributes_match_jax_package(name):
    got = _isotope_box("torch").attributes[name]
    want = _isotope_box("jax").attributes[name]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got.shape == (6,)


def test_isotopic_fractionation_wiring_as_in_the_jax_package():
    """Condensation must come first; the dynamic requests the heavy
    isotopes' moles; its step leaves the state as it is"""
    for package, box, cls, condensation in (
        (pysdm_tpu, JaxBox, JaxIsotopicFractionation, JaxCondensation),
        (pysdm_tpu_torch, Box, IsotopicFractionation, Condensation),
    ):
        backend = JaxCPU if package is pysdm_tpu else CPU
        builder = package.Builder(
            n_sd=2, backend=backend(package.Formulae()),
            environment=box(dt=1.0, dv=1.0),
        )
        builder.add_dynamic(cls())
        builder.add_dynamic(condensation())
        with pytest.raises(AssertionError, match="Condensation needs"):
            builder.particulator.dynamics["IsotopicFractionation"].register(
                builder
            )
    builder = Builder(n_sd=2, backend=CPU(Formulae()),
                      environment=Box(dt=1.0, dv=1.0))
    builder.add_dynamic(Condensation())
    dynamic = IsotopicFractionation()
    builder.add_dynamic(dynamic)
    dynamic.register(builder)
    for heavy in ("2H", "3H", "17O", "18O"):
        assert f"moles_{heavy}" in builder.requested_attributes
    sim = {"particles": object()}
    assert dynamic.make_step(builder.particulator)(sim) is sim


# -- tests/unit/test_isotopes.py on the port ----------------------------------


def test_equilibrium_fractionation_factors_sane():
    f = Formulae(
        isotope_equilibrium_fractionation_factors="HoritaAndWesolowski1994",
    )
    T = torch.tensor([273.15, 293.15, 313.15], dtype=torch.float64)
    a18 = f.isotope_equilibrium_fractionation_factors.alpha_l_18O(T).numpy()
    a2 = f.isotope_equilibrium_fractionation_factors.alpha_l_2H(T).numpy()
    assert (a18 > 1).all() and (np.diff(a18) < 0).all()
    assert (a2 > 1).all() and (np.diff(a2) < 0).all()
    np.testing.assert_allclose(a18[1], 1.0098, atol=5e-4)
    np.testing.assert_allclose(a2[1], 1.085, atol=5e-3)


def test_majoube_1971_at_0C():
    f = Formulae(isotope_equilibrium_fractionation_factors="Majoube1971")
    a18 = float(f.isotope_equilibrium_fractionation_factors.alpha_l_18O(273.15))
    np.testing.assert_allclose(a18, 1.0117, atol=5e-4)


def test_diffusivity_ratios():
    for variant, expected_2H in (
        ("Stewart1975", 0.984),
        ("HellmannAndHarvey2020", 0.9755),
    ):
        f = Formulae(isotope_diffusivity_ratios=variant)
        r = float(f.isotope_diffusivity_ratios.ratio_2H_heavy_to_light(293.15))
        assert 0.95 < r < 1.0, f"{variant}: {r}"
        np.testing.assert_allclose(r, expected_2H, atol=5e-3)


def test_meteoric_water_line_roundtrip():
    f = Formulae(isotope_meteoric_water_line="Dansgaard1964")
    d18O = -10e-3
    d2H = f.constants.CRAIG_1961_SLOPE_COEFF * d18O + (
        f.constants.CRAIG_1961_INTERCEPT_COEFF
    )
    excess = float(f.isotope_meteoric_water_line.excess_d(d2H, d18O))
    np.testing.assert_allclose(excess, f.constants.CRAIG_1961_INTERCEPT_COEFF)


def test_rayleigh_distillation():
    f = Formulae(isotope_ratio_evolution="RayleighDistillation")
    out = float(f.isotope_ratio_evolution.R_over_R0(0.5, 1.01))
    np.testing.assert_allclose(out, 0.5**0.01)


def test_delta_attribute_roundtrip():
    f = Formulae(seed=3)
    n_sd = 4
    builder = Builder(n_sd=n_sd, backend=CPU(f),
                      environment=Box(dt=1 * si.s, dv=1 * si.m**3))
    delta_in = np.asarray([-0.1, -0.05, 0.0, 0.1])
    moles_1H = np.full(n_sd, 1.0)
    attributes = {
        "multiplicity": np.ones(n_sd),
        "water mass": np.full(n_sd, 1e-12),
        "moles_1H": moles_1H,
        "moles_2H": (1 + delta_in) * f.constants.VSMOW_R_2H * moles_1H,
    }
    p = builder.build(attributes)
    np.testing.assert_allclose(p.attributes["delta_2H"], delta_in, rtol=1e-12)
