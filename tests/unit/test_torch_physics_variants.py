"""The rest of physics/ in the port against the JAX package: every variant
of the saturation vapour pressure, latent heat, diffusion thermics and
kinetics, surface tension, ventilation, hydrostatics, particle shape
(``PorousSpheroid``) and optical families, in float64 on the same
numpy-made inputs, over the ranges of ``tests/unit/test_physics_values.py``.

Tolerance: rtol 1e-12. Both packages evaluate the same expressions in the
same order; XLA's and torch's exp, log, pow and tanh may differ by an ulp.
Ruehl's isotherm is bisected 64 times on [1e-16, 1] in float64 by both, so
it is held at rtol 1e-12 too. ``CompressedFilmOvadnevaite`` subtracts the
volume inside the film, 4/3 pi (r - delta)^3, from the drop's: an ulp of
the cube root (XLA's and torch's pow differ by one) comes out r / (3 delta)
times larger, so its inputs keep r / delta below 2000, as the reference's
case in ``test_products_extended.py`` (1 um, 1 nm) does.

Then the JAX package's value checks of ``test_physics_values.py`` and the
surface-tension and dry-aerosol cases of ``test_products_extended.py``,
replayed on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu_torch
from pysdm_tpu_torch.initialisation.aerosol_composition import DryAerosolMixture
from pysdm_tpu_torch.physics import si

N = 16
T0C = 273.15
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


T = _u(T0C - 40, T0C + 40)
P = _u(6e4, 1.05e5)
R = np.exp(_u(np.log(2e-8), np.log(2e-4)))
D = _u(1e-5, 3e-5)
K = _u(0.02, 0.03)
R_DRY = np.exp(_u(np.log(2e-8), np.log(2e-7)))
V_DRY = 4 / 3 * np.pi * R_DRY**3
V_WET = 4 / 3 * np.pi * (R_DRY * np.exp(_u(np.log(1.2), np.log(2e-6 / R_DRY)))) ** 3
F_ORG = np.concatenate([[0.0, 1.0], _u(0.0, 1.0)[2:]])
X = _u(0.0, 10.0)

# film constants: Lowe et al. 2019's organic surface tension with the
# film thickness and the realistic Ruehl set of ``test_products_extended.py``
FILM = dict(
    sgm_org=40 * si.mN / si.m, delta_min=1 * si.nm,
    RUEHL_nu_org=7.47e-5, RUEHL_A0=2.5e-19, RUEHL_C0=1e-5,
    RUEHL_m_sigma=0.3e17, RUEHL_sgm_min=0.02,
)

CASES = (
    *(
        ("saturation_vapour_pressure", v, name, (T,), {})
        for v in ("AugustRocheMagnus", "Bolton1980", "FlatauWalkoCotton",
                  "Lowe1977", "MurphyKoop2005", "Wexler1976")
        for name in ("pvs_water", "pvs_ice")
    ),
    *(
        ("latent_heat_vapourisation", v, "lv", (T,), {})
        for v in ("Constant", "Kirchhoff", "SeinfeldPandis", "Lowe2019")
    ),
    *(
        ("diffusion_thermics", v, name, (T, P), {})
        for v in ("Neglect", "TracyWelchPorter", "SeinfeldAndPandis2010",
                  "LoweEtAl2019", "GrabowskiEtAl2011")
        for name in ("D", "K")
    ),
    *(
        ("diffusion_kinetics", v, name, args, {})
        for v in ("FuchsSutugin", "Neglect", "PruppacherKlett",
                  "GrabowskiEtAl2011", "LoweEtAl2019")
        for name, args in (
            ("lambdaD", (D, T)),
            ("lambdaK", (T, P)),
            ("D", (D, R, _u(5e-8, 2e-7))),
            ("K", (K, R, _u(5e-8, 2e-7))),
        )
    ),
    *(
        ("surface_tension", v, "sigma", (T, V_WET, V_DRY, F_ORG), FILM)
        for v in ("Constant", "CompressedFilmOvadnevaite",
                  "CompressedFilmRuehl", "SzyszkowskiLangmuir")
    ),
    *(
        ("ventilation", v, "ventilation_coefficient", (X,), {})
        for v in ("Neglect", "Froessling1938", "PruppacherAndRasmussen1979")
    ),
    ("hydrostatics", "VariableGIsothermal", "pressure",
     (_u(0.0, 5e4), P, T, _u(0.028, 0.044)),
     {"celestial_body_radius": 6.371e6}),
    *(
        ("particle_shape_and_density", "PorousSpheroid", name, args, {})
        for name, args in (
            ("aspect_ratio", (R, R * _u(0.5, 2.0))),
            ("equatorial_radius", (R, _u(0.2, 5.0))),
            ("polar_radius", (R, _u(0.2, 5.0))),
            ("eccentricity", (_u(1.0, 5.0),)),
        )
    ),
    ("optical_albedo", "Bohren1987", "albedo", (_u(0.0, 100.0),), {}),
    ("optical_depth", "Stephens1978", "tau",
     (_u(0.0, 0.5), _u(2e-6, 2e-5)), {}),
)


def _formulae(pkg, family, variant, constants):
    return getattr(pkg.Formulae(constants=constants, **{family: variant}), family)


@pytest.mark.parametrize(
    "family, variant, name, args, constants", CASES,
    ids=[f"{f}-{v}-{n}" for f, v, n, _, _ in CASES],
)
def test_variant_matches_jax_package(family, variant, name, args, constants):
    expected = np.asarray(getattr(_formulae(pysdm_tpu, family, variant, constants), name)(
        *(jnp.asarray(a) for a in args)
    ))
    port = getattr(_formulae(pysdm_tpu_torch, family, variant, constants), name)
    on_tensors = port(*(torch.from_numpy(a) for a in args))
    if isinstance(on_tensors, torch.Tensor):
        assert on_tensors.dtype == torch.float64
    got = np.broadcast_to(np.asarray(on_tensors), expected.shape)
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0, equal_nan=True)
    # the same body on NumPy arrays (set-up) gives the same numbers
    on_numpy = np.broadcast_to(np.asarray(port(*args)), expected.shape)
    np.testing.assert_allclose(on_numpy, got, rtol=1e-12, atol=0, equal_nan=True)


def test_particle_shape_porous_spheroid_supports_mixed_phase():
    f = pysdm_tpu_torch.Formulae(particle_shape_and_density="PorousSpheroid")
    assert f.particle_shape_and_density.supports_mixed_phase()


# --- tests/unit/test_physics_values.py, replayed on the port ----------------
Formulae = pysdm_tpu_torch.Formulae
PVS_VARIANTS = (
    "AugustRocheMagnus", "Bolton1980", "FlatauWalkoCotton", "Lowe1977",
    "MurphyKoop2005", "Wexler1976",
)


@pytest.mark.parametrize("variant", PVS_VARIANTS)
def test_pvs_value_at_0C(variant):
    f = Formulae(saturation_vapour_pressure=variant)
    pvs = float(f.saturation_vapour_pressure.pvs_water(T0C))
    np.testing.assert_allclose(pvs, 611.2, rtol=5e-3)


@pytest.mark.parametrize("variant", PVS_VARIANTS)
@pytest.mark.parametrize("T_C", (-30.0, -10.0, 0.0, 10.0, 25.0, 40.0))
def test_pvs_variants_mutually_consistent(variant, T_C):
    anchor = Formulae(saturation_vapour_pressure="MurphyKoop2005")
    f = Formulae(saturation_vapour_pressure=variant)
    got = float(f.saturation_vapour_pressure.pvs_water(T0C + T_C))
    want = float(anchor.saturation_vapour_pressure.pvs_water(T0C + T_C))
    np.testing.assert_allclose(got, want, rtol=2e-2)


@pytest.mark.parametrize("variant", ("FlatauWalkoCotton", "MurphyKoop2005"))
def test_ice_equals_water_at_triple_point_and_below_when_supercooled(variant):
    fam = Formulae(saturation_vapour_pressure=variant).saturation_vapour_pressure
    np.testing.assert_allclose(
        float(fam.pvs_ice(T0C)), float(fam.pvs_water(T0C)), rtol=1e-2
    )
    for T_ in (T0C - 10, T0C - 25):
        assert float(fam.pvs_ice(T_)) < float(fam.pvs_water(T_))


def test_ventilation_neglect_is_unity():
    f = Formulae(ventilation="Neglect")
    x = np.asarray([0.0, 1.0, 10.0])
    np.testing.assert_array_equal(
        np.asarray(f.ventilation.ventilation_coefficient(x)), 1.0
    )


def test_froessling_at_zero_re_is_unity():
    f = Formulae(ventilation="Froessling1938")
    np.testing.assert_allclose(
        float(f.ventilation.ventilation_coefficient(0.0)), 1.0, rtol=1e-6
    )


def test_pruppacher_rasmussen_continuous_at_threshold():
    f = Formulae(ventilation="PruppacherAndRasmussen1979")
    x_thres = f.constants.PRUPPACHER_RASMUSSEN_1979_XTHRES
    below = float(f.ventilation.ventilation_coefficient(x_thres * (1 - 1e-9)))
    above = float(f.ventilation.ventilation_coefficient(x_thres * (1 + 1e-9)))
    np.testing.assert_allclose(below, above, rtol=1e-3)


@pytest.mark.parametrize("variant", ("Froessling1938", "PruppacherAndRasmussen1979"))
def test_ventilation_monotonic_increasing(variant):
    f = Formulae(ventilation=variant)
    y = np.asarray(
        f.ventilation.ventilation_coefficient(torch.linspace(0.0, 10.0, 100,
                                                             dtype=torch.float64))
    )
    assert (np.diff(y) >= 0).all()


@pytest.mark.parametrize("variant", ("TracyWelchPorter", "SeinfeldAndPandis2010"))
def test_vapour_diffusivity_standard_conditions(variant):
    f = Formulae(diffusion_thermics=variant)
    np.testing.assert_allclose(
        float(f.diffusion_thermics.D(T0C + 20, 101325.0)), 2.5e-5, rtol=0.1
    )


def test_thermal_conductivity_standard_conditions():
    f = Formulae(diffusion_thermics="SeinfeldAndPandis2010")
    np.testing.assert_allclose(
        float(f.diffusion_thermics.K(T0C + 20, 101325.0)), 0.025, rtol=0.1
    )


@pytest.mark.parametrize("variant", ("Constant", "Kirchhoff", "SeinfeldPandis"))
def test_latent_heat_about_2p5MJ_at_0C(variant):
    f = Formulae(latent_heat_vapourisation=variant)
    np.testing.assert_allclose(
        float(f.latent_heat_vapourisation.lv(T0C)), 2.5e6, rtol=2e-2
    )


def test_stephens_tau_and_bohren_albedo():
    f = Formulae(optical_albedo="Bohren1987", optical_depth="Stephens1978")
    tau = float(f.optical_depth.tau(0.1 * si.kg / si.m**2, 10 * si.um))
    np.testing.assert_allclose(tau, 15.0, rtol=1e-6)
    albedo = float(f.optical_albedo.albedo(tau))
    assert 0 < albedo < 1
    assert float(f.optical_albedo.albedo(2 * tau)) > albedo


# --- test_products_extended.py: surface tension and the dry aerosol ---------
SURFACE_T = 283.0
SURFACE_V_WET = 4.0 / 3 * np.pi * (1e-6) ** 3
SURFACE_V_DRY = 4.0 / 3 * np.pi * (1e-7) ** 3
RUEHL = dict(
    RUEHL_nu_org=7.47e-5, RUEHL_A0=2.5e-19, RUEHL_C0=1e-5,
    RUEHL_m_sigma=0.3e17, RUEHL_sgm_min=0.02,
)


def test_ovadnevaite_matches_closed_form():
    f = Formulae(
        surface_tension="CompressedFilmOvadnevaite",
        constants=dict(sgm_org=0.04, delta_min=1e-9),
    )
    got = float(f.surface_tension.sigma(SURFACE_T, SURFACE_V_WET, SURFACE_V_DRY, 0.5))
    r_wet = (3 * SURFACE_V_WET / (4 * np.pi)) ** (1 / 3)
    v_delta = SURFACE_V_WET - 4 * np.pi / 3 * (r_wet - 1e-9) ** 3
    c_beta = min(0.5 * SURFACE_V_DRY / v_delta, 1.0)
    expected = (1 - c_beta) * f.constants.sgm_w + c_beta * 0.04
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_ovadnevaite_limits():
    f = Formulae(
        surface_tension="CompressedFilmOvadnevaite",
        constants=dict(sgm_org=0.04, delta_min=1e-9),
    )
    st = f.surface_tension
    assert float(st.sigma(SURFACE_T, SURFACE_V_WET, SURFACE_V_DRY, 0.0)) == (
        pytest.approx(f.constants.sgm_w)
    )
    assert float(st.sigma(SURFACE_T, SURFACE_V_WET, 0.9 * SURFACE_V_WET, 1.0)) == (
        pytest.approx(0.04)
    )


def test_ruehl_bisection_matches_brute_force_root():
    f = Formulae(surface_tension="CompressedFilmRuehl", constants=RUEHL)
    c = f.constants
    f_org = 0.8
    v_wet = 4 / 3 * np.pi * (0.2e-6) ** 3
    v_dry = 4 / 3 * np.pi * (0.1e-6) ** 3
    got = float(f.surface_tension.sigma(SURFACE_T, v_wet, v_dry, f_org))
    assert c.RUEHL_sgm_min <= got <= c.sgm_w
    Cb_iso = (f_org * v_dry / c.RUEHL_nu_org) / (v_wet / c.water_molar_volume)
    r_wet = (3 * v_wet / (4 * np.pi)) ** (1 / 3)
    A_iso = (4 * np.pi * r_wet**2) / (f_org * v_dry * c.N_A / c.RUEHL_nu_org)
    cc = (c.RUEHL_m_sigma * c.N_A) / (2 * c.R_str * SURFACE_T)
    fss = np.linspace(1e-6, 1.0, 200001)
    vals = Cb_iso * (1 - fss) / c.RUEHL_C0 - np.exp(
        cc * (c.RUEHL_A0**2 - (A_iso / fss) ** 2)
    )
    f_surf = fss[np.where(np.diff(np.sign(vals)))[0][0]]
    expected = c.sgm_w - (c.RUEHL_A0 - A_iso / f_surf) * c.RUEHL_m_sigma
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_szyszkowski_monotone_in_f_org():
    f = Formulae(surface_tension="SzyszkowskiLangmuir", constants=RUEHL)
    sigmas = [
        float(f.surface_tension.sigma(SURFACE_T, SURFACE_V_WET, SURFACE_V_DRY, fo))
        for fo in (0.0, 0.25, 0.5, 1.0)
    ]
    assert sigmas[0] == pytest.approx(f.constants.sgm_w)
    assert all(a >= b for a, b in zip(sigmas, sigmas[1:]))


def _mixture(pkg_class):
    return pkg_class(
        compounds=("(NH4)2SO4", "insoluble"),
        densities={"(NH4)2SO4": 1770.0, "insoluble": 1320.0},
        molar_masses={"(NH4)2SO4": 132.14e-3, "insoluble": 0.1},
        is_soluble={"(NH4)2SO4": True, "insoluble": False},
        ionic_dissociation_phi={"(NH4)2SO4": 3, "insoluble": 1},
    )


@pytest.mark.parametrize("fractions", (
    {"(NH4)2SO4": 1.0, "insoluble": 0.0},
    {"(NH4)2SO4": 0.7, "insoluble": 0.3},
    {"(NH4)2SO4": 0.5, "insoluble": 0.5},
))
def test_dry_aerosol_mixture_matches_jax_package(fractions):
    from pysdm_tpu.initialisation import DryAerosolMixture as JaxMixture

    wmv = Formulae().constants.water_molar_volume
    port, ref = _mixture(DryAerosolMixture), _mixture(JaxMixture)
    assert port.volume_fractions(fractions) == ref.volume_fractions(fractions)
    assert port.f_soluble_volume(fractions) == ref.f_soluble_volume(fractions)
    assert port.kappa(fractions, wmv) == ref.kappa(fractions, wmv)
    assert port.nu_org(fractions) == ref.nu_org(fractions)
    vf = port.volume_fractions(fractions)
    assert sum(vf.values()) == pytest.approx(1.0)


def test_kappa_pure_ammonium_sulfate_and_insoluble_fraction():
    mix = _mixture(DryAerosolMixture)
    wmv = Formulae().constants.water_molar_volume
    k_pure = mix.kappa({"(NH4)2SO4": 1.0, "insoluble": 0.0}, wmv)
    assert 0.6 < k_pure["Constant"] < 0.8
    assert k_pure["CompressedFilmOvadnevaite"] == pytest.approx(k_pure["Constant"])
    k_half = mix.kappa({"(NH4)2SO4": 0.5, "insoluble": 0.5}, wmv)
    assert k_half["Constant"] < k_pure["Constant"]
    assert k_half["CompressedFilmRuehl"] < k_half["Constant"]
    assert mix.nu_org({"(NH4)2SO4": 0.5, "insoluble": 0.5}) == pytest.approx(
        0.1 / 1320
    )
