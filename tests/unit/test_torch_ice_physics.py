"""The ice slice's formula families in the port against the JAX package, in
float64 on the same numpy-made inputs: the ice trivia, ``MixedPhaseSpheres``
and ``ColumnarIce``, the sublimation heat, the freezing-temperature spectra,
J_het and J_hom, the ice diffusion kinetics and capacities, and the bulk
phase partitioning; the ``Null`` variants and the defaults; and that for a
positive mass ``MixedPhaseSpheres`` gives ``LiquidSpheres``' volume and
radius bit for bit, so K3 evaluates both with one body.

Tolerance: rtol 1e-12. Both packages evaluate the same expressions in the
same order, with the powers of the J_hom polynomials taken by the same
multiplications (``_xp.integer_power``); XLA's and torch's exp, log and
pow may differ by an ulp, which the cancellation in those polynomials
(terms up to ~5.6e4 summing to ~10) raises to ~1e-14 relative in J.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu_torch

N = 64
_rng = np.random.default_rng(2024)


def _u(lo, hi):
    return _rng.uniform(lo, hi, N)


def _log_u(lo, hi):
    return np.exp(_u(np.log(lo), np.log(hi)))


T_ICE = _u(200.0, 290.0)
P = _u(1.5e4, 1.02e5)
RHOD = _u(0.3, 1.3)
SIGNED_MASS = _log_u(1e-18, 1e-8) * np.where(_u(0, 1) < 0.5, -1.0, 1.0)
ICE_MASS = -_log_u(1e-16, 1e-9)
A_INSOL = _log_u(1e-13, 1e-9)
CDF = _u(0.01, 0.99)

CONSTANTS = {
    "NIEMAND_A": -0.517, "NIEMAND_B": 8.934, "BIGG_DT_MEDIAN": 33.0,
    "ABIFM_M": 54.48, "ABIFM_C": -10.67, "J_HET": 1e5, "J_HOM": 1e13,
    "bulk_phase_partitioning_exponent": 0.1,
}

CASES = (
    ("trivia", "Trivia", "unfrozen", (SIGNED_MASS,)),
    ("trivia", "Trivia", "unfrozen_and_saturated", (SIGNED_MASS, _u(0.8, 1.2))),
    ("trivia", "Trivia", "unfrozen_and_ice_saturated",
     (SIGNED_MASS, _u(0.8, 1.6))),
    ("trivia", "Trivia", "frozen_and_above_freezing_point",
     (SIGNED_MASS, _u(260.0, 285.0))),
    ("trivia", "Trivia", "erfinv_approx", (_u(-0.99, 0.99),)),
    ("trivia", "Trivia", "poissonian_avoidance_function",
     (_log_u(1e-8, 10.0), 0.5)),
    *(
        ("particle_shape_and_density", "MixedPhaseSpheres", name, args)
        for name, args in (
            ("mass_to_volume", (SIGNED_MASS,)),
            ("volume_to_mass", (SIGNED_MASS / 1e3,)),
            ("radius_to_mass", (_log_u(1e-8, 1e-3),)),
            ("mass_to_radius", (SIGNED_MASS,)),
            ("reynolds_number", (_log_u(1e-7, 1e-3), _u(0.0, 5.0),
                                 _u(1.5e-5, 1.9e-5), RHOD)),
            ("dm_dt", (_log_u(1e-7, 1e-3), _u(-1e-10, 1e-10))),
            ("dm_dt_over_m", (_log_u(1e-7, 1e-3), _u(-1e-10, 1e-10))),
            ("r_dr_dt", (_log_u(1e-7, 1e-3), _u(-1e-3, 1e-3))),
        )
    ),
    *(
        ("particle_shape_and_density", "ColumnarIce", name, args)
        for name, args in (
            ("mass_to_volume", (ICE_MASS,)),
            ("volume_to_mass", (ICE_MASS / 810.0,)),
            ("polar_radius_empirical_parametrisation", (ICE_MASS,)),
            ("aspect_ratio_empirical_parametrisation", (ICE_MASS,)),
        )
    ),
    ("latent_heat_sublimation", "MurphyKoop2005", "ls", (T_ICE,)),
    *(
        ("freezing_temperature_spectrum", "Niemand_et_al_2012", name, args)
        for name, args in (
            ("ns", (T_ICE,)),
            ("pdf", (T_ICE, A_INSOL)),
            ("cdf", (T_ICE, A_INSOL)),
            ("invcdf", (CDF, A_INSOL)),
        )
    ),
    *(
        ("freezing_temperature_spectrum", "Bigg_1953", name, args)
        for name, args in (
            ("pdf", (_u(200.0, 250.0), A_INSOL)),
            ("cdf", (T_ICE, A_INSOL)),
            ("invcdf", (CDF, A_INSOL)),
            ("median", ()),
        )
    ),
    ("heterogeneous_ice_nucleation_rate", "ABIFM", "j_het", (_u(0.7, 1.0),)),
    ("heterogeneous_ice_nucleation_rate", "Constant", "j_het", (_u(0.7, 1.0),)),
    *(
        ("homogeneous_ice_nucleation_rate", variant, name, args)
        for variant in ("Koop2000", "Koop_Correction", "KoopMurray2016",
                        "Constant")
        for name, args in (
            ("j_hom", (_u(225.0, 245.0), _u(0.26, 0.34))),
            ("d_a_w_ice_within_range", (_u(0.2, 0.4),)),
            ("d_a_w_ice_maximum", (_u(0.2, 0.4),)),
        )
    ),
    *(
        ("diffusion_ice_kinetics", variant, name, args)
        for variant in ("Neglect", "Standard")
        for name, args in (
            ("lambdaD", (T_ICE, P)),
            ("lambdaK", (T_ICE, P)),
            ("D", (_u(1e-5, 3e-5), _log_u(1e-7, 1e-3), _u(5e-8, 5e-7), T_ICE)),
            ("K", (_u(0.02, 0.03), _log_u(1e-7, 1e-3), _u(5e-8, 5e-7), T_ICE,
                   RHOD)),
        )
    ),
    ("diffusion_ice_capacity", "Spherical", "capacity", (ICE_MASS,)),
    ("diffusion_ice_capacity", "Columnar", "capacity", (ICE_MASS,)),
    ("diffusion_ice_capacity", "Columnar", "reference_capacity",
     (_log_u(1e-6, 1e-3), _u(0.05, 0.95))),
    ("bulk_phase_partitioning", "KaulEtAl2015", "liquid_fraction",
     (_u(225.0, 280.0),)),
)


def _formulae(package, family, variant):
    choice = {} if family == "trivia" else {family: variant}
    return package.Formulae(seed=44, constants=CONSTANTS, **choice)


@pytest.mark.parametrize(
    "family, variant, name, args", CASES,
    ids=[f"{family}.{variant}.{name}" for family, variant, name, _ in CASES],
)
def test_ice_variant_matches_jax_package(family, variant, name, args):
    expected = getattr(getattr(_formulae(pysdm_tpu, family, variant), family), name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    port = getattr(_formulae(pysdm_tpu_torch, family, variant), family)
    assert port.variant == variant
    got = getattr(port, name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    if isinstance(got, torch.Tensor):
        assert got.dtype in (torch.float64, torch.bool)
        got = got.numpy()
    expected = np.asarray(expected)
    got = np.broadcast_to(got, expected.shape)
    if expected.dtype == bool:
        np.testing.assert_array_equal(got, expected)
    else:
        assert np.isfinite(expected).all()
        np.testing.assert_allclose(got, expected, rtol=1e-12)


@pytest.mark.parametrize("family", (
    "freezing_temperature_spectrum", "heterogeneous_ice_nucleation_rate",
    "homogeneous_ice_nucleation_rate", "bulk_phase_partitioning",
))
def test_null_variants_and_ice_defaults_are_the_jax_packages(family):
    jax_f, port_f = pysdm_tpu.Formulae(), pysdm_tpu_torch.Formulae()
    assert getattr(port_f, family).variant == "Null"
    assert getattr(jax_f, family).variant == "Null"
    for name in ("latent_heat_sublimation", "diffusion_ice_kinetics",
                 "diffusion_ice_capacity"):
        assert getattr(port_f, name).variant == getattr(jax_f, name).variant
    assert pysdm_tpu_torch.Formulae(**{family: "Null"}).__getattribute__(
        family
    ).variant == "Null"


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_mixed_phase_spheres_are_liquid_spheres_for_positive_mass(dtype):
    """K3 evaluates a drop's volume and radius with ``LiquidSpheres``' body;
    for m > 0 ``MixedPhaseSpheres`` gives the same bits"""
    liquid = pysdm_tpu_torch.Formulae(seed=1)
    mixed = pysdm_tpu_torch.Formulae(
        seed=1, particle_shape_and_density="MixedPhaseSpheres"
    )
    mass = torch.as_tensor(_log_u(1e-21, 1e-3), dtype=dtype)
    for name in ("mass_to_volume", "volume_to_mass"):
        assert torch.equal(
            getattr(mixed.particle_shape_and_density, name)(mass),
            getattr(liquid.particle_shape_and_density, name)(mass),
        )
    volume = mixed.particle_shape_and_density.mass_to_volume(mass)
    assert torch.equal(
        mixed.trivia.radius(volume),
        liquid.trivia.radius(liquid.particle_shape_and_density.mass_to_volume(mass)),
    )
    # and ice is ice: a negative mass has a negative volume at the density
    # of ice
    ice = mixed.particle_shape_and_density.mass_to_volume(-mass)
    assert (ice < 0).all()
    np.testing.assert_allclose(
        ice.double().numpy(), -mass.double().numpy() / 916.8, rtol=1e-6
    )
