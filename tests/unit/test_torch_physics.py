"""The parcel slice's formula variants in the port against the JAX package,
in float64 on the same numpy-made inputs, and each body on Python floats,
NumPy arrays and torch tensors.

Tolerance: rtol 1e-14. Both packages evaluate the same expressions in the
same order, but XLA's and torch's exp, log and pow may differ by an ulp,
and a few bodies (KappaKoehlerLeadingTerms, Mason1971) subtract nearly
equal terms, which turns that ulp into a few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu_torch

N = 16
_rng = np.random.default_rng(1234)


def _u(lo, hi):
    return _rng.uniform(lo, hi, N)


T = _u(250.0, 310.0)
P = _u(6e4, 1.02e5)
QV = _u(2e-3, 2.5e-2)
RHOD = _u(0.8, 1.25)
THD = _u(280.0, 320.0)
R = np.exp(_u(np.log(2e-8), np.log(2e-5)))
RD3 = (R / 3) ** 3
KP = _u(0.1, 1.2)
LV = _u(2.4e6, 2.6e6)
MASS = np.exp(_u(np.log(1e-20), np.log(1e-9)))

CASES = (
    ("saturation_vapour_pressure", "FlatauWalkoCotton", "pvs_water", (T,)),
    ("saturation_vapour_pressure", "FlatauWalkoCotton", "pvs_ice", (T,)),
    ("latent_heat_vapourisation", "Kirchhoff", "lv", (T,)),
    *(
        ("hygroscopicity", v, name, args)
        for v in ("KappaKoehler", "KappaKoehlerLeadingTerms")
        for name, args in (
            ("RH_eq", (R, T, KP, RD3, 0.072)),
            ("r_cr", (KP, RD3, T, 0.072)),
        )
    ),
    *(
        ("drop_growth", v, name, args)
        for v in ("Fick", "Howell1949", "Mason1971")
        for name, args in (
            ("Fk", (T, _u(0.02, 0.03), LV)),
            ("Fd", (T, _u(1e-5, 3e-5), _u(500.0, 4000.0))),
            ("r_dr_dt", (_u(0.95, 1.05), _u(0.95, 1.05), _u(1e9, 3e9),
                         _u(1e9, 5e9))),
        )
    ),
    *(
        ("diffusion_kinetics", v, name, args)
        for v in ("FuchsSutugin", "Neglect")
        for name, args in (
            ("lambdaD", (_u(1e-5, 3e-5), T)),
            ("lambdaK", (T, P)),
            ("D", (_u(1e-5, 3e-5), R, _u(5e-8, 2e-7))),
            ("K", (_u(0.02, 0.03), R, _u(5e-8, 2e-7))),
        )
    ),
    ("diffusion_thermics", "Neglect", "D", (T, P)),
    ("diffusion_thermics", "Neglect", "K", (T, P)),
    *(
        ("state_variable_triplet", "LibcloudphPlusPlus", name, args)
        for name, args in (
            ("T", (RHOD, THD)),
            ("p", (RHOD, T, QV)),
            ("pv", (P, QV)),
            ("dthd_dt", (RHOD, THD, T, _u(-1e-5, 1e-5), LV)),
            ("th_dry", (THD, QV)),
            ("rho_d", (P, QV, THD)),
            ("rho_of_rhod_and_water_vapour_mixing_ratio", (RHOD, QV)),
            ("rhod_of_pd_T", (P, T)),
        )
    ),
    ("hydrostatics", "ConstantGVapourMixingRatioAndThetaStd", "drho_dz",
     (P, T, QV, LV, _u(-1e-5, 1e-5))),
    ("hydrostatics", "ConstantGVapourMixingRatioAndThetaStd",
     "p_of_z_assuming_const_th_and_initial_water_vapour_mixing_ratio",
     (P, THD, QV, _u(0.0, 2000.0))),
    ("air_dynamic_viscosity", "ZografosEtAl1987", "eta_air", (T,)),
    ("ventilation", "Neglect", "ventilation_coefficient", (_u(0.0, 30.0),)),
    ("surface_tension", "Constant", "sigma", (T, R**3, RD3, np.zeros(N))),
    *(
        ("diffusion_coordinate", v, name, args)
        for v in ("WaterMass", "WaterMassLogarithm")
        for name, args in (
            ("dx_dt", (MASS, MASS * _u(-1e-2, 1e-2))),
            ("mass", (np.log(MASS) if v == "WaterMassLogarithm" else MASS,)),
            ("x", (MASS,)),
            ("x_max", ()),
        )
    ),
    ("trivia", "Trivia", "within_tolerance", (_u(0.0, 1e-6), T, 1e-8)),
    ("trivia", "Trivia", "p_d", (P, QV)),
    ("trivia", "Trivia", "th_std", (P, T)),
    ("trivia", "Trivia", "air_schmidt_number", (_u(1.6e-5, 1.9e-5),
                                                _u(1e-5, 3e-5), RHOD)),
    ("trivia", "Trivia", "sqrt_re_times_cbrt_sc", (_u(0.0, 100.0),
                                                   _u(0.5, 0.8))),
)


def _ids():
    return [f"{family}.{variant}.{name}" for family, variant, name, _ in CASES]


def _formulae(package, family, variant):
    choice = {} if family == "trivia" else {family: variant}
    return package.Formulae(seed=44, **choice)


@pytest.mark.parametrize("family, variant, name, args", CASES, ids=_ids())
def test_variant_matches_jax_package(family, variant, name, args):
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
    np.testing.assert_allclose(
        np.broadcast_to(got, np.shape(expected)), np.asarray(expected),
        rtol=1e-14,
    )


@pytest.mark.parametrize("family, variant, name, args", (
    ("state_variable_triplet", "LibcloudphPlusPlus", "T", (RHOD, THD)),
    ("hygroscopicity", "KappaKoehler", "RH_eq", (R, T, KP, RD3, 0.072)),
    ("diffusion_kinetics", "FuchsSutugin", "D", (_u(1e-5, 3e-5), R,
                                                 _u(5e-8, 2e-7))),
    ("diffusion_coordinate", "WaterMassLogarithm", "x", (MASS,)),
    ("trivia", "Trivia", "th_std", (P, T)),
), ids=("T", "RH_eq", "D", "x", "th_std"))
def test_one_body_serves_floats_numpy_and_tensors(family, variant, name, args):
    fn = getattr(getattr(_formulae(pysdm_tpu_torch, family, variant), family), name)
    on_numpy = fn(*args)
    assert isinstance(on_numpy, np.ndarray)
    on_floats = [
        fn(*(float(a[k]) if isinstance(a, np.ndarray) else a for a in args))
        for k in range(N)
    ]
    assert not any(isinstance(v, torch.Tensor) for v in on_floats)
    np.testing.assert_allclose(np.asarray(on_floats, float), on_numpy, rtol=1e-14)
    for dtype in (torch.float64, torch.float32):
        on_tensors = fn(*(torch.as_tensor(a, dtype=dtype) for a in args))
        assert on_tensors.dtype == dtype
        np.testing.assert_allclose(
            on_tensors.numpy(), on_numpy,
            rtol=1e-14 if dtype == torch.float64 else 1e-5,
        )


_REST_OF_PHYSICS = "the rest of physics/"


# the ids name the ROADMAP items by their numbers of the time the tests
# were written; the tests keep them
@pytest.mark.parametrize("family, variant, later", tuple(
    pytest.param(
        family, variant, _REST_OF_PHYSICS, id=f"{family}-{variant}-queue 1 item 3"
    )
    for family, variant in (
        ("saturation_vapour_pressure", "AugustRocheMagnus"),
        ("latent_heat_vapourisation", "Lowe2019"),
        ("diffusion_kinetics", "PruppacherKlett"),
        ("diffusion_thermics", "TracyWelchPorter"),
        ("surface_tension", "CompressedFilmOvadnevaite"),
    )
) + (
    pytest.param(
        "ventilation", "Froessling1938", _REST_OF_PHYSICS,
        id="ventilation-Froessling1938-slice 3",
    ),
))
def test_unported_variant_names_where_it_comes(family, variant, later):
    """these variants came with the rest of physics/ (``later``): each now
    binds, and its formulae equal the JAX package's (every variant is held
    at rtol 1e-12 in ``test_torch_physics_variants.py``)"""
    port = getattr(pysdm_tpu_torch.Formulae(**{family: variant}), family)
    assert port.variant == variant
    reference = getattr(pysdm_tpu.Formulae(**{family: variant}), family)
    assert sorted(k for k in vars(port) if k != "variant") == sorted(
        k for k in vars(reference) if k != "variant"
    )


def test_defaults_are_the_jax_packages():
    jax_f, port_f = pysdm_tpu.Formulae(), pysdm_tpu_torch.Formulae()
    for family in (
        "diffusion_coordinate", "saturation_vapour_pressure",
        "latent_heat_vapourisation", "hygroscopicity", "drop_growth",
        "surface_tension", "diffusion_kinetics", "diffusion_thermics",
        "ventilation", "state_variable_triplet", "hydrostatics",
        "air_dynamic_viscosity",
    ):
        assert getattr(port_f, family).variant == getattr(jax_f, family).variant
