"""The port's formulae under its scale-covariance harness
(``pysdm_tpu_torch/physics/dimensional_analysis.py``): the JAX package's
``tests/unit/test_dimensional_analysis.py`` replayed, then every variant
of the families the rest of physics/ brought (``TestEveryVariant``)."""

import numpy as np
import pytest

from pysdm_tpu_torch.physics.dimensional_analysis import (
    AREA,
    DIFFUSIVITY,
    DIMENSIONLESS,
    DENSITY,
    DimensionalAnalysis,
    ENERGY_PER_MASS,
    GROWTH_RESISTANCE,
    LENGTH,
    MASS,
    PRESSURE,
    SURFACE_TENSION,
    TEMPERATURE,
    THERMAL_CONDUCTIVITY,
    VELOCITY,
    VOLUME,
    Dimension,
)


@pytest.fixture(scope="module")
def da():
    return DimensionalAnalysis()


T_TEST = np.asarray([253.0, 273.15, 283.0, 300.0])
P_TEST = np.asarray([600e2, 800e2, 1000e2, 1013e2])


class TestSaturationVapourPressure:
    @staticmethod
    @pytest.mark.parametrize(
        "variant",
        (
            "FlatauWalkoCotton",
            "AugustRocheMagnus",
            "Bolton1980",
            "Lowe1977",
            "MurphyKoop2005",
            "Wexler1976",
        ),
    )
    def test_pvs_water_is_pressure(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"saturation_vapour_pressure": variant}
        )
        da.check(
            lambda f: f.saturation_vapour_pressure.pvs_water,
            in_dims=(TEMPERATURE,),
            out_dim=PRESSURE,
            args=(T_TEST,),
        )

    @staticmethod
    def test_pvs_ice_is_pressure(da):
        da.check(
            lambda f: f.saturation_vapour_pressure.pvs_ice,
            in_dims=(TEMPERATURE,),
            out_dim=PRESSURE,
            args=(T_TEST,),
        )


class TestLatentHeat:
    @staticmethod
    @pytest.mark.parametrize(
        "variant", ("Kirchhoff", "Lowe2019", "Constant")
    )
    def test_lv_is_energy_per_mass(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"latent_heat_vapourisation": variant}
        )
        da.check(
            lambda f: f.latent_heat_vapourisation.lv,
            in_dims=(TEMPERATURE,),
            out_dim=ENERGY_PER_MASS,
            args=(T_TEST,),
        )


class TestTrivia:
    @staticmethod
    def test_volume_radius_roundtrip_dims(da):
        da.check(
            lambda f: f.trivia.volume,
            in_dims=(LENGTH,),
            out_dim=VOLUME,
            args=(np.asarray([1e-6, 1e-5]),),
        )
        da.check(
            lambda f: f.trivia.radius,
            in_dims=(VOLUME,),
            out_dim=LENGTH,
            args=(np.asarray([1e-18, 1e-15]),),
        )


class TestStateVariableTriplet:
    @staticmethod
    def test_T_of_rhod_thd(da):
        da.check(
            lambda f: f.state_variable_triplet.T,
            in_dims=(DENSITY, TEMPERATURE),
            out_dim=TEMPERATURE,
            args=(np.asarray([1.1]), np.asarray([290.0])),
        )

    @staticmethod
    def test_p_of_rhod_T_qv(da):
        da.check(
            lambda f: f.state_variable_triplet.p,
            in_dims=(DENSITY, TEMPERATURE, DIMENSIONLESS),
            out_dim=PRESSURE,
            args=(np.asarray([1.1]), np.asarray([283.0]), np.asarray([0.01])),
        )


class TestDiffusion:
    @staticmethod
    def test_D_is_diffusivity(da):
        da.check(
            lambda f: f.diffusion_thermics.D,
            in_dims=(TEMPERATURE, PRESSURE),
            out_dim=DIFFUSIVITY,
            args=(T_TEST, P_TEST),
        )

    @staticmethod
    def test_K_is_conductivity(da):
        da.check(
            lambda f: f.diffusion_thermics.K,
            in_dims=(TEMPERATURE, PRESSURE),
            out_dim=THERMAL_CONDUCTIVITY,
            args=(T_TEST, P_TEST),
        )


class TestDropGrowth:
    @staticmethod
    def test_Fk_Fd_growth_resistances(da):
        T = np.asarray([283.0])
        da.check(
            lambda f: (
                lambda T, lv, K: f.drop_growth.Fk(T=T, lv=lv, K=K)
            ),
            in_dims=(TEMPERATURE, ENERGY_PER_MASS, THERMAL_CONDUCTIVITY),
            out_dim=GROWTH_RESISTANCE,
            args=(T, np.asarray([2.5e6]), np.asarray([2.4e-2])),
        )
        da.check(
            lambda f: (
                lambda T, pvs, D: f.drop_growth.Fd(T=T, pvs=pvs, D=D)
            ),
            in_dims=(TEMPERATURE, PRESSURE, DIFFUSIVITY),
            out_dim=GROWTH_RESISTANCE,
            args=(T, np.asarray([1220.0]), np.asarray([2.26e-5])),
        )

    @staticmethod
    def test_r_dr_dt_dims(da):
        da.check(
            lambda f: (
                lambda RH_eq, RH, Fk, Fd: f.drop_growth.r_dr_dt(
                    RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd
                )
            ),
            in_dims=(
                DIMENSIONLESS,
                DIMENSIONLESS,
                GROWTH_RESISTANCE,
                GROWTH_RESISTANCE,
            ),
            out_dim=DIFFUSIVITY,  # r dr/dt: m^2/s
            args=(
                np.asarray([1.001]),
                np.asarray([1.005]),
                np.asarray([1e8]),
                np.asarray([1e8]),
            ),
        )


class TestHygroscopicity:
    @staticmethod
    def test_RH_eq_dimensionless(da):
        r = np.asarray([1e-6])
        rd3 = np.asarray([1e-21])
        da.check(
            lambda f: f.hygroscopicity.RH_eq,
            in_dims=(
                LENGTH,
                TEMPERATURE,
                DIMENSIONLESS,
                VOLUME,
                SURFACE_TENSION,
            ),
            out_dim=DIMENSIONLESS,
            args=(r, np.asarray([283.0]), np.asarray([0.5]), rd3,
                  np.asarray([0.072])),
        )

    @staticmethod
    def test_r_cr_is_length(da):
        da.check(
            lambda f: f.hygroscopicity.r_cr,
            in_dims=(DIMENSIONLESS, VOLUME, TEMPERATURE, SURFACE_TENSION),
            out_dim=LENGTH,
            args=(
                np.asarray([0.5]),
                np.asarray([1e-21]),
                np.asarray([283.0]),
                np.asarray([0.072]),
            ),
        )


class TestSurfaceTension:
    @staticmethod
    @pytest.mark.parametrize(
        "variant", ("Constant", "CompressedFilmOvadnevaite")
    )
    def test_sigma_dims(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"surface_tension": variant}
        )
        da.check(
            lambda f: f.surface_tension.sigma,
            in_dims=(TEMPERATURE, VOLUME, VOLUME, DIMENSIONLESS),
            out_dim=SURFACE_TENSION,
            args=(
                np.asarray([283.0]),
                np.asarray([1e-17]),
                np.asarray([1e-20]),
                np.asarray([0.3]),
            ),
        )


class TestTerminalVelocity:
    @staticmethod
    def test_rogers_yau_is_velocity():
        da = DimensionalAnalysis(
            formulae_kwargs={"terminal_velocity": "RogersYau"}
        )
        da.check(
            lambda f: f.terminal_velocity.v_term,
            in_dims=(LENGTH,),
            out_dim=VELOCITY,
            args=(np.asarray([10e-6, 100e-6, 1e-3]),),
        )


class TestDetectsBugs:
    @staticmethod
    def test_catches_dimension_error():
        """sanity: a deliberately wrong claimed output dimension fails"""
        da = DimensionalAnalysis()
        with pytest.raises(AssertionError):
            da.check(
                lambda f: f.saturation_vapour_pressure.pvs_water,
                in_dims=(TEMPERATURE,),
                out_dim=LENGTH,  # wrong on purpose
                args=(T_TEST,),
            )


def _variant_da(family, variant, constants=None):
    kwargs = {family: variant}
    if constants:
        kwargs["constants"] = dict(constants)
    return DimensionalAnalysis(formulae_kwargs=kwargs)


FILM_CONSTANTS = dict(
    sgm_org=0.04, delta_min=0.1e-9, RUEHL_nu_org=7.47e-5, RUEHL_A0=2.5e-19,
    RUEHL_C0=1e-5, RUEHL_m_sigma=0.3e17, RUEHL_sgm_min=0.02,
)
DIFFUSION_KINETICS = (
    "FuchsSutugin", "Neglect", "PruppacherKlett", "GrabowskiEtAl2011",
    "LoweEtAl2019",
)
DIFFUSION_THERMICS = (
    "Neglect", "TracyWelchPorter", "SeinfeldAndPandis2010", "LoweEtAl2019",
    "GrabowskiEtAl2011",
)


class TestEveryVariant:
    @staticmethod
    @pytest.mark.parametrize("variant", DIFFUSION_THERMICS)
    @pytest.mark.parametrize("name, out_dim", (
        ("D", DIFFUSIVITY), ("K", THERMAL_CONDUCTIVITY),
    ))
    def test_diffusion_thermics(variant, name, out_dim):
        _variant_da("diffusion_thermics", variant).check(
            lambda f: getattr(f.diffusion_thermics, name),
            in_dims=(TEMPERATURE, PRESSURE), out_dim=out_dim,
            args=(T_TEST, P_TEST),
        )

    @staticmethod
    @pytest.mark.parametrize("variant", DIFFUSION_KINETICS)
    @pytest.mark.parametrize("name, in_dims, out_dim, args", (
        ("D", (DIFFUSIVITY, LENGTH, LENGTH), DIFFUSIVITY,
         (np.asarray([2e-5]), np.asarray([1e-7, 1e-6]), np.asarray([1e-7]))),
        ("K", (THERMAL_CONDUCTIVITY, LENGTH, LENGTH), THERMAL_CONDUCTIVITY,
         (np.asarray([2.4e-2]), np.asarray([1e-7, 1e-6]), np.asarray([1e-7]))),
    ))
    def test_diffusion_kinetics(variant, name, in_dims, out_dim, args):
        _variant_da("diffusion_kinetics", variant).check(
            lambda f: getattr(f.diffusion_kinetics, name),
            in_dims=in_dims, out_dim=out_dim, args=args,
        )

    @staticmethod
    @pytest.mark.parametrize("variant", (
        "FuchsSutugin", "PruppacherKlett", "GrabowskiEtAl2011", "LoweEtAl2019",
    ))
    def test_mean_free_path_is_length(variant):
        da = _variant_da("diffusion_kinetics", variant)
        da.check(
            lambda f: f.diffusion_kinetics.lambdaD,
            in_dims=(DIFFUSIVITY, TEMPERATURE), out_dim=LENGTH,
            args=(np.asarray([2e-5]), T_TEST),
        )
        if variant == "FuchsSutugin":
            da.check(
                lambda f: f.diffusion_kinetics.lambdaK,
                in_dims=(TEMPERATURE, PRESSURE), out_dim=LENGTH,
                args=(T_TEST, P_TEST),
            )

    @staticmethod
    @pytest.mark.parametrize("variant", ("SeinfeldPandis",))
    def test_lv_is_energy_per_mass(variant):
        _variant_da("latent_heat_vapourisation", variant).check(
            lambda f: f.latent_heat_vapourisation.lv,
            in_dims=(TEMPERATURE,), out_dim=ENERGY_PER_MASS, args=(T_TEST,),
        )

    @staticmethod
    @pytest.mark.parametrize("variant", (
        "CompressedFilmRuehl", "SzyszkowskiLangmuir",
    ))
    def test_sigma_dims(variant):
        _variant_da("surface_tension", variant, FILM_CONSTANTS).check(
            lambda f: f.surface_tension.sigma,
            in_dims=(TEMPERATURE, VOLUME, VOLUME, DIMENSIONLESS),
            out_dim=SURFACE_TENSION,
            args=(
                np.asarray([283.0, 283.0, 283.0]),
                np.asarray([5e-20, 1e-18, 1e-17]),
                np.asarray([1e-20, 1e-20, 1e-20]),
                np.asarray([0.3, 0.8, 0.0]),
            ),
        )

    @staticmethod
    @pytest.mark.parametrize("variant", (
        "Neglect", "Froessling1938", "PruppacherAndRasmussen1979",
    ))
    def test_ventilation_is_dimensionless(variant):
        _variant_da("ventilation", variant).check(
            lambda f: f.ventilation.ventilation_coefficient,
            in_dims=(DIMENSIONLESS,), out_dim=DIMENSIONLESS,
            args=(np.asarray([0.5, 1.0, 3.0]),),
        )

    @staticmethod
    def test_optical_depth_and_albedo():
        da = DimensionalAnalysis(formulae_kwargs={
            "optical_depth": "Stephens1978", "optical_albedo": "Bohren1987",
        })
        da.check(
            lambda f: f.optical_depth.tau,
            in_dims=(Dimension(M=1, L=-2), LENGTH), out_dim=DIMENSIONLESS,
            args=(np.asarray([0.1]), np.asarray([1e-5])),
        )
        da.check(
            lambda f: f.optical_albedo.albedo,
            in_dims=(DIMENSIONLESS,), out_dim=DIMENSIONLESS,
            args=(np.asarray([15.0]),),
        )

    @staticmethod
    def test_porous_spheroid_geometry():
        da = _variant_da("particle_shape_and_density", "PorousSpheroid")
        da.check(
            lambda f: f.particle_shape_and_density.polar_radius,
            in_dims=(LENGTH, DIMENSIONLESS), out_dim=LENGTH,
            args=(np.asarray([1e-5]), np.asarray([2.0])),
        )

    @staticmethod
    def test_variable_g_isothermal_pressure():
        _variant_da(
            "hydrostatics", "VariableGIsothermal",
            {"celestial_body_radius": 6.371e6},
        ).check(
            lambda f: f.hydrostatics.pressure,
            in_dims=(LENGTH, PRESSURE, TEMPERATURE, Dimension(M=1, N=-1)),
            out_dim=PRESSURE,
            args=(np.asarray([1e3]), np.asarray([1e5]), np.asarray([280.0]),
                  np.asarray([0.029])),
        )
