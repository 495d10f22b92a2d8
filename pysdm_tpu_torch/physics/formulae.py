"""Formulae engine (API parity with ``pysdm_tpu/physics/formulae.py``): one
variant per physics family, bound to a frozen constants namespace.

The port binds every family of the JAX package, with its defaults
(``pysdm_tpu/physics/formulae.py:86-168``): the nucleation families, the
bulk phase partitioning, the optical families and the isotope families
default to ``Null`` (the isotope ventilation ratio to ``Neglect``), as
there. A variant name may join variants of one family with "+"; the
namespace then has the union of their formulae, the earliest listed
winning a name they share (reference ``formulae.py:336-372``).
"""

import os
import time
from types import SimpleNamespace

from . import (
    diffusion_ice,
    diffusion_kinetics,
    diffusion_thermics,
    drop_growth,
    hygroscopicity,
    ice_nucleation,
    isotopes,
    latent_heat,
    misc_families,
    saturation_vapour_pressure,
    state_variable_triplet,
    surface_tension,
)
from .constants import make_constants
from .particle_shape_and_density import VARIANTS as SHAPE_VARIANTS
from .trivia import Trivia

_NULL = {"Null": misc_families.Null}

# family -> (variants, default)
_FAMILIES = {
    "trivia": ({"Trivia": Trivia}, "Trivia"),
    "particle_shape_and_density": (
        SHAPE_VARIANTS, "LiquidSpheres",
    ),
    "diffusion_coordinate": (
        misc_families.DIFFUSION_COORDINATE_VARIANTS, "WaterMassLogarithm",
    ),
    "saturation_vapour_pressure": (
        saturation_vapour_pressure.VARIANTS, "FlatauWalkoCotton",
    ),
    "latent_heat_vapourisation": (
        latent_heat.VAPOURISATION_VARIANTS, "Kirchhoff",
    ),
    "latent_heat_sublimation": (
        latent_heat.SUBLIMATION_VARIANTS, "MurphyKoop2005",
    ),
    "hygroscopicity": (
        hygroscopicity.VARIANTS, "KappaKoehlerLeadingTerms",
    ),
    "drop_growth": (drop_growth.VARIANTS, "Mason1971"),
    "surface_tension": (
        misc_families.SURFACE_TENSION_VARIANTS | surface_tension.VARIANTS,
        "Constant",
    ),
    "diffusion_kinetics": (diffusion_kinetics.VARIANTS, "FuchsSutugin"),
    "diffusion_ice_kinetics": (
        diffusion_ice.KINETICS_VARIANTS, "Standard",
    ),
    "diffusion_ice_capacity": (
        diffusion_ice.CAPACITY_VARIANTS, "Spherical",
    ),
    "diffusion_thermics": (diffusion_thermics.VARIANTS, "Neglect"),
    "ventilation": (misc_families.VENTILATION_VARIANTS, "Neglect"),
    "state_variable_triplet": (
        state_variable_triplet.VARIANTS, "LibcloudphPlusPlus",
    ),
    "particle_advection": (
        misc_families.PARTICLE_ADVECTION_VARIANTS, "ImplicitInSpace",
    ),
    "terminal_velocity": (
        misc_families.TERMINAL_VELOCITY_VARIANTS, "GunnKinzer1949",
    ),
    "hydrostatics": (
        misc_families.HYDROSTATICS_VARIANTS,
        "ConstantGVapourMixingRatioAndThetaStd",
    ),
    "air_dynamic_viscosity": (
        misc_families.AIR_DYNAMIC_VISCOSITY_VARIANTS, "ZografosEtAl1987",
    ),
    "freezing_temperature_spectrum": (
        _NULL | ice_nucleation.FREEZING_TEMPERATURE_SPECTRUM_VARIANTS, "Null",
    ),
    "heterogeneous_ice_nucleation_rate": (
        _NULL | ice_nucleation.HETEROGENEOUS_RATE_VARIANTS, "Null",
    ),
    "homogeneous_ice_nucleation_rate": (
        _NULL | ice_nucleation.HOMOGENEOUS_RATE_VARIANTS, "Null",
    ),
    "bulk_phase_partitioning": (
        _NULL | misc_families.BULK_PHASE_PARTITIONING_VARIANTS, "Null",
    ),
    "optical_albedo": (misc_families.OPTICAL_ALBEDO_VARIANTS, "Null"),
    "optical_depth": (misc_families.OPTICAL_DEPTH_VARIANTS, "Null"),
    # the names only: fragment sampling lives in
    # dynamics/collisions/breakup_fragmentations.py, as in the JAX package
    "fragmentation_function": (
        misc_families.FRAGMENTATION_FUNCTION_VARIANTS, "AlwaysN",
    ),
    "isotope_equilibrium_fractionation_factors": (
        _NULL | isotopes.EQUILIBRIUM_VARIANTS, "Null",
    ),
    "isotope_kinetic_fractionation_factors": (
        _NULL | isotopes.KINETIC_VARIANTS, "Null",
    ),
    "isotope_meteoric_water_line": (_NULL | isotopes.MWL_VARIANTS, "Null"),
    "isotope_ratio_evolution": (
        _NULL | isotopes.RATIO_EVOLUTION_VARIANTS, "Null",
    ),
    "isotope_diffusivity_ratios": (
        _NULL | isotopes.DIFFUSIVITY_RATIO_VARIANTS, "Null",
    ),
    "isotope_relaxation_timescale": (
        _NULL | isotopes.RELAXATION_TIMESCALE_VARIANTS, "Null",
    ),
    "isotope_temperature_inference": (
        _NULL | isotopes.TEMPERATURE_INFERENCE_VARIANTS, "Null",
    ),
    "isotope_ventilation_ratio": (
        _NULL | isotopes.VENTILATION_RATIO_VARIANTS, "Neglect",
    ),
}


def _bind(variant_classes, const, variant_name):
    """bind the staticmethods of ``variant_classes`` (one class, or the parts
    of a "+" name in order) to ``const`` as a namespace; on a name two
    parts share, the earlier part's formula is bound"""
    ns = SimpleNamespace()
    for variant_cls in variant_classes:
        for name in dir(variant_cls):
            if name.startswith("_") or hasattr(ns, name):
                continue
            fn = getattr(variant_cls, name)
            if callable(fn):
                setattr(ns, name, _partial_const(fn, const))
    ns.variant = variant_name
    return ns


def _partial_const(fn, const):
    def bound(*args, **kwargs):
        return fn(const, *args, **kwargs)

    bound.__name__ = getattr(fn, "__name__", "formula")
    bound.__doc__ = fn.__doc__
    return bound


def _default_seed():
    # reference PySDM/physics/constants.py:50-54
    return 44 if "CI" in os.environ else time.time_ns() % (2**31)


class Formulae:
    """selects variants + constants; attribute access yields bound namespaces
    (e.g. ``formulae.trivia.volume(radius=1e-6)``)"""

    def __init__(
        self,
        *,
        constants: dict = None,
        seed: int = None,
        fastmath: bool = True,  # accepted for API parity
        handle_all_breakups: bool = False,
        **variant_choices,
    ):
        for family in variant_choices:
            if family not in _FAMILIES:
                raise ValueError(f"unknown formula family: {family}")
        self.constants = make_constants(constants)
        self.seed = _default_seed() if seed is None else seed
        self.fastmath = fastmath
        self.handle_all_breakups = handle_all_breakups
        self._variant_names = {}
        for family, (variants, default) in _FAMILIES.items():
            name = variant_choices.get(family, default)
            parts = name.split("+")
            if not all(part in variants for part in parts):
                raise ValueError(
                    f"unknown variant {name!r} for family {family!r};"
                    f" known: {sorted(variants)}"
                )
            self._variant_names[family] = name
            setattr(self, family, _bind(
                [variants[part] for part in parts], self.constants, name
            ))

    def __str__(self):
        return "Formulae(" + ", ".join(
            f"{k}={v}" for k, v in sorted(self._variant_names.items())
        ) + ")"

    def get_constant(self, key):
        return getattr(self.constants, key)
