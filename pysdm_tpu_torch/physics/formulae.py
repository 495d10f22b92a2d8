"""Formulae engine (API parity with ``pysdm_tpu/physics/formulae.py``): one
variant per physics family, bound to a frozen constants namespace.

The port binds the families the box, parcel, 2D warm-rain and breakup
slices read, with the JAX package's defaults (``pysdm_tpu/physics/formulae.py:86-118``). Choosing a
variant the port does not have yet raises ``NotImplementedError`` naming
the ROADMAP item or slice that brings it; so does choosing any variant of a
family the port does not bind yet.
"""

import os
import time
from types import SimpleNamespace

from . import (
    diffusion_kinetics,
    diffusion_thermics,
    drop_growth,
    hygroscopicity,
    latent_heat,
    misc_families,
    saturation_vapour_pressure,
    state_variable_triplet,
)
from .constants import make_constants
from .particle_shape_and_density import VARIANTS as SHAPE_VARIANTS
from .trivia import Trivia

_SLICE_5 = "slice 5 (ice, chemistry, isotopes, optics)"
_PHYSICS = "ROADMAP queue 1 item 3 (the rest of physics/)"

# family -> (ported variants, default, where the other variants come from)
_FAMILIES = {
    "trivia": ({"Trivia": Trivia}, "Trivia", None),
    "particle_shape_and_density": (SHAPE_VARIANTS, "LiquidSpheres", _SLICE_5),
    "diffusion_coordinate": (
        misc_families.DIFFUSION_COORDINATE_VARIANTS, "WaterMassLogarithm",
        _PHYSICS,
    ),
    "saturation_vapour_pressure": (
        saturation_vapour_pressure.VARIANTS, "FlatauWalkoCotton", _PHYSICS,
    ),
    "latent_heat_vapourisation": (
        latent_heat.VAPOURISATION_VARIANTS, "Kirchhoff", _PHYSICS,
    ),
    "hygroscopicity": (
        hygroscopicity.VARIANTS, "KappaKoehlerLeadingTerms", _PHYSICS,
    ),
    "drop_growth": (drop_growth.VARIANTS, "Mason1971", _PHYSICS),
    "surface_tension": (
        misc_families.SURFACE_TENSION_VARIANTS, "Constant", _PHYSICS,
    ),
    "diffusion_kinetics": (diffusion_kinetics.VARIANTS, "FuchsSutugin", _PHYSICS),
    "diffusion_thermics": (diffusion_thermics.VARIANTS, "Neglect", _PHYSICS),
    "ventilation": (misc_families.VENTILATION_VARIANTS, "Neglect", _PHYSICS),
    "state_variable_triplet": (
        state_variable_triplet.VARIANTS, "LibcloudphPlusPlus", _PHYSICS,
    ),
    "particle_advection": (
        misc_families.PARTICLE_ADVECTION_VARIANTS, "ImplicitInSpace", _PHYSICS,
    ),
    "terminal_velocity": (
        misc_families.TERMINAL_VELOCITY_VARIANTS, "GunnKinzer1949", _PHYSICS,
    ),
    "hydrostatics": (
        misc_families.HYDROSTATICS_VARIANTS,
        "ConstantGVapourMixingRatioAndThetaStd", _PHYSICS,
    ),
    "air_dynamic_viscosity": (
        misc_families.AIR_DYNAMIC_VISCOSITY_VARIANTS, "ZografosEtAl1987",
        _PHYSICS,
    ),
    # the names only: fragment sampling lives in
    # dynamics/collisions/breakup_fragmentations.py, as in the JAX package
    "fragmentation_function": (
        misc_families.FRAGMENTATION_FUNCTION_VARIANTS, "AlwaysN", None,
    ),
}

# families of the JAX package that the port does not bind yet
_LATER_FAMILIES = {
    name: _SLICE_5
    for name in (
        "latent_heat_sublimation", "diffusion_ice_kinetics",
        "diffusion_ice_capacity", "freezing_temperature_spectrum",
        "heterogeneous_ice_nucleation_rate",
        "homogeneous_ice_nucleation_rate",
        "isotope_equilibrium_fractionation_factors",
        "isotope_kinetic_fractionation_factors",
        "isotope_meteoric_water_line", "isotope_ratio_evolution",
        "isotope_diffusivity_ratios", "isotope_relaxation_timescale",
        "isotope_temperature_inference", "isotope_ventilation_ratio",
        "optical_albedo", "optical_depth", "bulk_phase_partitioning",
    )
}


def _bind(variant_cls, const, variant_name):
    """bind a variant class's staticmethods to ``const`` as a namespace"""
    ns = SimpleNamespace()
    for name in dir(variant_cls):
        if name.startswith("_"):
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
            if family in _LATER_FAMILIES:
                raise NotImplementedError(
                    f"formula family {family!r} is not ported yet: it comes"
                    f" with {_LATER_FAMILIES[family]}"
                )
            if family not in _FAMILIES:
                raise ValueError(f"unknown formula family: {family}")
        self.constants = make_constants(constants)
        self.seed = _default_seed() if seed is None else seed
        self.fastmath = fastmath
        self.handle_all_breakups = handle_all_breakups
        self._variant_names = {}
        for family, (variants, default, later) in _FAMILIES.items():
            name = variant_choices.get(family, default)
            if name not in variants:
                raise NotImplementedError(
                    f"variant {name!r} of {family!r} is not ported yet: it"
                    f" comes with {later}; ported: {sorted(variants)}"
                )
            self._variant_names[family] = name
            setattr(self, family, _bind(variants[name], self.constants, name))

    def __str__(self):
        return "Formulae(" + ", ".join(
            f"{k}={v}" for k, v in sorted(self._variant_names.items())
        ) + ")"

    def get_constant(self, key):
        return getattr(self.constants, key)
