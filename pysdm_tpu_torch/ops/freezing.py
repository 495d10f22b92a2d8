"""Freezing and thaw as tensor functions (port of
``pysdm_tpu/ops/freezing.py``; reference
``PySDM/backends/impl_numba/methods/freezing_methods.py``): freezing flips
the sign of the signed water mass (negative is ice). Singular freezing
reads the freezing-temperature attribute; time-dependent freezing draws a
Poisson event of J_het * A_insol or J_hom * V per drop from a u01 row.
Each function writes only its own drop's value, elementwise."""

import torch


def a_w_ice_and_rh_ice(formulae, T, RH):
    """the water activity of ice and the RH over ice from the cell's T and
    RH (reference ``physics_methods.py`` ``_a_w_ice_body``)"""
    pvs_w = formulae.saturation_vapour_pressure.pvs_water(T)
    pvs_i = formulae.saturation_vapour_pressure.pvs_ice(T)
    return pvs_i / pvs_w, RH * pvs_w / pvs_i


def thaw_mask(formulae, signed_mass, T_drop, thaw):
    """the frozen drops above the freezing point, where ``thaw`` is on"""
    if not thaw:
        return torch.zeros_like(signed_mass, dtype=torch.bool)
    return formulae.trivia.frozen_and_above_freezing_point(signed_mass, T_drop)


def freeze_singular(
    *, formulae, signed_mass, freezing_temperature, T_drop, RH_drop, thaw
):
    """freeze where T fell below the singular freezing temperature
    (reference ``_freeze_singular_body``)"""
    has_inp = freezing_temperature != 0
    thawing = thaw_mask(formulae, signed_mass, T_drop, thaw) & has_inp
    freezing = (
        has_inp
        & ~thawing
        & formulae.trivia.unfrozen_and_saturated(signed_mass, RH_drop)
        & (T_drop <= freezing_temperature)
    )
    return torch.where(freezing | thawing, -signed_mass, signed_mass)


def freeze_time_dependent(
    *, formulae, rand, signed_mass, immersed_surface_area,
    T_drop, RH_drop, a_w_ice_drop, dt, thaw,
):
    """immersion freezing as a Poisson event of J_het A_insol
    (reference ``_freeze_time_dependent_body``)"""
    has_insol = immersed_surface_area != 0
    thawing = thaw_mask(formulae, signed_mass, T_drop, thaw) & has_insol
    candidate = (
        has_insol
        & ~thawing
        & formulae.trivia.unfrozen_and_saturated(signed_mass, RH_drop)
    )
    rate = (
        formulae.heterogeneous_ice_nucleation_rate.j_het(a_w_ice_drop)
        * immersed_surface_area
    )
    prob = 1.0 - formulae.trivia.poissonian_avoidance_function(rate, dt)
    freezing = candidate & (rand < prob)
    return torch.where(freezing | thawing, -signed_mass, signed_mass)


def freeze_time_dependent_homogeneous(
    *, formulae, rand, signed_mass, volume,
    T_drop, RH_ice_drop, a_w_ice_drop, dt, thaw,
):
    """homogeneous freezing as a Poisson event of J_hom V
    (reference ``_freeze_time_dependent_homogeneous_body``)"""
    f = formulae.homogeneous_ice_nucleation_rate
    thawing = thaw_mask(formulae, signed_mass, T_drop, thaw)
    candidate = ~thawing & formulae.trivia.unfrozen_and_ice_saturated(
        signed_mass, RH_ice_drop
    )
    d_a_w_ice = (RH_ice_drop - 1.0) * a_w_ice_drop
    in_range = f.d_a_w_ice_within_range(d_a_w_ice)
    d_a_w_ice = f.d_a_w_ice_maximum(d_a_w_ice)
    rate = f.j_hom(T_drop, d_a_w_ice) * volume
    prob = 1.0 - formulae.trivia.poissonian_avoidance_function(rate, dt)
    freezing = candidate & in_range & (rand < prob)
    return torch.where(freezing | thawing, -signed_mass, signed_mass)
