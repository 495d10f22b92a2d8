"""Aqueous-chemistry ops (port of ``pysdm_tpu/ops/chemistry.py``; reference
``PySDM/backends/impl_numba/methods/chemistry_methods.py``): Henry-law
dissolution with kinetic uptake, S(IV) -> S(VI) oxidation by O3 and H2O2,
and pH from electroneutrality.

Every function is elementwise over drops, on the device of its tensors.
The pH solve is the JAX package's fixed-count bisection in log H over
[H_min, H_max] (48 iterations, midpoint rule), with no early exit, so it
reads nothing back from the device; on the card it is one kernel
(``cuda/chemistry.py``). The per-cell uptake of the closed
system is summed in float64 in a fixed order (``ops/moments.py``
``cell_sums``), never by a float atomic add.
"""

import math

import torch

from ..dynamics.impl.chemistry_utils import (
    DIFFUSION_CONST,
    MASS_ACCOMMODATION_COEFFICIENTS,
)
# the pH solve: on CPU tensors the eager twin, on CUDA tensors the Hopper
# kernel ``csrc/chemistry.cu`` (one launch), on any other device or dtype
# an error
from .cuda.chemistry import (  # noqa: F401
    acidity_residual,
    acidity_terms,
    equilibrate_H,
)
from .moments import cell_sums


def dissociation_factor(compound, H, eqc):
    """effective-Henry dissociation enhancement per droplet
    (reference ``DISSOCIATION_FACTORS``); eqc entries per droplet"""
    if compound == "CO2":
        return 1 + eqc["K_CO2"] * (1 / H + eqc["K_HCO3"] / H**2)
    if compound == "SO2":
        return 1 + eqc["K_SO2"] * (1 / H + eqc["K_HSO3"] / H**2)
    if compound == "NH3":
        return 1 + eqc["K_NH3"] / eqc["K_H2O"] * H
    if compound == "HNO3":
        return 1 + eqc["K_HNO3"] / H
    return torch.ones_like(H)


def acidity_minfun(H, conc, K, K_H2O):
    """electroneutrality residual (reference ``acidity_minfun``), increasing
    in H"""
    return acidity_residual(H, acidity_terms(conc, K), K_H2O)


def calc_ionic_strength(H, conc, K, K_H2O):
    """reference ``calc_ionic_strength`` (libcloudph++ heritage)"""
    water = H + K_H2O / H
    cz_S_VI = H * conc["S_VI"] / (H + K["K_HSO4"]) + 4 * K["K_HSO4"] * conc[
        "S_VI"
    ] / (H + K["K_HSO4"])
    den_C = H * H + K["K_CO2"] * H + K["K_CO2"] * K["K_HCO3"]
    cz_CO2 = (
        K["K_CO2"] * H * conc["C_IV"] / den_C
        + 4 * K["K_CO2"] * K["K_HCO3"] * conc["C_IV"] / den_C
    )
    den_S = H * H + K["K_SO2"] * H + K["K_SO2"] * K["K_HSO3"]
    cz_SO2 = (
        K["K_SO2"] * H * conc["S_IV"] / den_S
        + 4 * K["K_SO2"] * K["K_HSO3"] * conc["S_IV"] / den_S
    )
    cz_HNO3 = K["K_HNO3"] * conc["N_V"] / (H + K["K_HNO3"])
    cz_NH3 = K["K_NH3"] * H * conc["N_mIII"] / (K_H2O + K["K_NH3"] * H)
    return 0.5 * (water + cz_S_VI + cz_CO2 + cz_SO2 + cz_HNO3 + cz_NH3)


def dissolution_step(
    *,
    compound,
    moles,
    multiplicity_f,
    droplet_volume,
    alive,
    env_mixing_ratio_cell,
    henry_const_cell,
    dissoc_factor_drop,
    T_cell,
    p_cell,
    rhod_cell,
    cell_of_drop,
    dt,
    dv,
    system_type,
    specific_gravity,
    const,
    n_cell,
    radius_fn,
):
    """implicit Henry-uptake update for one gaseous compound (reference
    ``dissolution_body``); returns (new moles, new env mixing ratio)"""
    T = T_cell[cell_of_drop]
    p = p_cell[cell_of_drop]
    env_mr = env_mixing_ratio_cell[cell_of_drop]
    H_eff = henry_const_cell[cell_of_drop] * dissoc_factor_drop

    Mc = specific_gravity * const.Md
    Rc = const.R_str / Mc
    cinf = p / T / (const.Rd / env_mr + Rc) / Mc
    safe_vol = torch.where(alive, droplet_volume, 1e-30)
    r_w = radius_fn(volume=safe_vol)
    v_avg = torch.sqrt(8 * const.R_str * T / (math.pi * Mc))
    alpha = MASS_ACCOMMODATION_COEFFICIENTS[compound]
    D = DIFFUSION_CONST[compound]
    dt_over_scale = dt / (4 * r_w / (3 * v_avg * alpha) + r_w**2 / (3 * D))
    A_old = moles / safe_vol
    A_new = (A_old + dt_over_scale * cinf) / (
        1 + dt_over_scale / H_eff / const.R_str / T
    )
    new_moles = torch.where(alive, A_new * safe_vol, moles)
    taken = torch.where(alive, multiplicity_f * (new_moles - moles), 0.0)
    taken_cell = cell_sums(taken, cell_of_drop, n_cell)
    delta_mr = taken_cell * specific_gravity * const.Md / (dv * rhod_cell)
    if system_type == "closed":
        # the independent per-droplet implicit updates can together overdraw
        # the finite gas reservoir (the reference asserts here,
        # ``dissolution_body``); scale the uptake to what is available
        scale = torch.where(
            delta_mr > env_mixing_ratio_cell,
            env_mixing_ratio_cell / torch.where(delta_mr > 0, delta_mr, 1.0),
            1.0,
        )
        new_moles = moles + (new_moles - moles) * scale[cell_of_drop]
        env_mixing_ratio_cell = env_mixing_ratio_cell - delta_mr * scale
    return new_moles, env_mixing_ratio_cell


def oxidation_step(
    *,
    moles_O3,
    moles_H2O2,
    moles_S_IV,
    moles_S_VI,
    H_drop,
    droplet_volume,
    alive,
    k0,
    k1,
    k2,
    k3,
    k4,
    K_SO2,
    K_HSO3,
    dissoc_factor_SO2,
    dt,
):
    """S(IV) -> S(VI) oxidation by ozone and hydrogen peroxide (reference
    ``oxidation_body``); per-droplet k and K values pre-gathered. A drop
    whose update would take any amount below zero keeps its amounts."""
    safe_vol = torch.where(alive, droplet_volume, 1e-30)
    H = H_drop
    SO2aq = moles_S_IV / safe_vol / dissoc_factor_SO2
    ozone = (
        (k0 + k1 * K_SO2 / H + k2 * K_SO2 * K_HSO3 / H**2)
        * (moles_O3 / safe_vol)
        * SO2aq
    )
    peroxide = k3 * K_SO2 / (1 + k4 * H) * (moles_H2O2 / safe_vol) * SO2aq
    dtv = dt * safe_vol

    new_O3 = moles_O3 - ozone * dtv
    new_S_IV = moles_S_IV - (ozone + peroxide) * dtv
    new_H2O2 = moles_H2O2 - peroxide * dtv
    new_S_VI = moles_S_VI + (ozone + peroxide) * dtv
    ok = (
        alive
        & (new_O3 >= 0)
        & (new_S_IV >= 0)
        & (new_H2O2 >= 0)
        & (new_S_VI >= 0)
    )
    return (
        torch.where(ok, new_O3, moles_O3),
        torch.where(ok, new_H2O2, moles_H2O2),
        torch.where(ok, new_S_IV, moles_S_IV),
        torch.where(ok, new_S_VI, moles_S_VI),
    )
