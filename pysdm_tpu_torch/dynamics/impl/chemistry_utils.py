"""Aqueous-chemistry tables, a NumPy-only copy of
``pysdm_tpu/dynamics/impl/chemistry_utils.py`` (reference
``PySDM/dynamics/impl/chemistry_utils.py``): Henry, equilibrium and kinetic
constants (Kreidenweis et al. 2003, Table 4), gas diffusion and mass
accommodation, compound registries. Molar masses are standard-atomic-weight
literals (g/mol), as in the JAX package.

``EqConst.at`` and ``KinConst.at`` evaluate through the bound trivia, so they
take a Python float, a NumPy array or a tensor (keeping its dtype and
device); ``KinConst``'s pre-factor ``A`` is a host float64."""

import numpy as np

from ...physics.si import si

# molar masses [g/mol] (standard atomic weights; chempy-equivalent values)
_MOLAR_MASS_G_MOL = {
    "HNO3": 63.013,
    "H2O2": 34.015,
    "NH3": 17.031,
    "SO2": 64.064,
    "CO2": 44.009,
    "O3": 47.998,
    "SO2 H2O": 82.079,
    "HSO3": 81.071,
    "SO3": 80.063,
    "CO2 H2O": 62.024,
    "HCO3": 61.016,
    "CO3": 60.008,
    "NO3": 62.004,
    "NH4": 18.039,
    "H2O NH3": 35.046,
    "SO4": 96.06,
    "HSO4": 97.068,
}

GASEOUS_COMPOUNDS = {
    "N_V": "HNO3",
    "H2O2": "H2O2",
    "N_mIII": "NH3",
    "S_IV": "SO2",
    "C_IV": "CO2",
    "O3": "O3",
}

AQUEOUS_COMPOUNDS = {
    "S_IV": ("SO2 H2O", "HSO3", "SO3"),
    "O3": ("O3",),
    "H2O2": ("H2O2",),
    "C_IV": ("CO2 H2O", "HCO3", "CO3"),
    "N_V": ("HNO3", "NO3"),
    "N_mIII": ("NH4", "H2O NH3"),
    "S_VI": ("SO4", "HSO4"),
}

DIFFUSION_CONST = {
    "HNO3": 65.25e-6 * si.m**2 / si.s,
    "H2O2": 87.00e-6 * si.m**2 / si.s,
    "NH3": 19.78e-6 * si.m**2 / si.s,
    "SO2": 10.89e-6 * si.m**2 / si.s,
    "CO2": 13.81e-6 * si.m**2 / si.s,
    "O3": 14.44e-6 * si.m**2 / si.s,
}

MASS_ACCOMMODATION_COEFFICIENTS = {
    "HNO3": 0.05,
    "H2O2": 0.018,
    "NH3": 0.05,
    "SO2": 0.035,
    "CO2": 0.05,
    "O3": 0.00053,
}


class SpecificGravities:
    """molar mass / dry-air molar mass"""

    def __init__(self, constants):
        self._values = {
            compound: mass * si.gram / si.mole / constants.Md
            for compound, mass in _MOLAR_MASS_G_MOL.items()
        }

    def __getitem__(self, item):
        return self._values[item]


class EqConst:
    """van't-Hoff temperature-dependent equilibrium constant"""

    def __init__(self, formulae, constant_at_T0, dT, T_0):
        self.formulae = formulae
        self.K = constant_at_T0
        self.dH = formulae.trivia.tdep2enthalpy(dT)
        self.T0 = T_0

    def at(self, T):
        return self.formulae.trivia.vant_hoff(self.K, self.dH, T, T_0=self.T0)


class KinConst:
    """Arrhenius temperature-dependent kinetic constant"""

    def __init__(self, formulae, k, dT, T_0):
        self.formulae = formulae
        self.Ea = formulae.trivia.tdep2enthalpy(dT)
        self.A = k * np.exp(self.Ea / (formulae.constants.R_str * T_0))

    def at(self, T):
        return self.formulae.trivia.arrhenius(self.A, self.Ea, T)


def henry_consts(formulae):
    const = formulae.constants
    T0 = const.ROOM_TEMP
    return {
        "HNO3": EqConst(formulae, 2.1e5 * const.H_u, 8700 * const.dT_u, T_0=T0),
        "H2O2": EqConst(formulae, 7.45e4 * const.H_u, 7300 * const.dT_u, T_0=T0),
        "NH3": EqConst(formulae, 62 * const.H_u, 4110 * const.dT_u, T_0=T0),
        "SO2": EqConst(formulae, 1.23 * const.H_u, 3150 * const.dT_u, T_0=T0),
        "CO2": EqConst(formulae, 3.4e-2 * const.H_u, 2440 * const.dT_u, T_0=T0),
        "O3": EqConst(formulae, 1.13e-2 * const.H_u, 2540 * const.dT_u, T_0=T0),
    }


def equilibrium_consts(formulae):
    const = formulae.constants
    T0 = const.ROOM_TEMP
    return {
        "K_HNO3": EqConst(formulae, 15.4 * const.M, 8700 * const.dT_u, T_0=T0),
        "K_SO2": EqConst(formulae, 1.3e-2 * const.M, 1960 * const.dT_u, T_0=T0),
        "K_NH3": EqConst(formulae, 1.7e-5 * const.M, -450 * const.dT_u, T_0=T0),
        "K_CO2": EqConst(formulae, 4.3e-7 * const.M, -1000 * const.dT_u, T_0=T0),
        "K_HSO3": EqConst(formulae, 6.6e-8 * const.M, 1500 * const.dT_u, T_0=T0),
        "K_HCO3": EqConst(formulae, 4.68e-11 * const.M, -1760 * const.dT_u, T_0=T0),
        "K_HSO4": EqConst(formulae, 1.2e-2 * const.M, 2720 * const.dT_u, T_0=T0),
    }


def kinetic_consts(formulae):
    const = formulae.constants
    T0 = const.ROOM_TEMP
    M = const.M
    return {
        "k0": KinConst(formulae, k=2.4e4 / si.s / M, dT=0 * const.dT_u, T_0=T0),
        "k1": KinConst(formulae, k=3.5e5 / si.s / M, dT=-5530 * const.dT_u, T_0=T0),
        "k2": KinConst(formulae, k=1.5e9 / si.s / M, dT=-5280 * const.dT_u, T_0=T0),
        "k3": KinConst(formulae, k=7.45e7 / si.s / M / M, dT=-4430 * const.dT_u, T_0=T0),
    }

