"""Dimensional analysis by scale covariance (port of
``pysdm_tpu/physics/dimensional_analysis.py``).

The reference checks formula unit-correctness by swapping its fake unit
registry for Pint inside a ``DimensionalAnalysis`` context
(reference ``PySDM/physics/dimensional_analysis.py:14-27``,
``impl/fake_unit_registry.py``). Pint cannot flow through jitted JAX code,
so the JAX package (and this port, which shares its formula bodies)
checks the same property — dimensional homogeneity — by
its defining symmetry instead: scale every base unit (length, mass, time,
temperature, amount) by an arbitrary factor, scale every *dimensional
constant* and every input accordingly, and a dimensionally-consistent
formula's output must scale exactly as its claimed dimension:

    f(inputs * lam^dims_in; constants * lam^dims_const)
        == f(inputs; constants) * lam^dims_out

This catches the same bug class as Pint (missing factors of rho, g, R, unit
mix-ups) with zero runtime cost outside tests, and it works with any
numeric backend (here NumPy arrays through the ``_xp`` bodies).

``Dimension`` is an (L, M, T, K, N) exponent vector; ``CONSTANT_DIMENSIONS``
declares the dimensions of the physical-constant catalog
(``constants.py`` <-> reference ``physics/constants_defaults.py``).
Constants not listed are dimensionless (unscaled). The port's table adds,
to the JAX package's, the constants of the variants it leaves out
(Seinfeld and Pandis' and Lowe's D and K, Grabowski et al.'s, Ruehl's
m_sigma, the celestial body's radius), and takes Ruehl's C0 as dimensionless (a bulk concentration of
the same kind as Cb_iso, which the table of the JAX package gives as an
area), so that every variant of the port can be checked.
"""

from collections import namedtuple

import numpy as np

from .formulae import Formulae

Dimension = namedtuple("Dimension", ("L", "M", "T", "K", "N"))
Dimension.__new__.__defaults__ = (0, 0, 0, 0, 0)

# base + common derived dimensions
DIMENSIONLESS = Dimension()
LENGTH = Dimension(L=1)
MASS = Dimension(M=1)
TIME = Dimension(T=1)
TEMPERATURE = Dimension(K=1)
AMOUNT = Dimension(N=1)
AREA = Dimension(L=2)
VOLUME = Dimension(L=3)
VELOCITY = Dimension(L=1, T=-1)
ACCELERATION = Dimension(L=1, T=-2)
DENSITY = Dimension(M=1, L=-3)
PRESSURE = Dimension(M=1, L=-1, T=-2)
ENERGY_PER_MASS = Dimension(L=2, T=-2)  # J/kg (latent heat)
SPECIFIC_HEAT = Dimension(L=2, T=-2, K=-1)  # J/kg/K
GAS_CONSTANT_MOLAR = Dimension(M=1, L=2, T=-2, K=-1, N=-1)  # J/mol/K
MOLAR_MASS = Dimension(M=1, N=-1)
SURFACE_TENSION = Dimension(M=1, T=-2)  # N/m = kg/s^2
DIFFUSIVITY = Dimension(L=2, T=-1)  # m^2/s
THERMAL_CONDUCTIVITY = Dimension(M=1, L=1, T=-3, K=-1)  # W/m/K
DYNAMIC_VISCOSITY = Dimension(M=1, L=-1, T=-1)  # Pa s
MOLAR_CONCENTRATION = Dimension(N=1, L=-3)
GROWTH_RESISTANCE = Dimension(T=1, L=-2)  # Fk/Fd: s/m^2
PER_TIME = Dimension(T=-1)
PER_VOLUME = Dimension(L=-3)
MASS_PER_AMOUNT_TIME = Dimension(M=1, N=-1, T=-1)

CONSTANT_DIMENSIONS = {
    # gas constants / molar masses (Mv / Rd / Rv / eps / l_tri / rho_STP are
    # derived in constants.compute_derived_values and scale automatically)
    "R_str": GAS_CONSTANT_MOLAR,
    "N_A": Dimension(N=-1),
    "Md": MOLAR_MASS,
    "M_1H": MOLAR_MASS,
    "M_2H": MOLAR_MASS,
    "M_3H": MOLAR_MASS,
    "M_16O": MOLAR_MASS,
    "M_17O": MOLAR_MASS,
    "M_18O": MOLAR_MASS,
    # thermodynamics
    "g_std": ACCELERATION,
    "rho_w": DENSITY,
    "rho_i": DENSITY,
    "rho_STP": DENSITY,
    "p_STP": PRESSURE,
    "T_STP": TEMPERATURE,
    "p1000": PRESSURE,
    "p_tri": PRESSURE,
    "T_tri": TEMPERATURE,
    "T0": TEMPERATURE,
    "dT_u": TEMPERATURE,
    "one_kelvin": TEMPERATURE,
    "L_tri": Dimension(M=1, L=2, T=-2, N=-1),  # molar latent heat J/mol
    "l_l19_a": DIMENSIONLESS,
    "l_l19_b": Dimension(K=-1),
    "MK05_SUB_C1": Dimension(M=1, L=2, T=-2, N=-1),
    "MK05_SUB_C2": Dimension(M=1, L=2, T=-2, N=-1, K=-1),
    "MK05_SUB_C3": Dimension(M=1, L=2, T=-2, N=-1, K=-2),
    "MK05_SUB_C4": Dimension(M=1, L=2, T=-2, N=-1),
    "c_pd": SPECIFIC_HEAT,
    "c_pv": SPECIFIC_HEAT,
    "c_pw": SPECIFIC_HEAT,
    "c_pi": SPECIFIC_HEAT,
    # saturation vapour pressure coefficients
    "ARM_C1": PRESSURE,
    "ARM_C3": TEMPERATURE,
    "FWC_C0": PRESSURE,
    "FWC_C1": Dimension(M=1, L=-1, T=-2, K=-1),
    "FWC_C2": Dimension(M=1, L=-1, T=-2, K=-2),
    "FWC_C3": Dimension(M=1, L=-1, T=-2, K=-3),
    "FWC_C4": Dimension(M=1, L=-1, T=-2, K=-4),
    "FWC_C5": Dimension(M=1, L=-1, T=-2, K=-5),
    "FWC_C6": Dimension(M=1, L=-1, T=-2, K=-6),
    "FWC_C7": Dimension(M=1, L=-1, T=-2, K=-7),
    "FWC_C8": Dimension(M=1, L=-1, T=-2, K=-8),
    "FWC_I0": PRESSURE,
    "FWC_I1": Dimension(M=1, L=-1, T=-2, K=-1),
    "FWC_I2": Dimension(M=1, L=-1, T=-2, K=-2),
    "FWC_I3": Dimension(M=1, L=-1, T=-2, K=-3),
    "FWC_I4": Dimension(M=1, L=-1, T=-2, K=-4),
    "FWC_I5": Dimension(M=1, L=-1, T=-2, K=-5),
    "FWC_I6": Dimension(M=1, L=-1, T=-2, K=-6),
    "FWC_I7": Dimension(M=1, L=-1, T=-2, K=-7),
    "FWC_I8": Dimension(M=1, L=-1, T=-2, K=-8),
    "B80W_G0": PRESSURE,
    "B80W_G2": TEMPERATURE,
    "L77W_A0": PRESSURE,
    "L77W_A1": Dimension(M=1, L=-1, T=-2, K=-1),
    "L77W_A2": Dimension(M=1, L=-1, T=-2, K=-2),
    "L77W_A3": Dimension(M=1, L=-1, T=-2, K=-3),
    "L77W_A4": Dimension(M=1, L=-1, T=-2, K=-4),
    "L77W_A5": Dimension(M=1, L=-1, T=-2, K=-5),
    "L77W_A6": Dimension(M=1, L=-1, T=-2, K=-6),
    "L77I_A0": PRESSURE,
    "L77I_A1": Dimension(M=1, L=-1, T=-2, K=-1),
    "L77I_A2": Dimension(M=1, L=-1, T=-2, K=-2),
    "L77I_A3": Dimension(M=1, L=-1, T=-2, K=-3),
    "L77I_A4": Dimension(M=1, L=-1, T=-2, K=-4),
    "L77I_A5": Dimension(M=1, L=-1, T=-2, K=-5),
    "L77I_A6": Dimension(M=1, L=-1, T=-2, K=-6),
    # Wexler 1976: exp(G0/T^2 + G1/T + G2 + G3 T + ... + G7 ln(T/1K)) * G8
    "W76W_G0": Dimension(K=2),
    "W76W_G1": Dimension(K=1),
    "W76W_G3": Dimension(K=-1),
    "W76W_G4": Dimension(K=-2),
    "W76W_G5": Dimension(K=-3),
    "W76W_G6": Dimension(K=-4),
    "W76W_G8": PRESSURE,
    "MK05_ICE_C1": PRESSURE,
    "MK05_ICE_C3": TEMPERATURE,
    "MK05_ICE_C5": TEMPERATURE,
    "MK05_ICE_C6": Dimension(K=-1),
    "MK05_LIQ_C1": PRESSURE,
    "MK05_LIQ_C3": TEMPERATURE,
    "MK05_LIQ_C5": TEMPERATURE,
    "MK05_LIQ_C6": Dimension(K=-1),
    "MK05_LIQ_C7": Dimension(K=-1),
    "MK05_LIQ_C8": TEMPERATURE,
    "MK05_LIQ_C10": TEMPERATURE,
    "MK05_LIQ_C12": TEMPERATURE,
    "MK05_LIQ_C13": Dimension(K=-1),
    "MK05_SUB_C5": TEMPERATURE,
    # diffusion / conduction
    "D0": DIFFUSIVITY,
    "K0": THERMAL_CONDUCTIVITY,
    "dv_pair_D0": DIFFUSIVITY,
    "dv_pair_K0": THERMAL_CONDUCTIVITY,
    "diffusion_thermics_D_G11_A": DIFFUSIVITY,
    "diffusion_thermics_D_G11_B": Dimension(K=-1),
    "diffusion_thermics_K_G11_A": Dimension(M=1, L=1, T=-3, K=-4),
    "diffusion_thermics_K_G11_B": Dimension(M=1, L=1, T=-3, K=-3),
    "diffusion_thermics_K_G11_C": Dimension(M=1, L=1, T=-3, K=-2),
    "diffusion_thermics_K_G11_D": THERMAL_CONDUCTIVITY,
    "d_l19_a": DIFFUSIVITY,
    "k_l19_a": THERMAL_CONDUCTIVITY,
    "k_l19_c": Dimension(K=-1),
    "dv_pk05": LENGTH,
    "celestial_body_radius": LENGTH,
    "MONTEIRO_2024_D_COEFF": DIFFUSIVITY,
    "TRACY_2008_D_COEFF": DIFFUSIVITY,
    "K_thermo_sp_2010_a": THERMAL_CONDUCTIVITY,
    "K_thermo_sp_2010_b": Dimension(M=1, L=1, T=-3, K=-2),
    # surface tension
    "sgm_w": SURFACE_TENSION,
    "sgm_i": SURFACE_TENSION,
    "sgm_org": SURFACE_TENSION,
    "delta_min": LENGTH,
    "RUEHL_nu_org": Dimension(L=3, N=-1),
    "RUEHL_A0": AREA,
    "RUEHL_C0": DIMENSIONLESS,
    "RUEHL_m_sigma": Dimension(M=1, T=-2, L=-2),  # J/m^2 per m^2
    "RUEHL_sgm_min": SURFACE_TENSION,
    # chemistry
    "M": MOLAR_CONCENTRATION,
    "K_H2O": Dimension(N=2, L=-6),
    # viscosity
    "ZWAB_Tc": TEMPERATURE,
    "air_eta_ZWAB_mu0": DYNAMIC_VISCOSITY,
    # terminal velocity (v = K r^2 | K r | K sqrt(r) per size regime)
    "ROGERS_YAU_TERM_VEL_SMALL_K": Dimension(L=-1, T=-1),
    "ROGERS_YAU_TERM_VEL_MEDIUM_K": PER_TIME,
    "ROGERS_YAU_TERM_VEL_LARGE_K": Dimension(L=0.5, T=-1),
    "ROGERS_YAU_TERM_VEL_SMALL_R_LIMIT": LENGTH,
    "ROGERS_YAU_TERM_VEL_MEDIUM_R_LIMIT": LENGTH,
    # freezing
    "J_HET": Dimension(L=-2, T=-1),
    "ABIFM_UNIT": Dimension(L=-2, T=-1),
    "KOOP_UNIT": Dimension(L=-3, T=-1),
    "KOOP_MIN_DA_W_ICE": DIMENSIONLESS,
    # misc
    "CM": LENGTH,
    "UM": LENGTH,
    "asymmetry_g": DIMENSIONLESS,
    "water_molar_volume": Dimension(L=3, N=-1),
    "rho_STP_over_rho_w": DIMENSIONLESS,
}


def scale_factor(dimension, lam):
    """lam is a Dimension-shaped tuple of per-base-unit scale factors"""
    return float(
        np.prod([l ** d for l, d in zip(lam, dimension)], dtype=float)
    )


def scaled_constants(lam, base_constants=None, extra_dims=None):
    """constant-catalog overrides with every dimensional constant scaled"""
    from . import constants as constants_mod

    dims = dict(CONSTANT_DIMENSIONS)
    if extra_dims:
        dims.update(extra_dims)
    base = base_constants or {}
    overrides = {}
    for name, dim in dims.items():
        factor = scale_factor(dim, lam)
        if factor == 1.0:
            continue
        if name in base:
            value = base[name]
        else:
            value = constants_mod.DEFAULTS.get(name)
            if value is None:
                continue
        overrides[name] = value * factor
    overrides.update(
        {k: v for k, v in base.items() if k not in overrides}
    )
    return overrides


class DimensionalAnalysis:
    """check dimensional homogeneity of formulae via scale covariance.

    usage:
        da = DimensionalAnalysis(formulae_kwargs={...}, seed=0)
        da.check(
            lambda f: f.saturation_vapour_pressure.pvs_water,
            in_dims=(TEMPERATURE,),
            out_dim=PRESSURE,
            args=(283.0,),
        )
    """

    def __init__(self, formulae_kwargs=None, lam=None, rtol=1e-9):
        self.formulae_kwargs = formulae_kwargs or {}
        # scale factors chosen exactly representable to keep float error low
        self.lam = lam or Dimension(L=2.0, M=4.0, T=0.5, K=2.0, N=8.0)
        self.rtol = rtol
        base_consts = dict(self.formulae_kwargs.pop("constants", {}))
        self.base = Formulae(
            constants=dict(base_consts), **self.formulae_kwargs
        )
        self.scaled = Formulae(
            constants=scaled_constants(self.lam, base_consts),
            **self.formulae_kwargs,
        )

    def check(self, fn_of_formulae, *, in_dims, out_dim, args, kwargs=None):
        kwargs = kwargs or {}
        out_base = np.asarray(
            fn_of_formulae(self.base)(*args, **kwargs), dtype=float
        )
        scaled_args = tuple(
            np.asarray(a, dtype=float) * scale_factor(d, self.lam)
            for a, d in zip(args, in_dims)
        )
        out_scaled = np.asarray(
            fn_of_formulae(self.scaled)(*scaled_args, **kwargs), dtype=float
        )
        expected = out_base * scale_factor(out_dim, self.lam)
        np.testing.assert_allclose(
            out_scaled,
            expected,
            rtol=self.rtol,
            err_msg=(
                "dimensional inhomogeneity detected: output does not scale "
                f"as {out_dim} when inputs scale as {in_dims}"
            ),
        )
        return out_base
