"""Singer & Ward: organic-film surface tension and the Koehler curves of
secondary-organic-aerosol and ammonium-sulfate mixtures (port of
``pysdm_tpu/models/singer_ward.py``; reference
``examples/PySDM_examples/Singer_Ward/aerosol.py`` + ``kohler.ipynb``):
beta-caryophyllene and alpha-pinene oxidation products (dark ozonolysis and
UV photo-oxidation), compared across the ``Constant``,
``CompressedFilmOvadnevaite``, ``CompressedFilmRuehl`` and
``SzyszkowskiLangmuir`` surface tensions. Formulae only, on the host; no
dynamics."""

import numpy as np

from ..initialisation.aerosol_composition import DryAerosolMixture
from ..initialisation.spectra import Lognormal
from ..physics import si
from ..physics.formulae import Formulae

#: chempy Substance.from_formula("(NH4)2SO4").mass (the reference computes
#: this at import time; hardcoded here — no chempy dependency)
M_AMSULF = 132.14 * si.g / si.mole


class _SOAAerosol(DryAerosolMixture):
    """one SOA compound mixed with ammonium sulfate (reference keeps the
    reference's solubility flags: the organic partitions into the film)"""

    organic = None
    molar_mass = None
    density = None
    color = None

    def __init__(self, water_molar_volume: float, Forg: float = 0.8,
                 N: float = 400):
        organic = self.organic
        mode = {"(NH4)2SO4": (1 - Forg), organic: Forg}
        super().__init__(
            compounds=("(NH4)2SO4", organic),
            molar_masses={"(NH4)2SO4": M_AMSULF, organic: self.molar_mass},
            densities={
                "(NH4)2SO4": 1.77 * si.g / si.cm**3,
                organic: self.density,
            },
            is_soluble={"(NH4)2SO4": False, organic: True},
            ionic_dissociation_phi={"(NH4)2SO4": 3, organic: 1},
        )
        self.modes = (
            {
                "f_org": 1 - self.f_soluble_volume(mode),
                "kappa": self.kappa(
                    mass_fractions=mode,
                    water_molar_volume=water_molar_volume,
                ),
                "nu_org": self.nu_org(mode),
                "spectrum": Lognormal(
                    norm_factor=N / si.cm**3,
                    m_mode=50.0 * si.nm,
                    s_geom=1.75,
                ),
            },
        )


class AerosolBetaCaryophylleneDark(_SOAAerosol):
    organic = "bcary_dark"
    molar_mass = 299 * si.g / si.mole
    density = 1.20 * si.g / si.cm**3
    color = "red"


class AerosolBetaCaryophylleneLight(_SOAAerosol):
    organic = "bcary_light"
    molar_mass = 360 * si.g / si.mole
    density = 1.50 * si.g / si.cm**3
    color = "orange"


class AerosolAlphaPineneDark(_SOAAerosol):
    organic = "apinene_dark"
    molar_mass = 209 * si.g / si.mole
    density = 1.27 * si.g / si.cm**3
    color = "green"


class AerosolAlphaPineneLight(_SOAAerosol):
    organic = "apinene_light"
    molar_mass = 265 * si.g / si.mole
    density = 1.51 * si.g / si.cm**3
    color = "lightgreen"


AEROSOL_CLASSES = (
    AerosolBetaCaryophylleneDark,
    AerosolBetaCaryophylleneLight,
    AerosolAlphaPineneDark,
    AerosolAlphaPineneLight,
)


def make_formulae(surface_tension, aerosol_mode, *, temperature=300 * si.K):
    """a Formulae instance with the film-model constants filled from the
    aerosol mode (reference ``kohler.ipynb`` Formulae setup)"""
    constants = {}
    if surface_tension == "CompressedFilmOvadnevaite":
        constants = {"sgm_org": 40 * si.mN / si.m, "delta_min": 0.1 * si.nm}
    elif surface_tension in ("CompressedFilmRuehl", "SzyszkowskiLangmuir"):
        constants = {
            "RUEHL_nu_org": aerosol_mode["nu_org"],
            "RUEHL_A0": 115e-20 * si.m**2,
            "RUEHL_C0": 6e-7,
            "RUEHL_m_sigma": 0.3e17 * si.J / si.m**2,
            "RUEHL_sgm_min": 40 * si.mN / si.m,
        }
    return Formulae(surface_tension=surface_tension, constants=constants)


def kohler_curve(
    *,
    surface_tension,
    aerosol,
    r_dry=50 * si.nm,
    temperature=300 * si.K,
    r_wet=None,
):
    """equilibrium supersaturation vs wet radius for the aerosol's single
    mode under the given surface-tension family"""
    mode = aerosol.modes[0]
    formulae = make_formulae(
        surface_tension, mode, temperature=temperature
    )
    f = formulae
    r_wet = (
        np.logspace(np.log10(r_dry * 1.1), np.log10(3 * si.um), 100)
        if r_wet is None
        else r_wet
    )
    v_dry = float(f.trivia.volume(radius=r_dry))
    v_wet = np.asarray(f.trivia.volume(radius=r_wet))
    sigma = np.asarray(
        f.surface_tension.sigma(temperature, v_wet, v_dry, mode["f_org"])
    )
    RH_eq = np.asarray(
        f.hygroscopicity.RH_eq(
            r_wet,
            temperature,
            mode["kappa"][surface_tension]
            if isinstance(mode["kappa"], dict)
            else mode["kappa"],
            v_dry / f.constants.PI_4_3,
            sigma,
        )
    )
    return {"r_wet": r_wet, "supersaturation": RH_eq - 1, "sigma": sigma}
