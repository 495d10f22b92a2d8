"""Abdul-Razzak & Ghan 2000 (JGR 105) activation setup, config #3 (port
of ``pysdm_tpu/models/abdul_razzak_ghan_2000.py``; reference
``examples/PySDM_examples/Abdul_Razzak_Ghan_2000/run_ARG_parcel.py`` +
``aerosol.py``): a two-mode ammonium-sulfate/insoluble aerosol, a parcel
ascent with condensation, and the per-mode activated fraction diagnosed on
the host both from the critical saturation against the peak RH and from
the critical volume against the droplet volume.

``run_parcel`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..environments import Parcel
from ..initialisation import spectra
from ..initialisation.aerosol_composition import DryAerosolMixture
from ..initialisation.equilibrate_wet_radii import equilibrate_wet_radii
from ..initialisation.sampling.spectral_sampling import ConstantMultiplicity
from ..physics import Formulae, si
from ..products import (
    AmbientRelativeHumidity,
    ParcelDisplacement,
    PeakSupersaturation,
    WaterMixingRatio,
)

CONSTANTS_ARG = {
    "Mv": 18.015 * si.g / si.mol,
    "Md": 28.97 * si.g / si.mol,
}


class AerosolARG(DryAerosolMixture):
    """two-mode (NH4)2SO4 + insoluble mixture
    (reference ``Abdul_Razzak_Ghan_2000/aerosol.py:16-57``)"""

    def __init__(
        self,
        water_molar_volume,
        M2_sol=0.0,
        M2_N=100 / si.cm**3,
        M2_rad=50 * si.nm,
    ):
        super().__init__(
            compounds=("(NH4)2SO4", "insoluble"),
            molar_masses={
                "(NH4)2SO4": 132.14 * si.g / si.mole,
                "insoluble": 44 * si.g / si.mole,
            },
            densities={
                "(NH4)2SO4": 1.77 * si.g / si.cm**3,
                "insoluble": 1.77 * si.g / si.cm**3,
            },
            is_soluble={"(NH4)2SO4": True, "insoluble": False},
            ionic_dissociation_phi={"(NH4)2SO4": 3, "insoluble": 0},
        )
        self.modes = (
            {
                "kappa": self.kappa(
                    mass_fractions={"(NH4)2SO4": 1.0, "insoluble": 0.0},
                    water_molar_volume=water_molar_volume,
                ),
                "spectrum": spectra.Lognormal(
                    norm_factor=100.0 / si.cm**3, m_mode=50.0 * si.nm, s_geom=2.0
                ),
            },
            {
                "kappa": self.kappa(
                    mass_fractions={
                        "(NH4)2SO4": M2_sol,
                        "insoluble": (1 - M2_sol),
                    },
                    water_molar_volume=water_molar_volume,
                ),
                "spectrum": spectra.Lognormal(
                    norm_factor=M2_N, m_mode=M2_rad, s_geom=2.0
                ),
            },
        )


def run_parcel(
    w,
    sol2,
    N2,
    rad2,
    n_sd_per_mode,
    RH0=1.0,
    T0=294 * si.K,
    p0=1e5 * si.Pa,
    n_steps=50,
    mass_of_dry_air=1e3 * si.kg,
    dt=2 * si.s,
    backend_class=GPU,
):
    """returns namespace with activated_fraction_S / activated_fraction_V
    per mode + error estimate (reference ``run_ARG_parcel.py:16-130``)"""
    products = (
        WaterMixingRatio(name="liquid water mixing ratio"),
        PeakSupersaturation(name="S max"),
        AmbientRelativeHumidity(name="RH"),
        ParcelDisplacement(name="z"),
    )
    formulae = Formulae(constants=CONSTANTS_ARG)
    const = formulae.constants
    pv0 = RH0 * float(formulae.saturation_vapour_pressure.pvs_water(T0))

    env = Parcel(
        dt=dt,
        mass_of_dry_air=mass_of_dry_air,
        p0=p0,
        initial_water_vapour_mixing_ratio=const.eps * pv0 / (p0 - pv0),
        w=w,
        T0=T0,
    )
    aerosol = AerosolARG(
        M2_sol=sol2, M2_N=N2, M2_rad=rad2,
        water_molar_volume=const.Mv / const.rho_w,
    )
    n_sd = n_sd_per_mode * len(aerosol.modes)
    builder = Builder(backend=backend_class(formulae), n_sd=n_sd, environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation())
    builder.request_attribute("critical saturation")
    builder.request_attribute("critical volume")

    attributes = {
        k: np.empty(0)
        for k in ("dry volume", "kappa times dry volume", "multiplicity")
    }
    for mode in aerosol.modes:
        kappa, spectrum = mode["kappa"]["Constant"], mode["spectrum"]
        r_dry, concentration = ConstantMultiplicity(spectrum).sample(
            n_sd_per_mode
        )
        v_dry = np.asarray(formulae.trivia.volume(radius=r_dry))
        specific_concentration = concentration / const.rho_STP
        attributes["multiplicity"] = np.append(
            attributes["multiplicity"],
            specific_concentration * env.mass_of_dry_air,
        )
        attributes["dry volume"] = np.append(attributes["dry volume"], v_dry)
        attributes["kappa times dry volume"] = np.append(
            attributes["kappa times dry volume"], v_dry * kappa
        )
    r_wet = equilibrate_wet_radii(
        r_dry=np.asarray(
            formulae.trivia.radius(volume=attributes["dry volume"])
        ),
        environment=env,
        kappa_times_dry_volume=attributes["kappa times dry volume"],
    )
    attributes["volume"] = np.asarray(formulae.trivia.volume(radius=r_wet))

    particulator = builder.build(attributes, products=products)

    output = {name: [] for name in particulator.products}
    for _ in range(n_steps):
        particulator.run(steps=1)
        for name, product in particulator.products.items():
            output[name].append(float(np.asarray(product.get()).reshape(-1)[0]))

    mult = np.asarray(particulator.attributes["multiplicity"])
    volume = np.asarray(particulator.attributes["volume"])
    crit_volume = np.asarray(particulator.attributes["critical volume"])
    crit_saturation = np.asarray(particulator.attributes["critical saturation"])
    RHmax = np.nanmax(np.asarray(output["RH"]))

    n_modes = len(aerosol.modes)
    activated_fraction_S = np.zeros(n_modes)
    activated_fraction_V = np.zeros(n_modes)
    error = np.zeros(n_modes)
    for j in range(n_modes):
        sel = slice(j * n_sd_per_mode, (j + 1) * n_sd_per_mode)
        Nj = mult[sel]
        sum_Nj = Nj.sum()
        activated_fraction_S[j] = (
            Nj[crit_saturation[sel] < RHmax].sum() / sum_Nj
        )
        activated_fraction_V[j] = (
            Nj[crit_volume[sel] < volume[sel]].sum() / sum_Nj
        )
        error[j] = Nj.max() / sum_Nj

    class _Out:
        pass

    out = _Out()
    out.output = output
    out.activated_fraction_S = activated_fraction_S
    out.activated_fraction_V = activated_fraction_V
    out.error = error
    out.aerosol = aerosol
    out.particulator = particulator
    return out
