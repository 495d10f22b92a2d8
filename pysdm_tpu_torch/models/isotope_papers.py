"""Per-paper isotope / ventilation / hydrostatics formula-study examples.

Each helper reproduces the headline figure or table of one reference example
dir that is a pure formula study (no particle simulation):

- ``bolin_1958_table_1``          — reference ``examples/PySDM_examples/Bolin_1958/table_1.ipynb``
- ``miyake_et_al_1968_fig_19``    — ``Miyake_et_al_1968/fig_19.ipynb``
- ``stewart_1975_fig_1``          — ``Stewart_1975/fig_1.ipynb``
- ``pruppacher_rasmussen_1979_fig_1`` — ``Pruppacher_and_Rasmussen_1979/fig_1.ipynb``
- ``fisher_1991_fig_2``           — ``Fisher_1991/fig_2.ipynb``
- ``bolot_et_al_2013_fig_1``      — ``Bolot_et_al_2013/fig_1.ipynb``
- ``lamb_et_al_2017_fig_4``       — ``Lamb_et_al_2017/fig_4.ipynb``
- ``graf_et_al_2019_table_1``     — ``Graf_et_al_2019/Table_1.ipynb``
- ``toon_et_al_1980_fig_1``       — ``Toon_et_al_1980/fig_1.ipynb``
- ``zaba_et_al_timescales``       — ``Zaba_et_al/timescales_comparison.ipynb``
- ``kinzer_and_gunn_1951_evaporation`` — ``Kinzer_And_Gunn_1951/table_1_and_2.py`` (model side)
- ``pierchala_et_al_2022_excess_17O``  — ``Pierchala_et_al_2022/commons.py`` (triple-isotope Rayleigh)

All return plain numpy arrays/dicts for plotting or assertion.

Port of ``pysdm_tpu/models/isotope_papers.py``: host-side NumPy
over the port's ``Formulae``."""

import numpy as np

from ..physics import si
from ..physics.formulae import Formulae


def _ventilation_inputs(formulae, radii, temperature, pressure):
    """shared plumbing: terminal velocity -> Re, Sc -> sqrt(Re)*cbrt(Sc)
    (reference ``Bolin_1958/table_1.ipynb`` / ``Stewart_1975/fig_1.ipynb``)"""
    const = formulae.constants
    eta_air = float(formulae.air_dynamic_viscosity.eta_air(temperature))
    air_density = pressure / const.Rd / temperature
    D = float(formulae.diffusion_thermics.D(temperature, pressure))
    v_term = np.asarray(formulae.terminal_velocity.v_term(radii))
    Re = np.asarray(
        formulae.particle_shape_and_density.reynolds_number(
            radius=radii,
            velocity_wrt_air=v_term,
            dynamic_viscosity=eta_air,
            density=air_density,
        )
    )
    Sc = float(
        formulae.trivia.air_schmidt_number(
            dynamic_viscosity=eta_air, diffusivity=D, density=air_density
        )
    )
    x = np.asarray(formulae.trivia.sqrt_re_times_cbrt_sc(Re, Sc))
    return {
        "eta_air": eta_air,
        "air_density": air_density,
        "D": D,
        "v_term": v_term,
        "Re": Re,
        "Sc": Sc,
        "sqrt_re_times_cbrt_sc": x,
    }


def bolin_1958_table_1(radii=None):
    """Bolin 1958 table 1: terminal velocity, ventilation coefficient and
    isotopic adjustment timescale for falling raindrops at T0+10K, STP
    pressure. The relaxation rate is the saturated-exchange vapour flux:
    RH=1 against RH_eq=0 with zero heat-flux term (Fk=0), per the reference
    notebook (``Bolin_1958/table_1.ipynb``)."""
    radii = np.asarray(
        radii
        if radii is not None
        else np.asarray([0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2])
        * si.cm
    )
    formulae = Formulae(
        terminal_velocity="RogersYau",
        drop_growth="Mason1971",
        diffusion_thermics="Neglect",
        saturation_vapour_pressure="AugustRocheMagnus",
        ventilation="Froessling1938",
        air_dynamic_viscosity="ZografosEtAl1987",
        isotope_equilibrium_fractionation_factors="VanHook1968",
        isotope_diffusivity_ratios="GrahamsLaw",
        isotope_relaxation_timescale="Bolin1958",
        constants={"BOLIN_ISOTOPE_TIMESCALE_COEFF_C1": 1.63},
    )
    T = formulae.constants.T0 + 10 * si.K
    p = formulae.constants.p_STP
    vent = _ventilation_inputs(formulae, radii, T, p)
    pvs = float(formulae.saturation_vapour_pressure.pvs_water(T))
    f = np.asarray(
        formulae.ventilation.ventilation_coefficient(
            vent["sqrt_re_times_cbrt_sc"]
        )
    )
    Fk = float(formulae.drop_growth.Fk(T=T, K=44.0, lv=0.0))  # == 0
    Fd = formulae.drop_growth.Fd(T=T, D=vent["D"] * f, pvs=pvs)
    r_dr_dt = np.asarray(
        formulae.drop_growth.r_dr_dt(RH_eq=0.0, RH=1.0, Fk=Fk, Fd=Fd)
    )
    dm_dt_over_m = np.asarray(
        formulae.particle_shape_and_density.dm_dt_over_m(radii, r_dr_dt)
    )
    tau = np.asarray(formulae.isotope_relaxation_timescale.tau(dm_dt_over_m))
    return {
        "radius": radii,
        "terminal_velocity": vent["v_term"],
        "ventilation_coefficient": f,
        "adjustment_time": tau,
        "distance": vent["v_term"] * tau,
    }


def miyake_et_al_1968_fig_19(
    radii=None,
    temperatures=(293.15 * si.K,),
    ventilation_variants=("Neglect", "Froessling1938", "PruppacherAndRasmussen1979"),
    isotopes_=("2H", "18O"),
):
    """Miyake et al. 1968 fig. 19: inverse isotopic relaxation timescale 1/tau
    vs drop radius, per ventilation variant"""
    radii = np.asarray(
        radii if radii is not None else np.geomspace(0.2, 2.5, 16) * si.mm / 2
    )
    p = 1000 * si.hPa
    out = {"radius": radii}
    for vent_variant in ventilation_variants:
        formulae = Formulae(
            isotope_equilibrium_fractionation_factors=(
                "HoritaAndWesolowski1994+BarkanAndLuz2005"
            ),
            ventilation=vent_variant,
            terminal_velocity="RogersYau",
            isotope_relaxation_timescale="MiyakeEtAl1968",
            isotope_diffusivity_ratios="HellmannAndHarvey2020",
            air_dynamic_viscosity="ZografosEtAl1987",
        )
        const = formulae.constants
        for T in temperatures:
            vent = _ventilation_inputs(formulae, radii, T, p)
            pvs = float(formulae.saturation_vapour_pressure.pvs_water(T))
            rho_s = pvs / const.Rv / T  # saturation vapour density
            for iso in isotopes_:
                alpha = float(
                    getattr(
                        formulae.isotope_equilibrium_fractionation_factors,
                        f"alpha_l_{iso}",
                    )(T)
                )
                d_ratio = float(
                    getattr(
                        formulae.isotope_diffusivity_ratios,
                        f"ratio_{iso}_heavy_to_light",
                    )(T)
                )
                f = np.asarray(
                    formulae.ventilation.ventilation_coefficient(
                        vent["sqrt_re_times_cbrt_sc"]
                    )
                )
                K = float(formulae.diffusion_thermics.K(T, p))
                lv = float(formulae.latent_heat_vapourisation.lv(T))
                Fk = float(formulae.drop_growth.Fk(T=T, K=K, lv=lv))
                tau = np.asarray(
                    formulae.isotope_relaxation_timescale.tau(
                        rho_s=rho_s,
                        radius=radii,
                        D_iso=vent["D"] * d_ratio * f,
                        D=vent["D"] * f,
                        S=1.0,
                        R_liq=1.0,
                        alpha=alpha,
                        R_vap=1.0 / alpha,
                        Fk=Fk,
                    )
                )
                out[f"{vent_variant}-{float(T):.2f}-{iso}"] = 1.0 / tau
    return out


def stewart_1975_fig_1(radii=None, temperature=283.15 * si.K):
    """Stewart 1975 fig. 1: ventilation factor F = (f-1) vs sqrt(Re)cbrt(Sc)
    for the Beard-Pruppacher parametrisation"""
    radii = np.asarray(
        radii if radii is not None else np.geomspace(5e-5, 2.5e-3, 32)
    )
    formulae = Formulae(
        ventilation="PruppacherAndRasmussen1979",
        air_dynamic_viscosity="ZografosEtAl1987",
        terminal_velocity="RogersYau",
    )
    vent = _ventilation_inputs(formulae, radii, temperature, 1000 * si.hPa)
    f = np.asarray(
        formulae.ventilation.ventilation_coefficient(
            vent["sqrt_re_times_cbrt_sc"]
        )
    )
    return {
        "sqrt_re_times_cbrt_sc": vent["sqrt_re_times_cbrt_sc"],
        "ventilation_coefficient": f,
        "ventilation_factor": f - 1.0,
    }


def pruppacher_rasmussen_1979_fig_1(
    radii=None,
    temperature=273.15 * si.K,
    isotopes_=("2H", "17O", "18O"),
):
    """Pruppacher & Rasmussen 1979 fig. 1 (isotope extension): ventilation
    coefficient for heavy-isotope water, f_heavy = 1 + (f-1) * (D_heavy/D)^(1/3)"""
    radii = np.asarray(
        radii if radii is not None else np.geomspace(1e-5, 3e-3, 48)
    )
    formulae = Formulae(
        terminal_velocity="RogersYau",
        isotope_diffusivity_ratios="HellmannAndHarvey2020",
        ventilation="PruppacherAndRasmussen1979",
        air_dynamic_viscosity="ZografosEtAl1987",
    )
    vent = _ventilation_inputs(
        formulae, radii, temperature, formulae.constants.p_STP
    )
    f = np.asarray(
        formulae.ventilation.ventilation_coefficient(
            vent["sqrt_re_times_cbrt_sc"]
        )
    )
    out = {"radius": radii, "ventilation_coefficient": f}
    for iso in isotopes_:
        ratio = float(
            getattr(
                formulae.isotope_diffusivity_ratios,
                f"ratio_{iso}_heavy_to_light",
            )(temperature)
        )
        out[iso] = 1.0 + (f - 1.0) * ratio ** (1.0 / 3.0)
    return out


def fisher_1991_fig_2(T=None, saturation=None):
    """Fisher 1991 fig. 2: effective (equilibrium x kinetic) ice-vapour
    fractionation factor vs temperature for 2H and 18O; default saturation
    over ice follows the Jouzel & Merlivat 1984 closure S = 1 - 0.004 T_C"""
    T = np.asarray(T if T is not None else np.linspace(233.15, 273.15, 41))
    if saturation is None:
        saturation = 1.0 - 0.004 * (T - 273.15)
    formulae = Formulae(
        isotope_meteoric_water_line="Dansgaard1964",
        isotope_diffusivity_ratios="Stewart1975",
        isotope_kinetic_fractionation_factors="JouzelAndMerlivat1984",
        isotope_equilibrium_fractionation_factors=(
            "MerlivatAndNief1967+Majoube1970"
        ),
    )
    out = {"T": T}
    for iso in ("2H", "18O"):
        alpha_eq = np.asarray(
            getattr(
                formulae.isotope_equilibrium_fractionation_factors,
                f"alpha_i_{iso}",
            )(T)
        )
        d_ratio = np.asarray(
            getattr(
                formulae.isotope_diffusivity_ratios,
                f"ratio_{iso}_heavy_to_light",
            )(T)
        )
        alpha_kin = np.asarray(
            formulae.isotope_kinetic_fractionation_factors.alpha_kinetic(
                alpha_eq, saturation, d_ratio
            )
        )
        out[f"alpha_eq_{iso}"] = alpha_eq
        out[f"alpha_eff_{iso}"] = alpha_eq * alpha_kin
    return out


def bolot_et_al_2013_fig_1(T_celsius=None):
    """Bolot et al. 2013 fig. 1: equilibrium fractionation factors for both
    phases and both heavy isotopologues vs temperature in Celsius"""
    T_celsius = np.asarray(
        T_celsius if T_celsius is not None else np.linspace(-120.0, 20.0, 71)
    )
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors=(
            "MerlivatAndNief1967+Majoube1970+Majoube1971"
        )
    )
    alphas = formulae.isotope_equilibrium_fractionation_factors
    const = formulae.constants
    T = T_celsius + const.T0
    out = {"T_celsius": T_celsius}
    for phase, iso in (
        ("l", "2H"),
        ("i", "2H"),
        ("l", "18O"),
        ("i", "18O"),
    ):
        out[f"alpha_{phase}_{iso}"] = np.asarray(
            getattr(alphas, f"alpha_{phase}_{iso}")(T)
        )
    return out


def lamb_et_al_2017_fig_4(T=None):
    """Lamb et al. 2017 fig. 4: ice-vapour 2H equilibrium fractionation factor
    vs temperature across published fits"""
    T = np.asarray(T if T is not None else np.linspace(195.0, 273.0, 79))
    out = {"T": T}
    for paper in ("LambEtAl2017", "EllehojEtAl2013", "MerlivatAndNief1967"):
        out[paper] = np.asarray(
            Formulae(
                isotope_equilibrium_fractionation_factors=paper
            ).isotope_equilibrium_fractionation_factors.alpha_i_2H(T)
        )
    return out


def graf_et_al_2019_table_1(
    delta_vapour={"18O": -20e-3, "2H": -150e-3},
    T_celsius=(20.0, 0.0, -10.0),
):
    """Graf et al. 2019 table 1: isotopic composition of liquid (T>=0) /
    solid (T<0) condensate formed in equilibrium with a given vapour"""
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors=(
            "Majoube1970+Majoube1971+MerlivatAndNief1967"
        ),
        isotope_meteoric_water_line="Dansgaard1964",
    )
    const = formulae.constants
    alphas = formulae.isotope_equilibrium_fractionation_factors
    table = {}
    for TC in T_celsius:
        phase = "l" if TC >= 0 else "i"
        T = TC + const.T0
        row = {}
        for iso in ("18O", "2H"):
            reference_ratio = getattr(const, f"VSMOW_R_{iso}")
            Rv = float(
                formulae.trivia.isotopic_delta_2_ratio(
                    delta_vapour[iso], reference_ratio
                )
            )
            alpha = float(getattr(alphas, f"alpha_{phase}_{iso}")(T))
            delta_phase = float(
                formulae.trivia.isotopic_ratio_2_delta(
                    alpha * Rv, reference_ratio
                )
            )
            row[f"delta_{phase}_{iso}"] = delta_phase
            row[f"diff_delta_{iso}"] = delta_phase - delta_vapour[iso]
        row["excess_d"] = float(
            formulae.isotope_meteoric_water_line.excess_d(
                row[f"delta_{phase}_2H"], row[f"delta_{phase}_18O"]
            )
        )
        table[TC] = row
    return table


def toon_et_al_1980_fig_1(z=None, p0=1000 * si.hPa, temperature=210 * si.K):
    """Toon et al. 1980 fig. 1: isothermal variable-g hydrostatic pressure
    profiles for atmospheres of different molar mass (Titan-like study)"""
    z = np.asarray(z if z is not None else np.linspace(0, 30e3, 61))
    formulae = Formulae(
        hydrostatics="VariableGIsothermal",
        constants={"celestial_body_radius": 6371 * si.km},
    )
    out = {"z": z}
    for label, molar_mass in (
        ("N2", 28.01e-3),
        ("CH4", 16.04e-3),
        ("air", 28.97e-3),
    ):
        out[label] = np.asarray(
            formulae.hydrostatics.pressure(
                z, p0, temperature=temperature, molar_mass=molar_mass
            )
        )
    return out


def zaba_et_al_timescales(
    radii=None, temperature=293.15 * si.K, saturation=0.8
):
    """Zaba et al. timescales comparison: isotopic relaxation timescale tau vs
    drop radius across published closures (Bolin 1958 excluded — different
    signature; compared separately in ``bolin_1958_table_1``)"""
    radii = np.asarray(
        radii if radii is not None else np.geomspace(1e-4, 2e-3, 24)
    )
    p = 1000 * si.hPa
    out = {"radius": radii}
    for variant in ("MiyakeEtAl1968", "JouzelEtAl1975", "ZabaEtAl"):
        formulae = Formulae(
            isotope_relaxation_timescale=variant,
            isotope_equilibrium_fractionation_factors=(
                "HoritaAndWesolowski1994"
            ),
            isotope_diffusivity_ratios="HellmannAndHarvey2020",
            ventilation="Froessling1938",
            terminal_velocity="RogersYau",
            air_dynamic_viscosity="ZografosEtAl1987",
        )
        const = formulae.constants
        T = temperature
        vent = _ventilation_inputs(formulae, radii, T, p)
        pvs = float(formulae.saturation_vapour_pressure.pvs_water(T))
        rho_s = pvs / const.Rv / T
        alpha = float(
            formulae.isotope_equilibrium_fractionation_factors.alpha_l_18O(T)
        )
        d_ratio = float(
            formulae.isotope_diffusivity_ratios.ratio_18O_heavy_to_light(T)
        )
        K = float(formulae.diffusion_thermics.K(T, p))
        lv = float(formulae.latent_heat_vapourisation.lv(T))
        Fk = float(formulae.drop_growth.Fk(T=T, K=K, lv=lv))
        out[variant] = np.asarray(
            formulae.isotope_relaxation_timescale.tau(
                rho_s=rho_s,
                radius=radii,
                D_iso=vent["D"] * d_ratio,
                D=vent["D"],
                S=saturation,
                R_liq=1.0,
                alpha=alpha,
                R_vap=1.0,
                Fk=Fk,
            )
        )
    return out


def kinzer_and_gunn_1951_evaporation(
    radii=None, temperature=278.15 * si.K, relative_humidity=0.5
):
    """Kinzer & Gunn 1951 tables 1-2 (model side): ventilated evaporation rate
    dm/dt of water drops falling at terminal velocity"""
    radii = np.asarray(
        radii if radii is not None else np.geomspace(5e-5, 2e-3, 24)
    )
    formulae = Formulae(
        terminal_velocity="RogersYau",
        ventilation="PruppacherAndRasmussen1979",
        air_dynamic_viscosity="ZografosEtAl1987",
    )
    const = formulae.constants
    T, p = temperature, 1000 * si.hPa
    vent = _ventilation_inputs(formulae, radii, T, p)
    f = np.asarray(
        formulae.ventilation.ventilation_coefficient(
            vent["sqrt_re_times_cbrt_sc"]
        )
    )
    K = float(formulae.diffusion_thermics.K(T, p))
    lv = float(formulae.latent_heat_vapourisation.lv(T))
    pvs = float(formulae.saturation_vapour_pressure.pvs_water(T))
    Fk = float(formulae.drop_growth.Fk(T=T, K=K, lv=lv))
    Fd = formulae.drop_growth.Fd(T=T, D=vent["D"] * f, pvs=pvs)
    r_dr_dt = np.asarray(
        formulae.drop_growth.r_dr_dt(
            RH_eq=1.0, RH=relative_humidity, Fk=Fk, Fd=Fd
        )
    )
    dm_dt = 4 * np.pi * radii * const.rho_w * r_dr_dt
    return {
        "radius": radii,
        "terminal_velocity": vent["v_term"],
        "ventilation_coefficient": f,
        "dm_dt": dm_dt,
    }


def pierchala_et_al_2022_excess_17O(
    remaining_fraction=None,
    temperature=293.15 * si.K,
    relative_humidity=0.5,
):
    """Pierchala et al. 2022 (triple-isotope evaporation experiments):
    evolution of delta-18O, delta-17O and 17O-excess of an evaporating water
    body under Craig-Gordon kinetic + equilibrium fractionation, Rayleigh form"""
    frac = np.asarray(
        remaining_fraction
        if remaining_fraction is not None
        else np.linspace(1.0, 0.3, 36)
    )
    formulae = Formulae(
        isotope_equilibrium_fractionation_factors=(
            "HoritaAndWesolowski1994+BarkanAndLuz2005"
        ),
        isotope_kinetic_fractionation_factors="CraigGordon",
        isotope_diffusivity_ratios="HellmannAndHarvey2020",
        isotope_meteoric_water_line="BarkanAndLuz2007",
    )
    const = formulae.constants
    T = temperature
    out = {"remaining_fraction": frac}
    deltas = {}
    alpha_l_18O = float(
        formulae.isotope_equilibrium_fractionation_factors.alpha_l_18O(T)
    )
    # per-isotope turbulence parameter n (Pierchala 2022 TABLE 2 — reference
    # ``Pierchala_et_al_2022/commons.py``; deltas are relative to the
    # initial liquid, not VSMOW)
    turbulence_n = {"2H": 0.90, "18O": 0.956, "17O": 0.958}
    for iso in ("18O", "17O"):
        if iso == "18O":
            alpha_eq = alpha_l_18O
        else:
            alpha_eq = float(
                formulae.isotope_equilibrium_fractionation_factors.alpha_l_17O(
                    np.nan, alpha_l_18O
                )
            )
        d_ratio = float(
            getattr(
                formulae.isotope_diffusivity_ratios,
                f"ratio_{iso}_heavy_to_light",
            )(T)
        )
        alpha_kin = float(
            formulae.isotope_kinetic_fractionation_factors.alpha_kinetic(
                relative_humidity=relative_humidity,
                turbulence_parameter_n=turbulence_n[iso],
                delta_diff=1.0 / d_ratio - 1.0,
                theta=1.0,
            )
        )
        alpha = alpha_eq * alpha_kin
        # Rayleigh: liquid ratio R/R0 = f^(1/alpha - 1) for evaporation
        r_over_r0 = frac ** (1.0 / alpha - 1.0)
        deltas[iso] = r_over_r0 - 1.0
        out[f"delta_{iso}"] = deltas[iso]
    out["excess_17O"] = np.asarray(
        formulae.isotope_meteoric_water_line.excess_17O(
            deltas["17O"], deltas["18O"]
        )
    )
    return out
