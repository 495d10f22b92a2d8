"""Rozanski & Sonntag 1982 (Tellus 34) figs. 4-6 — multi-box model of the
vertical isotope structure of a convective cloud with rain-vapour exchange
(reference ``examples/PySDM_examples/Rozanski_and_Sonntag_1982/multibox.py``
+ ``figs_4_5_6.ipynb``).

The reference subclasses Parcel and re-runs the full condensation parcel in
every one of its ~400 fixed-point iterations, because isotope ratios live in
env storage there. The thermodynamic trajectory does not depend on the
isotope ratios, so here the parcel (n_sd=1, AmbientThermodynamics +
Condensation) runs ONCE, and the fixed-point iteration over the
isotope-ratio profiles — explicit-Euler Rayleigh evolution (Merlivat &
Jouzel 1979 dRv/Rv) plus the eq.-(2) rain-vapour exchange — runs host-side
over the recorded (T, qv) profile. Numerically equivalent, ~400x cheaper.

Port of ``pysdm_tpu/models/rozanski_and_sonntag_1982.py``. ``run_parcel``
and ``MultiBox`` run the parcel on the ``GPU`` backend unless the caller
passes ``backend_class=CPU`` (the JAX package defaults to its ``CPU``); the
fixed-point iteration is host NumPy."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..environments import Parcel
from ..physics import si
from ..physics.constants import PER_CENT, PER_MILLE
from ..physics.formulae import Formulae

ISOTOPES = ("2H", "18O")


def Rv_prim(*, Rl, Nl, Rv, Nv, dNl, Rr, K, a):
    """eq. (2) in Rozanski & Sonntag 1982: vapour ratio after isotopic
    exchange with rain falling from above"""
    return (Rl * Nl + Rv * Nv + dNl * Rr * K) / ((Nl + dNl * K) * a + Nv)


class Settings:
    """fig-4 caption parameters"""

    def __init__(
        self,
        *,
        formulae=None,
        updraft=0.6 * si.m / si.s,
        timestep=300 * si.s,
        z_range=7.2 * si.km,
        n_iterations=401,
    ):
        self.formulae = formulae or Formulae(
            isotope_equilibrium_fractionation_factors="HoritaAndWesolowski1994",
            isotope_meteoric_water_line="Dansgaard1964",
            isotope_ratio_evolution="MerlivatAndJouzel1979",
        )
        const = self.formulae.constants
        self.updraft = updraft
        self.timestep = timestep
        self.z_range = z_range
        self.n_iterations = n_iterations
        self.T_init = const.T0 + 25 * si.K
        self.p_init = 1000 * si.mbar
        self.RH_init = 80 * PER_CENT
        self.delta_2H_init = -74.7 * PER_MILLE
        self.delta_18O_init = float(
            self.formulae.isotope_meteoric_water_line.d18O_of_d2H(
                self.delta_2H_init
            )
        )
        self.isotope_exchange_factor = 1.0
        # "N_L": cloud-water mixing ratio above which autoconversion to rain
        self.autoconversion_mixrat_threshold = 1 * si.g / si.kg
        self.mass_of_dry_air = 1 * si.kg
        self.kappa = 1.0
        self.r_dry = 0.1 * si.um
        self.n_in_dv = (1000 / si.cm**3) * si.m**3

    @property
    def nt(self):
        return int(self.z_range // (self.updraft * self.timestep))

    @property
    def initial_water_vapour_mixing_ratio(self):
        const = self.formulae.constants
        return const.eps / (
            self.p_init
            / self.RH_init
            / float(self.formulae.saturation_vapour_pressure.pvs_water(self.T_init))
            - 1
        )


def run_parcel(settings: Settings, backend_class=GPU):
    """one condensation-parcel ascent; returns per-level profiles"""
    env = Parcel(
        dt=settings.timestep,
        p0=settings.p_init,
        initial_water_vapour_mixing_ratio=(
            settings.initial_water_vapour_mixing_ratio
        ),
        T0=settings.T_init,
        mass_of_dry_air=settings.mass_of_dry_air,
        w=settings.updraft,
    )
    builder = Builder(
        n_sd=1, backend=backend_class(settings.formulae), environment=env
    )
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation())
    attributes = env.init_attributes(
        kappa=settings.kappa,
        r_dry=settings.r_dry,
        n_in_dv=settings.n_in_dv,
    )
    particulator = builder.build(attributes)

    profiles = {key: [] for key in ("z", "T", "RH", "qv")}
    for step in range(settings.nt + 1):
        for key in profiles:
            profiles[key].append(float(env[key if key != "qv" else "qv"][0]))
        if step < settings.nt:
            particulator.run(1)
    return {key: np.asarray(val) for key, val in profiles.items()}


class MultiBox:
    """fixed-point iteration toward the stationary isotope profile"""

    def __init__(self, settings: Settings = None, backend_class=GPU):
        self.settings = settings or Settings()
        self.profiles = run_parcel(self.settings, backend_class)
        s = self.settings
        qv0 = s.initial_water_vapour_mixing_ratio
        self.QL_raw = qv0 - self.profiles["qv"]
        self.QR = np.maximum(0, self.QL_raw - s.autoconversion_mixrat_threshold)
        self.QL = np.minimum(self.QL_raw, s.autoconversion_mixrat_threshold)
        #: rain-water increment per level (drives the exchange term)
        self.delta_nl = np.diff(np.concatenate(([0], self.QR)))
        self._tables = self._per_level_tables()

    def _per_level_tables(self):
        """precompute (vectorized, once) everything Rv-independent: the
        per-level equilibrium alphas, the Rayleigh growth factor
        1 + dt * dRv/Rv, and the suffix sums of delta_nl — so the
        per-iteration sweep is pure host float arithmetic (no per-level
        device dispatches)"""
        s = self.settings
        T, qv = self.profiles["T"], self.profiles["qv"]
        delta_ql = np.maximum(0.0, -np.diff(qv))
        # suffix sums: dNl_above[k] = sum(delta_nl[k:]) — rain falling into
        # level k from above (reference multibox.py `np.sum(delta_nl[level:])`
        # with level = n_steps at the advance)
        tables = {"dNl_above": np.cumsum(self.delta_nl[::-1])[::-1]}
        d_Rv_over_Rv = s.formulae.isotope_ratio_evolution.d_Rv_over_Rv
        for isotope in ISOTOPES:
            alpha = np.asarray(
                getattr(
                    s.formulae.isotope_equilibrium_fractionation_factors,
                    f"alpha_l_{isotope}",
                )(T)
            )
            growth = 1.0 + s.timestep * np.asarray(
                d_Rv_over_Rv(
                    alpha=alpha[:-1],
                    d_alpha=np.diff(alpha) / s.timestep,
                    n_vapour=qv[:-1],
                    d_n_vapour=-delta_ql / s.timestep,
                    n_liquid=s.autoconversion_mixrat_threshold,
                )
            )
            tables[isotope] = {"alpha": alpha, "growth": growth}
        return tables

    def iterate(self, rain_isotope_ratios=None):
        """one profile sweep (one reference `Simulation.run`); pass the
        previous sweep's rain ratios to enable the eq.-(2) exchange"""
        s = self.settings
        const = s.formulae.constants
        trivia = s.formulae.trivia
        tables = self._tables
        qv = self.profiles["qv"]
        nt = s.nt
        out = {}
        for isotope in ISOTOPES:
            vsmow = getattr(const, f"VSMOW_R_{isotope}")
            alpha = tables[isotope]["alpha"]
            growth = tables[isotope]["growth"]
            Rv = np.empty(nt + 1)
            Rr = np.empty(nt + 1)
            Rv[0] = float(
                trivia.isotopic_delta_2_ratio(
                    getattr(s, f"delta_{isotope}_init"), vsmow
                )
            )
            Rr[0] = alpha[0] * Rv[0]
            for level in range(nt):
                Rv[level + 1] = Rv[level] * growth[level]
                if rain_isotope_ratios is not None:
                    Rv[level + 1] = Rv_prim(
                        Rl=alpha[level] * Rv[level + 1],
                        Nl=s.autoconversion_mixrat_threshold,
                        Rv=Rv[level + 1],
                        Nv=qv[level],
                        dNl=tables["dNl_above"][level],
                        Rr=rain_isotope_ratios[isotope][min(level + 2, nt)],
                        K=s.isotope_exchange_factor,
                        a=alpha[level],
                    )
                Rr[level + 1] = alpha[level] * Rv[level + 1]
            out[f"Rv_{isotope}"] = Rv
            out[f"Rr_{isotope}"] = Rr
        return out

    def run(self):
        """iterate to the stationary state; returns list of per-iteration
        profile dicts (index 0 = no-exchange Rayleigh profile)"""
        output = []
        rain_ratios = None
        for _ in range(self.settings.n_iterations):
            sweep = self.iterate(rain_ratios)
            rain_ratios = {
                isotope: sweep[f"Rr_{isotope}"] for isotope in ISOTOPES
            }
            output.append(sweep)
        return output
