"""Jensen & Nugent 2017 (JAS): giant sea-salt CCN and stratocumulus drizzle
in an adiabatic parcel (port of ``pysdm_tpu/models/jensen_and_nugent_2017.py``;
reference ``examples/PySDM_examples/Jensen_and_Nugent_2017/settings.py`` +
``simulation.py`` + ``table_3.py``): modified-polluted or pristine two-mode
lognormal aerosol (kappa = 1.28), an optional GCCN mode from the paper's
Table 3, an up-then-down "Sc" or a constant-updraft "Cu" velocity, optional
gravitational coalescence (``Geometric``, K1 on the mirror croupier);
Grabowski et al. 2011 diffusion kinetics and thermics with MAC = 0.036,
HAC = 0.7 (paper appendix B).

``Simulation`` builds on the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``); w(t) is
NumPy on the host, where the parcel's clock lives."""

import numpy as np

from ..builder import Builder
from ..backends import GPU
from ..dynamics import AmbientThermodynamics, Condensation
from ..dynamics.collisions.collision import Coalescence
from ..dynamics.collisions.collision_kernels import Geometric
from ..environments import Parcel
from ..initialisation.sampling.spectral_sampling import Logarithmic
from ..initialisation.spectra import Lognormal, Sum
from ..physics import si
from ..physics.formulae import Formulae
from ..products import (
    ActivatedMeanRadius,
    ParcelDisplacement,
    PeakSupersaturation,
    RadiusStandardDeviation,
    Time,
)

INITIAL_RELATIVE_HUMIDITY = 0.8561
INITIAL_TEMPERATURE = 284.3 * si.K
INITIAL_PRESSURE = 938.5 * si.hPa
INITIAL_ALTITUDE = 600 * si.m

N_SD_NON_GCCN = 100

# Table 3: giant sea-salt nuclei concentrations per dry radius bin
TABLE_3_NA = np.asarray(
    [
        111800, 68490, 38400, 21820, 13300, 8496, 5486, 3805, 2593, 1919,
        1278, 998.4, 777.9, 519.5, 400.5, 376.9, 265.3, 212.4, 137.8, 121.4,
        100.9, 122.2, 50.64, 38.3, 55.47, 21.45, 12.95, 43.23, 26.26, 30.5,
        4.385, 4.372, 4.465, 4.395, 4.427, 4.411, 0, 0, 0, 4.522, 0, 4.542,
    ]
) / si.m**3
TABLE_3_RD = np.linspace(0.8, 9, num=len(TABLE_3_NA), endpoint=True) * si.um


class Settings:
    def __init__(self, *, aerosol: str, cloud_type: str, dt: float = None):
        self.p0 = INITIAL_PRESSURE
        self.RH0 = INITIAL_RELATIVE_HUMIDITY
        self.T0 = INITIAL_TEMPERATURE
        self.z0 = INITIAL_ALTITUDE
        self.t_end_of_ascent = 1500 * si.s if cloud_type == "Sc" else None
        self.dt = dt or 1 * si.s
        self.kappa = 1.28  # Table 1 from Petters & Kreidenweis 2007
        self.formulae = Formulae(
            saturation_vapour_pressure="FlatauWalkoCotton",
            diffusion_kinetics="GrabowskiEtAl2011",
            diffusion_thermics="GrabowskiEtAl2011",
            constants={"MAC": 0.036, "HAC": 0.7},
        )
        if cloud_type == "Sc":
            t_up = self.t_end_of_ascent

            def w_sc(t):
                return np.where(t < t_up, 0.4, -0.4)

            self.vertical_velocity = w_sc
        else:  # "Cu"
            self.vertical_velocity = 2 * si.m / si.s
        self.dry_radii_spectrum = {
            "modified polluted": Sum(
                (
                    Lognormal(
                        norm_factor=48 / si.cm**3,
                        m_mode=0.029 * si.um,
                        s_geom=1.36,
                    ),
                    Lognormal(
                        norm_factor=114 / si.cm**3,
                        m_mode=0.071 * si.um,
                        s_geom=1.57,
                    ),
                )
            ),
            "pristine": Sum(
                (
                    Lognormal(
                        norm_factor=125 / si.cm**3,
                        m_mode=0.011 * si.um,
                        s_geom=1.2,
                    ),
                    Lognormal(
                        norm_factor=65 / si.cm**3,
                        m_mode=0.06 * si.um,
                        s_geom=1.7,
                    ),
                )
            ),
        }[aerosol]


class Simulation:
    def __init__(
        self,
        settings: Settings,
        gccn: bool = False,
        gravitational_coalescence: bool = False,
        backend_class=GPU,
        n_sd_non_gccn: int = N_SD_NON_GCCN,
    ):
        self.settings = settings
        const = settings.formulae.constants
        pvs_water = settings.formulae.saturation_vapour_pressure.pvs_water
        initial_water_vapour_mixing_ratio = const.eps / (
            settings.p0 / settings.RH0 / float(pvs_water(settings.T0)) - 1
        )
        n_gccn = int(np.count_nonzero(TABLE_3_NA)) if gccn else 0

        env = Parcel(
            dt=settings.dt,
            mass_of_dry_air=666 * si.kg,
            p0=settings.p0,
            initial_water_vapour_mixing_ratio=(
                initial_water_vapour_mixing_ratio
            ),
            T0=settings.T0,
            w=settings.vertical_velocity,
            z0=settings.z0,
        )
        builder = Builder(
            n_sd=n_sd_non_gccn + n_gccn,
            backend=backend_class(settings.formulae),
            environment=env,
        )
        builder.request_attribute("radius")
        builder.request_attribute("equilibrium saturation")
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation())
        if gravitational_coalescence:
            builder.add_dynamic(Coalescence(collision_kernel=Geometric()))

        self.r_dry, n_in_unit_volume = Logarithmic(
            spectrum=settings.dry_radii_spectrum
        ).sample(n_sd_non_gccn)
        if gccn:
            mask = np.nonzero(TABLE_3_NA)
            self.r_dry = np.concatenate([self.r_dry, TABLE_3_RD[mask]])
            n_in_unit_volume = np.concatenate(
                [n_in_unit_volume, TABLE_3_NA[mask]]
            )

        f = settings.formulae
        pd0 = float(
            f.trivia.p_d(settings.p0, initial_water_vapour_mixing_ratio)
        )
        rhod0 = float(f.state_variable_triplet.rhod_of_pd_T(pd0, settings.T0))
        attributes = env.init_attributes(
            n_in_dv=n_in_unit_volume * env.mass_of_dry_air / rhod0,
            kappa=settings.kappa,
            r_dry=self.r_dry,
        )
        self.particulator = builder.build(
            attributes,
            products=(
                PeakSupersaturation(name="S_max"),
                ParcelDisplacement(name="z"),
                Time(name="t"),
                ActivatedMeanRadius(
                    name="r_mean_act",
                    count_activated=True,
                    count_unactivated=False,
                ),
                RadiusStandardDeviation(
                    name="r_std_act",
                    count_activated=True,
                    count_unactivated=False,
                ),
            ),
        )

    def run(self, *, n_steps: int = 2250, steps_per_output_interval: int = 10):
        p = self.particulator
        output = {
            "products": {name: [] for name in p.products},
            "attributes": {"radius": []},
        }
        for step in range(0, n_steps + 1, steps_per_output_interval):
            p.run(step - p.n_steps)
            for name, product in p.products.items():
                output["products"][name].append(
                    float(np.asarray(product.get()).reshape(-1)[0])
                )
            output["attributes"]["radius"].append(
                np.asarray(p.attributes["radius"]).copy()
            )
        return output
