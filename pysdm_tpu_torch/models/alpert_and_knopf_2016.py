"""Alpert & Knopf 2016 (ACP 16) immersion-freezing box setup (port of
``pysdm_tpu/models/alpert_and_knopf_2016.py``; reference
``examples/PySDM_examples/Alpert_and_Knopf_2016/simulation.py``):
time-dependent (non-singular) immersion freezing with constant or ABIFM
J_het, isothermal or constant-cooling-rate protocol, unfrozen fraction and
total unfrozen immersed surface area tracked over time.

``simulation`` and ``Simulation`` build on the ``GPU`` backend unless the
caller passes ``backend_class=CPU`` (the JAX package defaults to its
``CPU``)."""

import numpy as np
import torch

from ..builder import Builder
from ..backends import GPU
from ..dynamics import Freezing
from ..environments import Box
from ..initialisation.discretise_multiplicities import discretise_multiplicities
from ..initialisation.sampling import spectral_sampling
from ..physics import Formulae, si
from ..products import IceWaterContent, TotalUnfrozenImmersedSurfaceArea


def simulation(
    *,
    constants,
    seed,
    n_sd,
    time_step,
    volume,
    spectrum,
    droplet_volume,
    multiplicity,
    total_time,
    number_of_real_droplets,
    cooling_rate=0,
    heterogeneous_ice_nucleation_rate="Constant",
    initial_temperature=np.nan,
    backend_class=GPU,
):
    """one realisation; returns (f_ufz list, A_tot list)
    (reference ``Alpert_and_Knopf_2016/simulation.py:196-266``)"""
    formulae = Formulae(
        seed=seed,
        heterogeneous_ice_nucleation_rate=heterogeneous_ice_nucleation_rate,
        constants=constants,
        particle_shape_and_density="MixedPhaseSpheres",
    )
    builder = Builder(
        n_sd=n_sd,
        backend=backend_class(formulae=formulae),
        environment=Box(dt=time_step, dv=volume),
    )
    env = builder.particulator.environment
    builder.add_dynamic(Freezing(singular=False))

    if hasattr(spectrum, "s_geom") and spectrum.s_geom == 1:
        _isa = np.full(n_sd, spectrum.m_mode)
        _conc = np.full(n_sd, multiplicity / volume)
    else:
        _isa, _conc = spectral_sampling.ConstantMultiplicity(spectrum).sample(
            n_sd
        )
    attributes = {
        "multiplicity": discretise_multiplicities(_conc * volume),
        "immersed surface area": _isa,
        "signed water mass": np.full(
            n_sd, droplet_volume * formulae.constants.rho_w
        ),
    }
    np.testing.assert_almost_equal(attributes["multiplicity"], multiplicity)
    products = (
        IceWaterContent(name="qi"),
        TotalUnfrozenImmersedSurfaceArea(name="A_tot"),
    )
    svp = formulae.saturation_vapour_pressure
    T0 = initial_temperature
    env["T"] = np.asarray([T0], dtype=float)
    env["a_w_ice"] = np.asarray(
        [
            float(svp.pvs_ice(T0) / svp.pvs_water(T0))
            if np.isfinite(T0)
            else np.nan
        ]
    )
    # just above saturation, so that the drops count as unfrozen and
    # saturated: 1 + the machine epsilon of the state's float type (the
    # JAX package takes float64's, which rounds to 1.0 in float32, and
    # then nothing freezes on a float32 device)
    env["RH"] = np.asarray(
        [1 + torch.finfo(builder.particulator.dtype).eps]
    )
    particulator = builder.build(attributes=attributes, products=products)

    f_ufz = []
    a_tot = []
    for i in range(int(total_time / time_step) + 1):
        if cooling_rate != 0:
            T = float(particulator.get_env("T")[0]) - (
                cooling_rate * time_step / 2
            )
            env["T"] = np.asarray([T])
            env["a_w_ice"] = np.asarray(
                [float(svp.pvs_ice(T) / svp.pvs_water(T))]
            )
        particulator.run(0 if i == 0 else 1)
        if cooling_rate != 0:
            T = float(particulator.get_env("T")[0]) - (
                cooling_rate * time_step / 2
            )
            env["T"] = np.asarray([T])

        ice_mass_per_volume = float(
            np.asarray(particulator.products["qi"].get()).reshape(-1)[0]
        )
        ice_mass = ice_mass_per_volume * volume
        ice_number = ice_mass / (formulae.constants.rho_w * droplet_volume)
        f_ufz.append(1 - ice_number / number_of_real_droplets)
        a_tot.append(
            float(
                np.asarray(
                    particulator.products["A_tot"].get()
                ).reshape(-1)[0]
            )
        )
    return f_ufz, a_tot


class Simulation:
    """multi-run ensemble over a case table
    (reference ``simulation.py:18-90``)"""

    def __init__(
        self,
        *,
        cases,
        n_runs_per_case=10,
        multiplicity=1,
        time_step,
        droplet_volume=1 * si.um**3,
        heterogeneous_ice_nucleation_rate="Constant",
        total_time=None,
        temperature_range=None,
        backend_class=GPU,
    ):
        self.cases = cases
        self.n_runs_per_case = n_runs_per_case
        self.multiplicity = multiplicity
        self.volume = cases.volume
        self.time_step = time_step
        self.droplet_volume = droplet_volume
        self.heterogeneous_ice_nucleation_rate = (
            heterogeneous_ice_nucleation_rate
        )
        self.output = None
        self.total_time = total_time
        self.temperature_range = temperature_range
        self.backend_class = backend_class

    def run(self, keys):
        self.output = {}
        for key in keys:
            case = self.cases[key]
            assert (self.total_time is None) + (
                self.temperature_range is None
            ) == 1
            if self.total_time is not None:
                total_time = self.total_time
            else:
                total_time = float(
                    np.diff(np.asarray(self.temperature_range))
                    / case["cooling_rate"]
                )
            constants = None
            if "J_het" not in case:
                case["J_het"] = None
                constants = {
                    "ABIFM_C": case["ABIFM_c"],
                    "ABIFM_M": case["ABIFM_m"],
                }
            if "cooling_rate" not in case:
                case["cooling_rate"] = 0
                constants = {"J_HET": case["J_het"]}

            self.output[key] = []
            for i in range(self.n_runs_per_case):
                number_of_real_droplets = case["ISA"].norm_factor * self.volume
                n_sd = number_of_real_droplets / self.multiplicity
                np.testing.assert_approx_equal(n_sd, int(n_sd))
                n_sd = int(n_sd)
                initial_temp = (
                    self.temperature_range[1]
                    if self.temperature_range
                    else np.nan
                )
                f_ufz, a_tot = simulation(
                    constants=constants,
                    seed=i,
                    n_sd=n_sd,
                    time_step=self.time_step,
                    volume=self.volume,
                    spectrum=case["ISA"],
                    droplet_volume=self.droplet_volume,
                    multiplicity=self.multiplicity,
                    total_time=total_time,
                    number_of_real_droplets=number_of_real_droplets,
                    cooling_rate=case["cooling_rate"],
                    heterogeneous_ice_nucleation_rate=(
                        self.heterogeneous_ice_nucleation_rate
                    ),
                    initial_temperature=initial_temp,
                    backend_class=self.backend_class,
                )
                self.output[key].append({"f_ufz": f_ufz, "A_tot": a_tot})
