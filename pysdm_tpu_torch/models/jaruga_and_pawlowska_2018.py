"""Jaruga & Pawlowska 2018 (GMD, libcloudph++ 2.0), port of
``pysdm_tpu/models/jaruga_and_pawlowska_2018.py``: the aqueous-chemistry
convergence study reusing the Kreidenweis et al. 2003 parcel setup
(reference ``examples/PySDM_examples/Jaruga_and_Pawlowska_2018/fig_2.ipynb`` /
``fig_3.ipynb``, which import Settings/Simulation from
``PySDM_examples.Kreidenweis_et_al_2003``): fig 2 sweeps the super-droplet
count and tracks S_max, droplet concentration, volume-weighted average pH and
total sulfate production; fig 3 bins S(VI) production over dry radius.

``run_convergence_point`` runs on the ``GPU`` backend unless the caller
passes ``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..physics import si
from ..products import (
    Acidity,
    AqueousMoleFraction,
    ParticleConcentration,
    PeakSupersaturation,
)
from .kreidenweis_et_al_2003 import Settings, Simulation

__all__ = ("Settings", "Simulation", "run_convergence_point")


def run_convergence_point(n_sd, *, dt=1 * si.s, n_substep=5,
                          output_interval=25 * si.s, backend_class=None):
    """one fig-2 point: run the Kreidenweis parcel with ``n_sd``
    super-droplets and return (S_max-1 [%], max droplet conc [1/cm3],
    final average pH, sulfate production [ppt])"""
    settings = Settings(dt=dt, n_sd=n_sd, n_substep=n_substep)
    settings.output_interval = output_interval
    products = (
        PeakSupersaturation(name="S_max"),
        ParticleConcentration(
            name="n_c_cm3", radius_range=settings.cloud_radius_range
        ),
        Acidity(
            name="pH_conc_H_volume_weighted",
            radius_range=settings.cloud_radius_range,
        ),
        AqueousMoleFraction("S_VI", name="aq_S_VI_ppb"),
    )
    kwargs = {} if backend_class is None else {"backend_class": backend_class}
    simulation = Simulation(settings, products, **kwargs)
    output = simulation.run()
    s_max = np.nanmax(output["S_max"]) * 100  # PeakSupersaturation = RH - 1
    n_c = np.nanmax(output["n_c_cm3"]) * si.cm**3
    ph = output["pH_conc_H_volume_weighted"][-1]
    s_vi = np.asarray(output["aq_S_VI_ppb"])  # dimensionless mole fraction
    sulfate_ppt = (s_vi[-1] - s_vi[0]) / 1e-12  # fraction -> ppt
    return s_max, n_c, ph, sulfate_ppt
