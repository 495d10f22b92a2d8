"""Bartman et al. 2021 (JOSS 6) performance-benchmark harness (port of
``pysdm_tpu/models/bartman_et_al_2021.py``; reference
``examples/PySDM_examples/Bartman_et_al_2021/demo_fig2.ipynb`` +
``Arabas_et_al_2015/example_benchmark.py:26-66``): the wall time of the 2D
kinematic warm rain against n_sd per gridbox, over backend classes (``CPU``,
float64 on the host; ``GPU``, float32 on the card) and super-droplet
counts. The clock stops only once the device has finished the steps.

``benchmark`` sweeps the ``GPU`` backend unless the caller passes other
``backend_classes`` (the JAX package sweeps its ``CPU``)."""

import time

from ..backends import GPU
from ..physics import Formulae, si
from .arabas_et_al_2015 import Settings, make_simulation


def benchmark(
    *,
    backend_classes=(GPU,),
    n_sd_per_gridbox_list=(2**5, 2**7),
    grid=(25, 25),
    n_steps=100,
    dt=5 * si.s,
    seed=44,
):
    """returns {backend_name: {n_sd_per_gridbox: seconds}}: the wall time
    of ``n_steps`` full physics steps after one warm-up step"""
    results = {}
    for backend_class in backend_classes:
        times = {}
        for n_sd_per_gridbox in n_sd_per_gridbox_list:
            settings = Settings(
                Formulae(seed=seed),
                grid=grid,
                n_sd_per_gridbox=n_sd_per_gridbox,
                dt=dt,
                spin_up_time=0,
            )
            particulator, spin_up = make_simulation(
                settings, backend_class=backend_class
            )
            spin_up.finish()
            particulator.run(1)  # warm-up
            particulator.block_until_ready()
            t0 = time.perf_counter()
            particulator.run(n_steps)
            particulator.block_until_ready()
            times[n_sd_per_gridbox] = time.perf_counter() - t0
        results[backend_class.__name__] = times
    return results
