"""Master-thesis benchmark and validation studies of the reference's
examples (port of ``pysdm_tpu/models/thesis_benchmarks.py``):

- Bartman 2020 (reference ``examples/PySDM_examples/
  Bartman_2020_MasterThesis/fig_4_adaptive_sdm.py``): the Shima 2009 box
  across time steps {10, 5, 1, adaptive} s and n_sd, the adaptive SDM
  recovering the small-dt spectra at a large nominal dt (K1);
- Bulenok 2023 (reference ``examples/PySDM_examples/
  Bulenok_2023_MasterThesis/setups.py`` + ``performance_comparison_
  Srivastava_Setup.py``): the throughput of the coalescence-and-breakup
  substep on the Srivastava 1982 setup at growing n_sd (K5).

Both run on the ``GPU`` backend unless the caller passes
``backend_class=CPU``. The benchmark's wall clock waits for the device
before it is read."""

import time

import torch

from ..backends import GPU
from ..physics import si
from .shima_et_al_2009 import Settings as ShimaSettings, run as run_shima
from .srivastava_1982 import Settings as SrivastavaSettings
from .srivastava_1982 import coalescence_and_breakup_eq13


def bartman_2020_fig_4(
    n_sds=(2**13,), dts=(10 * si.s, "adaptive"), backend_class=GPU, seed=44
):
    """{(n_sd, dt): (states, wall_time)} of Shima box runs; with dt =
    'adaptive' the nominal dt is 10 s and the substep adapts per cell"""
    out = {}
    for n_sd in n_sds:
        for dt in dts:
            settings = ShimaSettings(seed=seed)
            settings.n_sd = n_sd
            settings.dt = 10 * si.s if dt == "adaptive" else dt
            settings.adaptive = dt == "adaptive"
            out[(n_sd, dt)] = run_shima(settings, backend_class)
    return out


def _synchronize():
    """wait for the card, where there is one, before a clock is read"""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bulenok_2023_benchmark(
    n_sds=(2**10, 2**12),
    n_steps=64,
    total_number=1e12,
    backend_class=GPU,
    seed=44,
):
    """the Srivastava setup's coalescence-and-breakup throughput:
    {n_sd: {"wall_time": s, "pair_updates_per_s": rate, "mean_mass_final",
    "analytic_final"}}"""
    results = {}
    for n_sd in n_sds:
        settings = SrivastavaSettings(
            srivastava_c=0.5e-6 / si.s,
            srivastava_beta=1e-9 / si.s,
            frag_mass=0.25 * si.g,
            drop_mass_0=1 * si.g,
            dt=1 * si.s,
            dv=1 * si.m**3,
            n_sds=(n_sd,),
            total_number=total_number,
            backend_class=backend_class,
        )
        _synchronize()
        t0 = time.perf_counter()
        res = coalescence_and_breakup_eq13(
            settings=settings, n_steps=n_steps, seed=seed
        )
        _synchronize()
        elapsed = time.perf_counter() - t0
        results[n_sd] = {
            "wall_time": elapsed,
            "pair_updates_per_s": n_sd / 2 * n_steps / elapsed,
            "mean_mass_final": float(
                res["pysdm"][n_sd]["mean mass to frag mass"][-1]
            ),
            "analytic_final": float(
                res["analytic_mean_mass_to_frag_mass"][-1]
            ),
        }
    return results
