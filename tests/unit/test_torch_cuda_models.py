"""The models that need only what is ported, on the card at small sizes
(``chip_smoke.py`` phases 38-42 run them at full width). Marked ``cuda``:
skipped where torch sees no CUDA device; run on a GPU host with
``python -m pytest tests/unit/test_torch_cuda_models.py --noconftest``.

- MG2007's mixed-phase grid (6 x 6 x 8): the float64 collision route, no
  K2 launch, K3 launches = solves, K4 launched and, on one step's scans,
  within 1e-5 of the float64 prefix; every freezing temperature one of the
  initial ones;
- the seeding parcel (64 + 16 graves, collisions on): K1 launches =
  collision substeps, K3 = solves, the super-droplet count up by the
  injections; the first K1 substep and K3 solve from t = 330 s, injected
  drops beside graves, against their twins;
- pyrcel at its test's size: K3 launches = solves, the test's bounds, K3
  against its twin on a kept solve;
- the warm rain of Bartman's sweep (6 x 6 x 32, as ``benchmark`` builds
  it): one step's K2 substep, K3 solve and K4 scans against their twins;
- Kreidenweis et al. 2003 at its JAX test's settings (16 super-droplets,
  dt = 10 s, 5 chemistry substeps, 400 s) with the default backend: the
  test's bounds, K3 launches = solves, the pH kernel launched for every
  solve, K3 against its twin on an in-cloud solve, every aqueous amount
  finite.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
from pysdm_tpu_torch.ops import segments  # noqa: E402
from pysdm_tpu_torch.ops.cuda import chemistry as ph  # noqa: E402
from pysdm_tpu_torch.ops.cuda import collision as kern  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402
from pysdm_tpu_torch.ops.cuda import scan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(name="gpu")
def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pysdm_tpu_torch.backends import GPU

    return GPU


def test_mg2007_mixed_phase_grid_on_card(gpu):
    p, spin_up = chip_smoke.mg2007_mixed_phase(gpu, (6, 6), 8)
    spin_up.finish()
    t_fz0 = np.unique(p.attributes["freezing temperature"])
    solver = p.dynamics["Condensation"].solver
    solves0 = solver.substep_solves
    kern.coalesce_adjacent.launches = 0
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    p.run(5)
    p.block_until_ready()
    assert p.dynamics["Collision"].route() == "float64"
    assert kern.coalesce_adjacent.launches == 0
    assert k3.masses_new.launches == solver.substep_solves - solves0 > 0
    assert scan.cumsum.launches > 0
    assert np.isin(p.attributes["freezing temperature"], t_fz0).all()
    assert (p.attributes["multiplicity"] >= 0).all()

    scans, real_k4 = [], segments.cumsum

    def capture(x):
        scans.append(x.clone())
        return real_k4(x)

    with chip_smoke._replaced(segments, "cumsum", capture):
        p.run(1)
    assert scans
    chip_smoke._k4_on_scans(real_k4, scans, "mixed-phase grid")


def test_seeding_parcel_on_card(gpu):
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import seeding

    settings = seeding.Settings(
        # 4 a step for 7 steps: more than the 16 graves hold
        super_droplet_injection_rate=chip_smoke.seeding_rate(15.0, pool=32),
        formulae=Formulae(seed=44), n_sd_initial=64, n_sd_seeding=16,
    )
    sim = seeding.Simulation(settings, backend_class=gpu)
    out, record, kept = chip_smoke.seeding_window(sim)
    assert record["k1_launches"] == record["collision_substeps"] > 0
    assert record["k3_launches"] == record["solves"] > 0
    assert sim.particulator.get_counter("condensation_success").all()
    sd_count = out["products"]["sd_count"]
    assert sd_count[0] == 64 and sd_count.max() == 64 + 16
    # injected drops beside graves: K1 and K3 against their twins
    seen = chip_smoke.seeding_kernels_vs_twins(kept, 64, "seeding parcel")
    assert seen["k3_vs_twin"]["graves"] > 0


def test_pyrcel_on_card(gpu):
    from pysdm_tpu_torch.models import pyrcel

    settings = chip_smoke.pyrcel_settings(16)
    sim = pyrcel.Simulation(settings, backend_class=gpu)
    with chip_smoke._keeping_calls(k3, "masses_new", chip_smoke._power_of_two) as kept:
        out, record = chip_smoke._model_window(sim.particulator, sim.run, settings.nt)
    assert record["k3_launches"] == record["solves"] > 0
    assert 0.001 < np.nanmax(out["products"]["S_max"]) < 0.01
    assert len(kept) > 1
    chip_smoke.k3_on_kept_solve(kept[-1], "pyrcel")


def test_bartman_warm_rain_kernels_on_card(gpu):
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models.arabas_et_al_2015 import Settings, make_simulation

    settings = Settings(Formulae(seed=44), grid=(6, 6), n_sd_per_gridbox=32,
                        dt=5.0, spin_up_time=0)
    p, spin_up = make_simulation(settings, backend_class=gpu)
    spin_up.finish()
    p.run(1)
    seen = chip_smoke._column_kernels_vs_twins(p, "card", label="warm rain 6 x 6 x 32")
    assert seen["masses_new"] is not None


def test_kreidenweis_on_card(gpu):
    from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw

    settings = chip_smoke.kreidenweis_settings(16, 400.0, dt=10.0)
    sim = kw.Simulation(settings)
    p = sim.particulator
    assert p.device.type == "cuda"
    ph.equilibrate_H.launches = 0
    with chip_smoke._keeping_calls(k3, "masses_new", chip_smoke._power_of_two) as kept:
        out, record = chip_smoke._model_window(p, sim.run, settings.nt)
    assert record["k3_launches"] == record["solves"] > 0
    # the pH kernel: two solves a chemistry substep, and one a product read
    assert ph.equilibrate_H.launches >= 2 * settings.n_substep * settings.nt
    assert 3.0 < out["pH"][-1] < 6.0
    assert out["gas_S_IV"][-1] < out["gas_S_IV"][0]
    assert out["liquid water mixing ratio"][-1] > 1e-5
    assert not chip_smoke._nonfinite_chemistry(p)
    chip_smoke.k3_on_kept_solve(kept[-1], "kreidenweis")
