"""K3, the per-drop condensation solve (``csrc/condensation.cu``), against
its plain PyTorch twin, both on the card. Marked ``cuda``: skipped where
torch sees no CUDA device; run on a GPU host with
``python -m pytest tests/unit/test_torch_cuda_condensation.py --noconftest``.

Inputs: ``chip_smoke.k3_rows`` (growing drops, haze settled at its float32
equilibrium, an inactive cell, dead and zero-mass drops, a non-finite root)
at a ragged size. Tolerances, as in ``chip_smoke.compare_k3``: success
equal drop for drop; where a drop moved, log-mass within
2 rtol_x |x_old| + 2e-5, since kernel and twin each stop inside a bracket of
width rtol_x |x_old|, an ulp in minfun can send the last halvings to either
side, and two float32 libms put the root itself up to ~1e-5 apart; unmoved
drops equal.
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
from pysdm_tpu_torch import Formulae  # noqa: E402
from pysdm_tpu_torch.ops.condensation import DropSolveSettings  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402

pytestmark = pytest.mark.cuda

N = 2**14 + 3
VARIANT_SETS = {
    "defaults": {},
    "Fick": {"drop_growth": "Fick"},
    "Howell1949_KappaKoehler": {
        "drop_growth": "Howell1949", "hygroscopicity": "KappaKoehler",
    },
    "kinetics_Neglect": {"diffusion_kinetics": "Neglect"},
    "WaterMass": {"diffusion_coordinate": "WaterMass"},
    "sgm_w_overridden": {"constants": {"sgm_w": 0.05}},
}
# the variant sets under which ``chip_smoke.check_k3_regimes`` holds (at
# rtol_x < 1e-2: with 1e-2 a haze drop may stop 1e-2 |x_old| from x_old).
# Not under WaterMass: in the linear coordinate the 1e30 s step stays
# finite. Not under KappaKoehler: its haze (wet radius twice the dry, RH
# 0.6) is unbracketable in the JAX package too, in float64 as in float32
# (ROADMAP queue 3), so kernel and twin report the same failures.
REGIMES_HOLD = ("defaults", "Fick", "kinetics_Neglect", "sgm_w_overridden")


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("rtol_x", (0.0, 1e-6, 1e-2))
@pytest.mark.parametrize("variants", tuple(VARIANT_SETS))
def test_kernel_matches_twin_on_card(device, variants, rtol_x):
    formulae = Formulae(seed=44, **VARIANT_SETS[variants])
    settings = DropSolveSettings(rtol_x, *chip_smoke.K3_SETTINGS[1:])
    rows = chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(N), device)
    before = k3.masses_new.launches
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    assert k3.masses_new.launches == before + 1
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, rows, device
    )
    chip_smoke.compare_k3(rows, kernel, twin, rtol_x)
    if variants in REGIMES_HOLD and rtol_x < 1e-2:
        chip_smoke.check_k3_regimes(rows, *kernel)


def test_wrapper_raises_instead_of_falling_back(device):
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = {
        k: torch.from_numpy(v).to(device)
        for k, v in chip_smoke.k3_rows(4096).items()
    }
    as_f64 = dict(rows, water_mass=rows["water_mass"].double())
    with pytest.raises(TypeError, match="float32"):
        k3.masses_new(formulae, settings, *(as_f64[k] for k in chip_smoke.K3_ARGS))
    mixed = dict(rows, vdry=rows["vdry"].cpu())
    with pytest.raises(ValueError, match="cpu"):
        k3.masses_new(formulae, settings, *(mixed[k] for k in chip_smoke.K3_ARGS))
    formulae.ventilation.variant = "Froessling1938"
    before = k3.masses_new.launches
    with pytest.raises(NotImplementedError, match="Froessling1938"):
        k3.masses_new(formulae, settings, *(rows[k] for k in chip_smoke.K3_ARGS))
    assert k3.masses_new.launches == before


@pytest.mark.parametrize("adaptive", (False, True))
def test_parcel_on_card_launches_once_per_solve(device, adaptive):
    from pysdm_tpu_torch.backends import GPU

    p = chip_smoke.build_parcel(256, GPU, adaptive)
    before = k3.masses_new.launches
    p.run(20)
    solver = p.dynamics["Condensation"].solver
    assert k3.masses_new.launches - before == solver.substep_solves
    assert p.get_counter("condensation_success").all()
    assert np.isfinite(p.attributes["water mass"]).all()


def test_counter_without_dtype_takes_the_backends_on_card(device):
    from pysdm_tpu_torch.backends import GPU

    p = chip_smoke.build_parcel(4, GPU, adaptive=True)
    assert p.sim_state["counters"]["condensation_RH_max"].dtype == torch.float32
