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
    # every fourth drop frozen (``chip_smoke.k3_rows_with_ice``): the ice
    # bit-equal to its input and solved, in kernel and twin
    "MixedPhaseSpheres_with_ice": {
        "particle_shape_and_density": "MixedPhaseSpheres",
    },
}
# the variant sets under which ``chip_smoke.check_k3_regimes`` holds (at
# rtol_x < 1e-2: with 1e-2 a haze drop may stop 1e-2 |x_old| from x_old).
# Not under WaterMass: in the linear coordinate the 1e30 s step stays
# finite. Not under KappaKoehler: its haze (wet radius twice the dry, RH
# 0.6) is unbracketable in the JAX package too, in float64 as in float32
# (ROADMAP queue 3), so kernel and twin report the same failures.
REGIMES_HOLD = (
    "defaults", "Fick", "kinetics_Neglect", "sgm_w_overridden",
    "MixedPhaseSpheres_with_ice",
)


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
    if variants == "MixedPhaseSpheres_with_ice":
        rows = chip_smoke.k3_rows_with_ice(rows)
    before = k3.masses_new.launches
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    assert k3.masses_new.launches == before + 1
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, rows, device
    )
    chip_smoke.compare_k3(rows, kernel, twin, rtol_x)
    chip_smoke.check_k3_ice(rows, *kernel)
    chip_smoke.check_k3_ice(rows, *twin)
    if variants in REGIMES_HOLD and rtol_x < 1e-2:
        chip_smoke.check_k3_regimes(rows, *kernel)


@pytest.mark.parametrize("name, source_cell, active", (
    ("every_drop_growing", 0, True),
    ("every_drop_haze_at_equilibrium", 1, True),
    ("every_cell_inactive", 0, False),
    ("every_bracket_past_x_max", 4, True),
))
def test_uniform_rows_match_twin_on_card(device, name, source_cell, active):
    """the row sets ``chip_smoke.py`` times in phase 5, and one whose every
    bracket is cut at x_max: kernel against twin at the bounds above; an
    inactive drop keeps its mass bit for bit and counts as solved"""
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.k3_uniform_rows(
        chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(N), device),
        source_cell, active,
    )
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, rows, device
    )
    chip_smoke.compare_k3(rows, kernel, twin, settings.rtol_x)
    mass, success = kernel
    if not active:
        np.testing.assert_array_equal(mass, rows["water_mass"])
        assert success.all()
    elif source_cell == 4:
        np.testing.assert_array_equal(mass, rows["water_mass"])
        assert not success.any()
    else:
        assert success.all()


def test_drops_in_a_random_order_take_the_per_thread_cell_state(device):
    """a block whose drops do not lie within eight cells of its first drop's
    computes no shared cell state: each thread computes its cell's. Every
    drop must get the bits it gets among its sorted neighbours, and the
    twin's result on the permuted rows at the bounds above"""
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(N), device)
    permuted, order = chip_smoke.k3_permuted_rows(rows)
    assert (np.diff(permuted["cell_id"][:256]) < 0).any()
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    shuffled = chip_smoke.k3_call(
        k3.masses_new, formulae, settings, permuted, device
    )
    for got, want in zip(shuffled, kernel):
        np.testing.assert_array_equal(got, want[order])
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, permuted, device
    )
    chip_smoke.compare_k3(permuted, shuffled, twin, settings.rtol_x)
    chip_smoke.check_k3_regimes(permuted, *shuffled)


@pytest.mark.parametrize("n_cell", (5, 100, 625, 4096))
def test_sorted_cells_of_any_size_match_twin_on_card(device, n_cell):
    """drops sorted into ``n_cell`` cells: at 100 a block's drops span two
    or three cells (shared state; the last block's eight cells reach past
    the last cell), at 625 about ten and at 4096 sixty-four (more than the
    eight a block shares: per-thread state)"""
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.k3_regrouped_rows(
        chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(N), device), n_cell
    )
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, rows, device
    )
    chip_smoke.compare_k3(rows, kernel, twin, settings.rtol_x)
    mass, success = kernel
    state = rows["cell_id"] % 5
    assert success[state == 0].all() and not success[state == 4].any()
    assert (mass[state == 0] > rows["water_mass"][state == 0]).all()
    np.testing.assert_array_equal(mass[state == 2], rows["water_mass"][state == 2])


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
    formulae.particle_shape_and_density.variant = "PorousSpheroid"
    before = k3.masses_new.launches
    with pytest.raises(NotImplementedError, match="PorousSpheroid"):
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


@pytest.mark.parametrize("name", tuple(chip_smoke.K3_VARIANT_SETS))
def test_every_variant_set_matches_twin_on_card(device, name):
    """the sets of ``chip_smoke.py`` phase 34 (``K3_VARIANT_SETS``): the
    regimes, kernel against twin at ``compare_k3``'s bound, and the drops in
    a random order bit-equal to the sorted ones"""
    formulae = chip_smoke.k3_variant_formulae(name)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.settle_haze(
        formulae, chip_smoke.k3_variant_rows(name, N, seed=5), device
    )
    kernel = chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, device)
    twin = chip_smoke.k3_call(
        k3.masses_new_reference, formulae, settings, rows, device
    )
    chip_smoke.check_k3_regimes(rows, *kernel)
    chip_smoke.check_k3_regimes(rows, *twin)
    chip_smoke.compare_k3(rows, kernel, twin, settings.rtol_x)
    permuted, order = chip_smoke.k3_permuted_rows(rows)
    shuffled = chip_smoke.k3_call(
        k3.masses_new, formulae, settings, permuted, device
    )
    for got, want in zip(shuffled, kernel):
        np.testing.assert_array_equal(got, want[order])


def test_parcel_set_bit_equal_to_the_parent_build(device):
    """the parcel slice's variant set through this build and through the
    build before the variant sets (the ``condensation.cu`` of
    ``chip_smoke.K3_PARENT_COMMIT``, checked by its blob id, from
    ``chip_smoke.K3_PARENT_DIR`` or git; skipped where neither has it):
    bit-equal"""
    parent = chip_smoke._parent_k3(torch)
    if parent is None:
        pytest.skip("the parent build's condensation.cu is not at hand")
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(N), device)
    args = [torch.from_numpy(rows[k]).to(device) for k in chip_smoke.K3_ARGS]
    new = k3.masses_new(formulae, settings, *args)
    old = parent(k3.kernel_params(formulae, settings), args)
    for got, want in zip(new, old):
        assert torch.equal(got, want)
