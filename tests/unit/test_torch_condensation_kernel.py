"""K3's plain twin (``pysdm_tpu_torch/ops/cuda/condensation.py``
``masses_new_reference``, taken by ``masses_new`` for CPU tensors) against
the TPU kernel ``fused_masses_new`` run in interpret mode, in float32, on
4096 drops made with numpy from a seed by ``chip_smoke.k3_rows`` (the cell
rows expanded to drops on the JAX side, as ``pysdm_tpu/ops/condensation.py``
expands them).

Cases, one cell each: a supersaturated growing cell; subsaturated haze
settled at its float32 equilibrium (the regime of
``test_f32_equilibrium_haze_succeeds_at_x_old``); an inactive cell, and dead
(multiplicity 0) and zero-mass drops; a non-finite root (dt_sub = 1e30 under
supersaturation drives the bisection past x_max, where exp overflows).

Tolerances:
- ``success`` is equal drop for drop;
- rtol_x = 0 (both bisect to the 40-halving cap): the twin's mass within
  rtol 1e-5 of the float64 root (the twin run on the rows made float64) on
  every drop, and the two kernels within 2e-5 of each other wherever the
  TPU kernel, too, lies within 1e-5 of that root. It does not on 3 of the
  1024 growing drops (up to 1.8e-4 away): there its bisection took an exact
  zero of minfun at a midpoint for "root above" and walked to the upper
  end of the bracket (``test_exact_zero_of_minfun_is_the_root``);
- rtol_x = 1e-2: log-mass within 2 rtol_x |x_old|, since the twin stops each
  drop on its own bracket and the TPU kernel a whole block at once.

Then the twin's root search (``ops/condensation.py``
``drop_solve(per_drop=True)``: Chandrupatla's interpolation with a
bisection safeguard, the bracket cut at x_max) where the safeguard and the
cut have to act, against the float64 root and the TPU kernel, and the one
case in which the two report different outcomes (a root beyond x_max).
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
from pysdm_tpu.ops.pallas.condensation import make_fused_masses_new

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
import pysdm_tpu_torch  # noqa: E402
from pysdm_tpu_torch.ops import condensation as cond_ops  # noqa: E402
from pysdm_tpu_torch.ops.condensation import (  # noqa: E402
    DropSolveSettings,
    drop_solve,
    thermo,
)
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402

RH_RTOL, MAX_ITERS, BISECT_ITERS = 1e-7, 16, 64
# case -> the cells of ``chip_smoke.k3_rows`` holding its drops
CASES = {
    "growing": (0,),
    "haze_at_f32_equilibrium": (1,),
    "inactive_dead_zero_mass": (2, 3),
    "non_finite_root": (4,),
}
ARG_ORDER = chip_smoke.K3_ARGS
FORMULAE = pysdm_tpu_torch.Formulae(seed=44)


def run_k3(formulae, settings, rows):
    """``masses_new`` on CPU tensors of the rows; numpy (mass_new, success)"""
    return chip_smoke.k3_call(k3.masses_new, formulae, settings, rows, "cpu")


@functools.cache
def _inputs():
    return chip_smoke.settle_haze(
        pysdm_tpu_torch.Formulae(seed=44), chip_smoke.k3_rows(4096), "cpu"
    )


def _pallas(rows, rtol_x):
    """the TPU kernel in interpret mode on the rows, their cell rows
    expanded to drops; numpy (mass_new, success)"""
    fused = make_fused_masses_new(
        pysdm_tpu.Formulae(seed=44), RH_rtol=RH_RTOL, max_iters=MAX_ITERS,
        bisect_iters=BISECT_ITERS, rtol_x=rtol_x,
    )
    cell = rows["cell_id"]
    act_d = np.where(rows["multiplicity"] > 0, rows["active"][cell], False)
    zeros = np.zeros_like(rows["water_mass"])
    mass, success = fused(
        *(jnp.asarray(a, jnp.float32) for a in (
            rows["water_mass"], rows["vdry"], rows["kappa"], zeros, zeros,
            rows["thd"][cell], rows["qv"][cell], rows["rhod"][cell],
            rows["dt_sub"][cell], act_d, rows["rho_air"][cell],
            rows["mu_air"][cell],
        )),
        interpret=True,
    )
    return np.asarray(mass), np.asarray(success)


@functools.cache
def _both(rtol_x):
    rows = _inputs()
    twin = run_k3(
        pysdm_tpu_torch.Formulae(seed=44),
        DropSolveSettings(rtol_x, RH_RTOL, MAX_ITERS, BISECT_ITERS), rows,
    )
    return twin, _pallas(rows, rtol_x)


@functools.cache
def _float64_roots():
    """the twin's masses at rtol_x = 0 on the rows made float64"""
    rows = {
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in _inputs().items()
    }
    return run_k3(
        FORMULAE, DropSolveSettings(0.0, RH_RTOL, MAX_ITERS, BISECT_ITERS), rows
    )[0]


@pytest.mark.parametrize("rtol_x", (0.0, 1e-2))
@pytest.mark.parametrize("case", tuple(CASES))
def test_twin_matches_pallas_kernel(case, rtol_x):
    rows = _inputs()
    (mass_t, succ_t), (mass_j, succ_j) = _both(rtol_x)
    sel = np.isin(rows["cell_id"], CASES[case])
    old = rows["water_mass"][sel]
    mass_t, mass_j = mass_t[sel], mass_j[sel]
    np.testing.assert_array_equal(succ_t[sel], succ_j[sel])
    if rtol_x == 0:
        root = _float64_roots()[sel]
        np.testing.assert_allclose(mass_t, root, rtol=1e-5)
        on_root = np.isclose(mass_j, root, rtol=1e-5, atol=0)
        np.testing.assert_allclose(mass_t[on_root], mass_j[on_root], rtol=2e-5)
    else:
        x_old = np.abs(np.log(np.where(old > 0, old, 1e-18).astype(np.float64)))
        moved = (mass_t > 0) & (mass_j > 0)
        dx = np.abs(
            np.log(mass_t[moved].astype(np.float64))
            - np.log(mass_j[moved].astype(np.float64))
        )
        assert (dx <= 2 * rtol_x * x_old[moved]).all()
        np.testing.assert_array_equal(mass_t[~moved], mass_j[~moved])
    if case == "growing":
        assert (mass_t > old).all() and succ_t[sel].all()
    if case == "haze_at_f32_equilibrium":
        assert succ_t[sel].all()
        if rtol_x == 0:
            np.testing.assert_allclose(mass_t, old, rtol=1e-4)
    if case == "inactive_dead_zero_mass":
        inert = (rows["cell_id"][sel] == 2) | (rows["multiplicity"][sel] == 0)
        inert |= old == 0
        np.testing.assert_array_equal(mass_t[inert], old[inert])
        assert succ_t[sel][inert].all()
    if case == "non_finite_root":
        assert not succ_t[sel].any()
        np.testing.assert_array_equal(mass_t, old)


def test_wrapper_takes_the_twin_on_cpu_without_a_launch():
    rows = chip_smoke.k3_rows(4096)
    formulae = pysdm_tpu_torch.Formulae(seed=44)
    settings = DropSolveSettings(1e-6, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    before = k3.masses_new.launches
    got = run_k3(formulae, settings, rows)
    assert k3.masses_new.launches == before
    want = k3.masses_new_reference(
        formulae, settings, *(torch.from_numpy(rows[k]) for k in ARG_ORDER)
    )
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_wrapper_checks_its_rows():
    rows = chip_smoke.k3_rows(4096)
    formulae = pysdm_tpu_torch.Formulae(seed=44)
    settings = DropSolveSettings(1e-6, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    bad = dict(rows, cell_id=rows["cell_id"].astype(np.int64))
    with pytest.raises(TypeError, match="cell_id"):
        run_k3(formulae, settings, bad)
    bad = dict(rows, active=rows["active"].astype(np.float32))
    with pytest.raises(TypeError, match="active"):
        run_k3(formulae, settings, bad)


def test_kernel_refuses_other_variants():
    """K3 takes every variant set the JAX package's condensation takes;
    what it refuses are the particle shapes without the formulae
    condensation needs, which the JAX package cannot condense on either"""
    formulae = pysdm_tpu_torch.Formulae(seed=44, ventilation="Froessling1938")
    k3.check_variants(formulae)
    formulae = pysdm_tpu_torch.Formulae(
        seed=44, particle_shape_and_density="PorousSpheroid"
    )
    with pytest.raises(NotImplementedError, match="PorousSpheroid.*mass_to_volume"):
        k3.check_variants(formulae)
    assert not hasattr(
        pysdm_tpu.Formulae(
            particle_shape_and_density="PorousSpheroid"
        ).particle_shape_and_density,
        "mass_to_volume",
    )


def test_constants_reach_the_kernel_params():
    settings = DropSolveSettings(1e-6, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    formulae = pysdm_tpu_torch.Formulae(seed=44, constants={"sgm_w": 0.05})
    params = k3.kernel_params(formulae, settings)
    const = formulae.constants
    # folded in double as the formula body folds it, then rounded to f32
    assert params.koehler_A == np.float32(2 * 0.05 / const.Rv)
    assert params.bisect_cap == 40 and params.max_iters == MAX_ITERS
    assert params.coordinate == 1 and params.hygroscopicity == 1
    assert params.drop_growth == 2 and params.kinetics == 0
    assert list(params.svp)[:9] == [
        np.float32(getattr(const, f"FWC_C{k}")) for k in range(9)
    ]


def _drop_solve_f32_and_f64(per_drop, rows):
    """``drop_solve`` on the rows in float32 with the given stopping rule,
    and with the per-drop rule in float64; numpy masses"""
    masses = []
    for dtype, rule in ((torch.float32, per_drop), (torch.float64, True)):
        t = {k: torch.from_numpy(v) for k, v in rows.items()}
        cell = t["cell_id"].long()

        def at_drops(name):
            return t[name].to(dtype)[cell]

        T, p, RH, lv, pvs, DTp, KTp, Sc = thermo(
            FORMULAE, at_drops("thd"), at_drops("qv"), at_drops("rhod"),
            at_drops("rho_air"), at_drops("mu_air"),
        )
        zeros = torch.zeros(len(cell), dtype=dtype)
        mass, _ = drop_solve(
            FORMULAE, DropSolveSettings(0.0, RH_RTOL, MAX_ITERS, BISECT_ITERS),
            water_mass=t["water_mass"].to(dtype), vdry=t["vdry"].to(dtype),
            kappa=t["kappa"].to(dtype), f_org=zeros, reynolds=zeros,
            active_drop=t["active"][cell] & (t["multiplicity"] > 0),
            dt_sub=at_drops("dt_sub"), T=T, p=p, RH=RH, lv=lv, pvs=pvs,
            DTp=DTp, KTp=KTp, Sc=Sc, per_drop=rule,
        )
        masses.append(mass.numpy().astype(np.float64))
    return masses


@pytest.mark.parametrize("per_drop", (True, False))
def test_exact_zero_of_minfun_is_the_root(per_drop):
    """Near the root, float32 minfun moves in steps of an ulp of x_old, so a
    midpoint can give exactly 0. The JAX package's rule (``flo * fmid < 0``,
    on its XLA path and in its TPU kernel) takes that for "root above": lo
    moves to mid, flo becomes 0, and every later halving moves lo up, so the
    drop ends at the upper end of that bracket. K3's per-drop rule stops at
    the exact zero. On 16387 drops, rtol_x = 0: the per-drop rule lands
    within 1e-5 (log-mass) of the float64 root everywhere; the JAX package's
    global rule, which the port's CPU path keeps for float64 parity, misses
    it by more than 1e-4 at a drop (2.2e-4 measured)."""
    f32, f64 = _drop_solve_f32_and_f64(per_drop, chip_smoke.k3_rows(16387))
    moved = f64 > 0
    error = np.abs(np.log(f32[moved]) - np.log(f64[moved]))
    if per_drop:
        assert error.max() < 1e-5
    else:
        assert error.max() > 1e-4


def _twin(rows, settings, stats=None):
    """``masses_new_reference`` on CPU tensors of the rows, in their dtype"""
    return chip_smoke.k3_call(
        lambda *a: k3.masses_new_reference(*a, stats=stats),
        FORMULAE, settings, rows, "cpu",
    )


def _float64(rows):
    return {
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in rows.items()
    }


def _cell_4(dt_sub):
    """the drops of ``chip_smoke.k3_rows``' supersaturated cell 4 under a
    substep of ``dt_sub`` seconds"""
    rows = chip_smoke.k3_rows(4096)
    in_cell = rows["cell_id"] == 4
    only = {k: v[in_cell] if v.shape[0] == 4096 else v for k, v in rows.items()}
    only["dt_sub"] = np.full(5, dt_sub, np.float32)
    return only


def test_interpolation_needs_a_third_of_the_halvings_evaluations():
    """the growing drops of ``chip_smoke.k3_rows`` at rtol_x = 1e-6: two
    evaluations for the bracket and ~4 rounds, where halving a bracket of
    width |dx_old| down to 1e-6 |x_old| takes ~16"""
    rows = chip_smoke.k3_rows(4096)
    growing = rows["cell_id"] == 0
    rows = {
        k: v[growing] if v.shape[0] == 4096 else v for k, v in rows.items()
    }
    stats = {}
    mass, success = _twin(
        rows, DropSolveSettings(*chip_smoke.K3_SETTINGS), stats
    )
    assert success.all() and (mass > rows["water_mass"]).all()
    assert stats["minfun_evaluations"] < 8 * growing.sum()


def test_safeguard_bisects_where_interpolation_is_unsafe(monkeypatch):
    """on the float32 plateau near the root (rtol_x = 0: every drop runs to
    the round cap, minfun moving in ulps of x_old) Chandrupatla's criterion
    must send rounds to bisection: the fractions handed out include exact
    halves after the first round, every one lies inside the bracket, and
    the result stays within 1e-5 (log-mass) of the float64 root"""
    fractions = []
    real = cond_ops._interpolation_fraction

    def recording(*args):
        t = real(*args)
        fractions.append(t)
        return t

    monkeypatch.setattr(cond_ops, "_interpolation_fraction", recording)
    rows = chip_smoke.k3_rows(4096)
    settings = DropSolveSettings(0.0, *chip_smoke.K3_SETTINGS[1:])
    mass, _ = _twin(rows, settings)
    f32_rounds = len(fractions)
    assert f32_rounds == 40
    assert (fractions[0] == 0.5).all()  # no third point yet
    late = torch.stack(fractions[20:f32_rounds])
    assert (late == 0.5).any() and ((late >= 0) & (late <= 1)).all()
    monkeypatch.setattr(cond_ops, "_interpolation_fraction", real)
    root, _ = _twin(_float64(rows), settings)
    moved = (mass != rows["water_mass"]) & (root > 0)
    error = np.abs(np.log(mass[moved].astype(np.float64)) - np.log(root[moved]))
    assert error.max() < 1e-5


def test_a_bracket_past_x_max_is_cut_there():
    """dt_sub = 1e30 under supersaturation sends the bracket's far end to
    ~1e28 in the log coordinate, past x_max = 0 (a 1 kg drop). One
    evaluation at x_max (minfun above zero there: the root lies beyond)
    ends the drop as a non-finite root ends: mass kept, success false,
    three evaluations in all"""
    only = _cell_4(1e30)
    stats = {}
    mass, success = _twin(
        only, DropSolveSettings(*chip_smoke.K3_SETTINGS), stats
    )
    assert not success.any()
    np.testing.assert_array_equal(mass, only["water_mass"])
    assert stats["minfun_evaluations"] == 3 * mass.size


@pytest.mark.parametrize("rtol_x", (0.0, 1e-2))
def test_root_below_x_max_in_a_bracket_past_it_matches_pallas_kernel(rtol_x):
    """a 3e5 s step: the explicit estimate overshoots x_max while the
    implicit root stays below it (a drop of ~2-4 mg). The twin cuts the
    bracket at x_max (minfun below zero there) and searches inside it; the
    TPU kernel halves the whole bracket. Same success; at rtol_x = 0 both
    on the float64 root (the twin within 1e-5, as in
    ``test_twin_matches_pallas_kernel``), at 1e-2 within 2 rtol_x |x_old|
    of each other"""
    only = _cell_4(3e5)
    settings = DropSolveSettings(rtol_x, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    mass_t, succ_t = _twin(only, settings)
    mass_j, succ_j = _pallas(only, rtol_x)
    assert succ_t.all() and succ_j.all()
    assert (mass_t > 1e3 * only["water_mass"]).all() and (mass_t < 1.0).all()
    if rtol_x == 0:
        root = _twin(_float64(only), settings)[0]
        np.testing.assert_allclose(mass_t, root, rtol=1e-5)
        # 40 halvings of a bracket that reaches far past x_max leave the TPU
        # kernel up to 1.6e-5 from the root
        np.testing.assert_allclose(mass_j, root, rtol=2e-5)
    else:
        x_old = np.abs(np.log(only["water_mass"].astype(np.float64)))
        dx = np.abs(
            np.log(mass_t.astype(np.float64)) - np.log(mass_j.astype(np.float64))
        )
        assert (dx <= 2 * rtol_x * x_old).all()


def test_a_root_beyond_x_max_fails_where_the_pallas_kernel_reports_success():
    """where the port departs from the JAX package (ROADMAP queue 3). A
    1e12 s step puts the root beyond x_max and the bracket's far end at
    ~1e10, where exp overflows. The TPU kernel's 40 halvings end astride
    x_max in a bracket still ~0.01 to tens wide and it reports success with
    whatever mass the middle gives, here above a tonne for some drops (at
    1e30 s the middle overflows and it fails, as the non_finite_root case
    shows). K3 and its twin fail at every such step: the mass is kept, the
    adaptive substepping sees the failure"""
    only = _cell_4(1e12)
    settings = DropSolveSettings(1e-6, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    mass_t, succ_t = _twin(only, settings)
    assert not succ_t.any()
    np.testing.assert_array_equal(mass_t, only["water_mass"])
    assert not _twin(_float64(only), settings)[1].any()
    mass_j, succ_j = _pallas(only, 1e-6)
    assert succ_j.all()
    assert (mass_j > 1e3 * only["water_mass"]).all() and mass_j.max() > 1e3
