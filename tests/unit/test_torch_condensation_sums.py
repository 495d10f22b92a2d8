"""The condensation substep's per-cell sums, stacked into rows under one
prefix sum (``CondensationSolver._percell_sum`` over ``(R, n)`` rows:
liquid and failures, then the three activation counts), against the
per-row form, one ``sorted_segment_sum`` per row, on the CPU in float64
and float32: every field of the state must be equal bit for bit, because
each row of a stacked sum equals its own call.

The state is ``chip_smoke.warm_rain`` at 8 x 8 cells x 16 super-droplets
(config #5's model entry point, cut to the size of the CPU tests).
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
from pysdm_tpu_torch.backends import CPU, TorchBackend  # noqa: E402
from pysdm_tpu_torch.ops import segments  # noqa: E402
from pysdm_tpu_torch.ops.condensation import CondensationSolver  # noqa: E402
from pysdm_tpu_torch.ops.cuda import scan  # noqa: E402


class CPU32(TorchBackend):
    def __init__(self, formulae=None):
        super().__init__(formulae, torch.float32, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _per_row_sum(self, values, cell_start):
    """the earlier form: one per-cell sum per row"""
    if values.dim() == 1:
        return segments.sorted_segment_sum(values, cell_start, self.n_cell)
    return torch.stack([
        segments.sorted_segment_sum(row, cell_start, self.n_cell)
        for row in values
    ])


def _run(backend, steps, monkeypatch, per_row):
    with monkeypatch.context() as patch:
        if per_row:
            patch.setattr(CondensationSolver, "_percell_sum", _per_row_sum)
        _, p, spin_up = chip_smoke.warm_rain(
            backend, (8, 8), 16, seed=13, spin_up_time=0.0
        )
        spin_up.finish()
        p.run(steps)
    solver = p.dynamics["Condensation"].solver
    state = {
        name: p.attributes[name] for name in ("water mass", "multiplicity")
    }
    state.update({name: p.get_env(name) for name in ("thd", "qv", "RH")})
    for name in ("condensation_RH_max", "condensation_activating",
                 "condensation_deactivating", "condensation_ripening",
                 "condensation_n_substeps", "coalescence_rate"):
        state[name] = p.get_counter(name)
    return state, solver.substep_solves


@pytest.mark.parametrize("backend", (CPU, CPU32), ids=("float64", "float32"))
def test_stacked_sums_equal_the_per_row_form_bit_for_bit(backend, monkeypatch):
    stacked, solves = _run(backend, 6, monkeypatch, per_row=False)
    per_row, solves_per_row = _run(backend, 6, monkeypatch, per_row=True)
    assert solves == solves_per_row and solves >= 12
    assert np.sum(stacked["water mass"] != 0) > 0
    for name, value in stacked.items():
        np.testing.assert_array_equal(value, per_row[name], err_msg=name)


def test_a_real_substep_scans_two_groups_of_rows_and_a_fake_one(monkeypatch):
    """per substep: (liquid, failures) in one scan, and in a real substep
    the three activation counts in a second; the liquid at the step's entry
    once per step"""
    calls = []
    real = scan.cumsum

    def counting(x):
        calls.append(tuple(x.shape[:-1]))
        return real(x)

    monkeypatch.setattr(segments, "cumsum", counting)
    _, p, spin_up = chip_smoke.warm_rain(CPU, (8, 8), 16, seed=13)
    p.run(1)
    solver = p.dynamics["Condensation"].solver
    calls.clear()
    solves0 = solver.substep_solves
    p.run(1)
    solves = solver.substep_solves - solves0
    pairs, triples, singles = (calls.count(s) for s in ((2,), (3,), ()))
    assert pairs == solves  # every substep, fake or real
    assert 1 <= triples <= solves  # the real ones
    assert singles == 1  # the step's entry liquid (collisions are off)
    assert len(calls) == pairs + triples + singles
