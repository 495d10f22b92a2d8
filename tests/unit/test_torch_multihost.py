"""Two "hosts" of 4 ranks each, every rank joined through
``parallel.multihost.initialize`` (gloo on the CPU, local ranks 0-3 on
each host), run the decomposed 2D warm rain of
``tests/smoke/test_torch_distributed_2d.py``: the counterpart of
``tests/distributed/test_multihost.py``. The water budget closes, a
sustained crosswind pushes particles across every slab (and host)
boundary for 40 steps, and every rank reads the same
``global_diagnostics``."""

import functools
import os

import numpy as np
import pytest

from pysdm_tpu_torch.parallel import multihost, verification

HOSTS, RANKS_PER_HOST = 2, 4
N_STEPS = 12
CROSSWIND_STEPS = 40


def _settings(crosswind):
    return functools.partial(
        verification.warm_rain_settings, seed=17, grid=(16, 8),
        n_sd_per_gridbox=8, crosswind=crosswind,
    )


@pytest.fixture(scope="module")
def ranks():
    """every rank's records of the eddy (12 steps) and the crosswind (40)"""
    return multihost.spawn(
        verification.rank_cases, HOSTS * RANKS_PER_HOST,
        [
            (verification.rank_warm_rain, (_settings(False), (N_STEPS,))),
            (verification.rank_warm_rain,
             (_settings(True), (CROSSWIND_STEPS,))),
        ],
        ranks_per_host=RANKS_PER_HOST,
    )


def _check_closed(before, after):
    assert after["condensation_ok"] == 1.0
    assert after["migration_dropped"] == 0.0
    np.testing.assert_allclose(
        after["water_total"], before["water_total"], rtol=1e-3
    )
    assert after["n_alive"] > 0.9 * before["n_alive"]


def test_two_hosts_run_and_conserve_water(ranks):
    for eddy, _ in ranks:
        before, after = (s["diagnostics"] for s in eddy["snapshots"])
        _check_closed(before, after)


def test_two_hosts_sustained_crosswind_migration(ranks):
    """40 steps at courant_x ~ 0.85: particles cross the slab and host
    boundaries again and again; every mover is delivered and the budget
    closes on every rank"""
    for _, crosswind in ranks:
        start, end = crosswind["snapshots"]
        _check_closed(start["diagnostics"], end["diagnostics"])
        assert end["migration_far_moves"] == 0
        assert start["alive_per_rank"] != end["alive_per_rank"]
    totals = [c["snapshots"][-1]["diagnostics"]["water_total"] for _, c in ranks]
    np.testing.assert_allclose(totals, totals[0], rtol=1e-12)


def test_ranks_agree_on_global_state(ranks):
    for case in range(2):
        first = ranks[0][case]["snapshots"][-1]["diagnostics"]
        for rank in ranks[1:]:
            assert rank[case]["snapshots"][-1]["diagnostics"] == first


def test_dryrun_multichip():
    """the port's ``dryrun_multichip``: one full step over 2 ranks on the
    CPU (collisions and sedimentation on), checked there"""
    from pysdm_tpu_torch.backends import CPU
    from pysdm_tpu_torch.parallel.distributed_2d import dryrun_multichip

    out = dryrun_multichip(2, backend_class=CPU)
    assert out["after"]["n_alive"] > 0.9 * out["before"]["n_alive"] > 0


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_shutdown_leaves_no_process_behind():
    """the fork server and the resource tracker that a spawn leaves for
    the next one are gone after ``shutdown``, and a later spawn starts
    them anew"""
    from multiprocessing import forkserver, resource_tracker

    arr = np.arange(24.0).reshape(2, 12)
    multihost.spawn(verification.rank_halo, 2, arr, 1, 1)
    helpers = [
        forkserver._forkserver._forkserver_pid,
        resource_tracker._resource_tracker._pid,
    ]
    assert all(pid is not None and _alive(pid) for pid in helpers)
    multihost.shutdown()
    assert not any(_alive(pid) for pid in helpers)
    multihost.shutdown()
    again = multihost.spawn(verification.rank_halo, 2, arr, 1, 1)
    assert [block.shape for block in again] == [(2, 8), (2, 8)]
