"""The exchange on the card: two ranks share one GPU over gloo, which
carries CUDA tensors through ``all_to_all_single`` by staging them through
the host. ``ring_halo_pad`` (float32 and float64, depth 1 and 2) and
``migrate_ring`` with its overlap pair (int64 multiplicities, float32
rows, an overflow among the cases, and an overflow with the slots
permuted between start and commit) give on CUDA tensors exactly what two
CPU ranks give. Marked ``cuda``: skipped where torch sees no CUDA device;
run on a GPU host with ``python -m pytest
tests/unit/test_torch_cuda_parallel.py --noconftest``."""

import numpy as np
import pytest
import torch

from pysdm_tpu_torch.parallel import multihost, verification

pytestmark = pytest.mark.cuda

N_RANKS = 2
N_LOCAL = 32


def _cases(device):
    rng = np.random.default_rng(11)
    cases = [
        (verification.rank_halo, (
            rng.uniform(size=(6, 5)).astype(dtype), 0, depth, device,
        ))
        for dtype in (np.float32, np.float64) for depth in (1, 2)
    ]
    n = N_RANKS * N_LOCAL
    mult = rng.integers(1, 100, n).astype(np.int64)
    mult[rng.uniform(size=n) < 0.2] = 0
    rows = rng.uniform(size=(3, n)).astype(np.float32)
    shift = rng.integers(-1, 2, n).astype(np.int32)
    # the overlap pair with the slots permuted between start and commit
    cases.append((verification.rank_migration, (
        [mult, rows], shift, 2, 2, True, device, 13,
    )))
    for capacity, overlap in ((16, False), (16, True), (2, True)):
        cases.append((verification.rank_migration, (
            [mult, rows], shift, capacity, 2, overlap, device,
        )))
    return cases


@pytest.fixture(name="runs")
def _runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {
        device: multihost.spawn(
            verification.rank_cases, N_RANKS, _cases(device)
        )
        for device in ("cpu", "cuda")
    }


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def test_exchange_on_cuda_equals_cpu(runs):
    cpu, cuda = (_leaves(runs[d]) for d in ("cpu", "cuda"))
    assert len(cpu) == len(cuda) > 0
    for a, b in zip(cpu, cuda):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the overflow case dropped something and the others nothing
    drops = [
        sum(int(rank[case][1].sum()) for rank in runs["cuda"])
        for case in range(-3, 0)
    ]
    assert drops[0] == drops[1] == 0 < drops[2]
