"""K4, the prefix sum (``csrc/scan.cu``), against its plain twin
(``torch.cumsum`` in the input's dtype) and against a float64 prefix sum,
on the card. Marked ``cuda``: skipped where torch sees no CUDA device; run
on a GPU host with ``python -m pytest tests/unit/test_torch_cuda_scan.py
--noconftest``.

Tolerances: integers exactly. float32 prefix sums of values in [0, 1) within
rtol 1e-5 of the float64 prefix: each output is a sum along a chain of at
most ~40 roundings (8 in a thread, 5 + 3 in the tile's shuffle scans, ~11
in the scan of tile totals, one for the offset), each of at most 2^-24 of
the prefix. Two runs give the same bits.
"""

import numpy as np
import pytest
import torch

from pysdm_tpu_torch.ops import segments
from pysdm_tpu_torch.ops.cuda import scan

pytestmark = pytest.mark.cuda

SIZES = (1, 2047, 2048, 2049, 2**20, 2_560_000, 2**22 + 12345)


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64))
def test_integers_exact(device, n, dtype):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dtype).to(device)
    before = scan.cumsum.launches
    got = scan.cumsum(x)
    torch.cuda.synchronize()
    assert scan.cumsum.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got, scan.cumsum_reference(x), rtol=0, atol=0)


@pytest.mark.parametrize("n", SIZES)
def test_float32_within_bound_and_deterministic(device, n):
    rng = np.random.default_rng(n)
    x_np = rng.uniform(size=n).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    got = scan.cumsum(x)
    again = scan.cumsum(x)
    exact = np.cumsum(x_np.astype(np.float64))
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5)
    assert torch.equal(got, again)


def test_segment_sums_through_the_kernel(device):
    rng = np.random.default_rng(3)
    n, n_cell = 2**18 + 5, 625
    cell = np.sort(rng.integers(0, n_cell, n))
    cell_start = torch.from_numpy(np.searchsorted(cell, np.arange(n_cell + 1)))
    values = rng.integers(0, 100, n).astype(np.int64)
    got = segments.sorted_segment_sum(
        torch.from_numpy(values).to(device), cell_start.to(device), n_cell
    )
    want = np.bincount(cell, weights=values, minlength=n_cell).astype(np.int64)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_rejects_other_dtypes(device):
    with pytest.raises(TypeError, match="float64"):
        scan.cumsum(torch.ones(10, dtype=torch.float64, device=device))
