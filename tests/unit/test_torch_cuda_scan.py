"""K4, the prefix sum (``csrc/scan.cu``), against its plain twin
(``torch.cumsum`` in the input's dtype) and against a float64 prefix sum,
on the card. Marked ``cuda``: skipped where torch sees no CUDA device; run
on a GPU host with ``python -m pytest tests/unit/test_torch_cuda_scan.py
--noconftest``.

Tolerances: integers exactly. float32 prefix sums of values in [0, 1) within
rtol 1e-5 of the float64 prefix: each output is a sum along a chain of at
most ~40 roundings (3 in a lane, 5 in the chunk's shuffle scan, 3 + 7 over
the chunks and warps of the tile, ~15 in the tree over the predecessors'
totals, 3 for the offsets), each of at most 2^-24 of the prefix. Repeated
runs, a row of an ``(R, n)`` call and a scan queued beside another on a
second stream all give the same bits: the order of the additions depends on
the position in the row only.
"""

import numpy as np
import pytest
import torch

from pysdm_tpu_torch.ops import segments
from pysdm_tpu_torch.ops.cuda import scan

pytestmark = pytest.mark.cuda

# below a tile (4096), around one, the warm rain's, and past one group of
# 1024 tiles (2^22)
SIZES = (1, 2047, 4095, 4096, 4097, 2**20, 2_560_000, 2**22 + 12345)


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
    exact = np.cumsum(x_np.astype(np.float64))
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5)
    for _ in range(2):
        assert torch.equal(got, scan.cumsum(x))


@pytest.mark.parametrize("n", (1, 4097, 2_560_000 + 12345, 2**22 + 4096 * 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.int32, torch.int64))
def test_rows_in_one_launch_equal_their_1d_scans(device, n, dtype):
    """n + 12345 is odd, so rows 1-3 are not 16-byte aligned and take the
    scalar loads"""
    rng = np.random.default_rng(n)
    x_np = (
        rng.uniform(size=(4, n)).astype(np.float32)
        if dtype == torch.float32 else rng.integers(-1000, 1000, (4, n))
    )
    x = torch.from_numpy(x_np).to(dtype).to(device)
    launches, rows = scan.cumsum.launches, scan.cumsum.rows
    got = scan.cumsum(x)
    assert scan.cumsum.launches == launches + 1
    assert scan.cumsum.rows == rows + 4
    assert got.shape == x.shape and got.dtype == dtype
    for r in range(4):
        assert torch.equal(got[r], scan.cumsum(x[r]))
    if dtype != torch.float32:
        assert torch.equal(got, scan.cumsum_reference(x))


def test_two_streams_at_once_give_the_same_bits(device):
    rng = np.random.default_rng(11)
    xs = [
        torch.from_numpy(rng.uniform(size=2_560_000).astype(np.float32)).to(device)
        for _ in range(2)
    ]
    alone = [scan.cumsum(x) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in xs]
    together = [[], []]
    for _ in range(20):
        for k, (x, stream) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(stream):
                together[k].append(scan.cumsum(x))
    torch.cuda.synchronize()
    for k, results in enumerate(together):
        for got in results:
            assert torch.equal(got, alone[k])


def test_a_stream_keeps_its_scratch_across_shapes(device):
    """flags carry a generation number and are never cleared: launches of
    other shapes and dtypes in between must not disturb a later one"""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-9, 9, 2**20)).to(device)
    want = scan.cumsum_reference(x)
    for n in (5000, 2**20, 300_000, 2**20):
        for dtype in (torch.int32, torch.float32, torch.int64):
            scan.cumsum(x[:n].to(dtype))
        assert torch.equal(scan.cumsum(x), want)


def test_more_shapes_than_the_scratch_table_holds(device):
    """the table drops the buffer used longest ago: a shape that comes back
    gets a new zeroed buffer and the same bits"""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(size=2**16).astype(np.float32)).to(device)
    sizes = [2**16 - 7 * k for k in range(scan._SCRATCH_ENTRIES + 8)]
    first = [scan.cumsum(x[:n]) for n in sizes]
    assert len(scan._SCRATCH) <= scan._SCRATCH_ENTRIES
    for n, want in zip(sizes, first):
        assert torch.equal(scan.cumsum(x[:n]), want)
        exact = torch.cumsum(x[:n].double(), 0)
        assert ((want - exact).abs() <= 1e-5 * exact).all()


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


def test_segment_sums_of_rows_through_one_launch(device):
    rng = np.random.default_rng(4)
    n, n_cell = 2**18 + 5, 625
    cell = np.sort(rng.integers(0, n_cell, n))
    cell_start = torch.from_numpy(
        np.searchsorted(cell, np.arange(n_cell + 1))
    ).to(device)
    values = torch.from_numpy(rng.uniform(size=(3, n)).astype(np.float32)).to(device)
    before = scan.cumsum.launches
    got = segments.sorted_segment_sum(values, cell_start, n_cell)
    assert scan.cumsum.launches == before + 1
    assert got.shape == (3, n_cell)
    for r in range(3):
        assert torch.equal(
            got[r], segments.sorted_segment_sum(values[r], cell_start, n_cell)
        )


def test_rejects_other_dtypes(device):
    with pytest.raises(TypeError, match="float64"):
        scan.cumsum(torch.ones(10, dtype=torch.float64, device=device))
    with pytest.raises(ValueError, match="1D or 2D"):
        scan.cumsum(torch.ones((2, 3, 4), dtype=torch.float32, device=device))
