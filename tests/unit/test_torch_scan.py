"""K4's module (``pysdm_tpu_torch/ops/cuda/scan.py``) and the per-cell sums
over it (``ops/segments.py`` ``sorted_segment_sum``) against the JAX
package: the TPU kernel ``_cumsum_pallas`` in interpret mode and
``pysdm_tpu.ops.segments.sorted_segment_sum``.

On the CPU the wrapper takes its twin, ``torch.cumsum`` in the input's
dtype (``test_torch_cuda_scan.py`` holds the kernel against it on the
card). Integers must be equal. float32 prefix sums of values in [0, 1)
agree to rtol 2e-6: both sides round each of a chain of additions to
2^-24 of the prefix, in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops import segments as jax_segments
from pysdm_tpu.ops.pallas.scan import _BLOCK, _cumsum_pallas
from pysdm_tpu_torch.ops import segments
from pysdm_tpu_torch.ops.cuda import scan

SIZES = (_BLOCK, 2 * _BLOCK, _BLOCK + 12345)


@pytest.mark.parametrize("n", SIZES)
def test_float32_twin_matches_pallas_kernel(n):
    x = np.random.default_rng(n).uniform(size=n).astype(np.float32)
    expected = np.asarray(_cumsum_pallas(jnp.asarray(x), interpret=True))
    got = scan.cumsum(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-6)


@pytest.mark.parametrize("n", SIZES)
def test_int32_twin_matches_pallas_kernel_exactly(n):
    x = np.random.default_rng(n).integers(-1000, 1000, n).astype(np.int32)
    expected = np.asarray(_cumsum_pallas(jnp.asarray(x), interpret=True))
    got = scan.cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("dtype", (np.float64, np.int64, np.float32))
def test_sorted_segment_sum_matches_jax_package(dtype):
    rng = np.random.default_rng(7)
    n, n_cell = 5000, 64
    cell = np.sort(rng.integers(0, n_cell + 1, n)).astype(np.int32)
    cell_start = np.searchsorted(cell, np.arange(n_cell + 1)).astype(np.int32)
    values = rng.uniform(0, 100, n).astype(dtype)
    expected = np.asarray(jax_segments.sorted_segment_sum(
        jnp.asarray(values), jnp.asarray(cell_start), n_cell
    ))
    got = segments.sorted_segment_sum(
        torch.from_numpy(values), torch.from_numpy(cell_start).long(), n_cell
    ).numpy()
    assert got.dtype == dtype
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, expected)
    else:
        # a per-cell sum is a difference of prefixes up to ~n * 50: its
        # error is ~eps of the prefix, not of the cell's own sum
        prefix = np.cumsum(values.astype(np.float64))[-1]
        atol = 64 * np.finfo(dtype).eps * prefix
        np.testing.assert_allclose(got, expected, rtol=0, atol=atol)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
def test_rows_match_pallas_kernel_row_for_row(n, dtype):
    """an (R, n) tensor is scanned along its rows: each row against the TPU
    kernel on that row (int32 exactly, float32 to the bound above), and
    equal to the row's own 1D call bit for bit"""
    rng = np.random.default_rng(n + 1)
    x = (
        rng.uniform(size=(3, n)) if dtype == np.float32
        else rng.integers(-1000, 1000, (3, n))
    ).astype(dtype)
    got = scan.cumsum(torch.from_numpy(x))
    assert got.shape == (3, n) and got.numpy().dtype == dtype
    for r in range(3):
        expected = np.asarray(_cumsum_pallas(jnp.asarray(x[r]), interpret=True))
        if dtype == np.int32:
            np.testing.assert_array_equal(got[r].numpy(), expected)
        else:
            np.testing.assert_allclose(got[r].numpy(), expected, rtol=2e-6)
        assert torch.equal(got[r], scan.cumsum(torch.from_numpy(x[r])))


@pytest.mark.parametrize("dtype", (np.float64, np.int64, np.float32))
def test_sorted_segment_sum_of_rows_matches_single_calls_and_jax(dtype):
    rng = np.random.default_rng(8)
    n, n_cell, n_rows = 5000, 64, 4
    cell = np.sort(rng.integers(0, n_cell + 1, n)).astype(np.int32)
    cell_start = np.searchsorted(cell, np.arange(n_cell + 1)).astype(np.int32)
    values = rng.uniform(0, 100, (n_rows, n)).astype(dtype)
    start = torch.from_numpy(cell_start).long()
    got = segments.sorted_segment_sum(torch.from_numpy(values), start, n_cell)
    assert got.shape == (n_rows, n_cell) and got.numpy().dtype == dtype
    for r in range(n_rows):
        single = segments.sorted_segment_sum(
            torch.from_numpy(values[r]), start, n_cell
        )
        assert torch.equal(got[r], single)
        expected = np.asarray(jax_segments.sorted_segment_sum(
            jnp.asarray(values[r]), jnp.asarray(cell_start), n_cell
        ))
        if np.issubdtype(dtype, np.integer):
            np.testing.assert_array_equal(got[r].numpy(), expected)
        else:
            prefix = np.cumsum(values[r].astype(np.float64))[-1]
            atol = 64 * np.finfo(dtype).eps * prefix
            np.testing.assert_allclose(got[r].numpy(), expected, rtol=0, atol=atol)


def test_wrapper_counts_no_launch_on_cpu():
    launches, rows = scan.cumsum.launches, scan.cumsum.rows
    scan.cumsum(torch.ones((4, 10)))
    assert (scan.cumsum.launches, scan.cumsum.rows) == (launches, rows)


def test_non_1d_input_is_refused():
    """more than 2D is refused: a 2D tensor is scanned row by row"""
    with pytest.raises(ValueError, match="1D or 2D"):
        scan.cumsum(torch.ones((2, 3, 4)))
    assert scan.cumsum(torch.ones((2, 3))).tolist() == [[1, 2, 3], [1, 2, 3]]


def test_scratch_table_is_bounded_and_numbers_its_launches(monkeypatch):
    """the wrapper's table of flag buffers: one zeroed buffer per (device,
    stream, rows, n) with a generation that rises by one a launch; at most
    ``_SCRATCH_ENTRIES`` buffers, the one used longest ago making room"""

    class Library:
        @staticmethod
        def pysdm_cumsum_scratch_bytes(rows, n):
            return 8 * rows * n

    monkeypatch.setattr(scan, "_SCRATCH", {})
    cpu = torch.device("cpu")
    first, generation = scan._scratch(Library, cpu, 0, 2, 8)
    assert (first.numel(), generation, int(first.sum())) == (128, 1, 0)
    assert scan._scratch(Library, cpu, 0, 2, 8)[1] == 2
    assert scan._scratch(Library, cpu, 1, 2, 8)[0] is not first  # its stream's
    for n in range(1, scan._SCRATCH_ENTRIES - 1):
        scan._scratch(Library, cpu, 0, 1, n)
    assert len(scan._SCRATCH) == scan._SCRATCH_ENTRIES
    again, generation = scan._scratch(Library, cpu, 0, 2, 8)
    assert again is first and generation == 3  # used: now the newest
    scan._scratch(Library, cpu, 0, 1, 1000)
    assert len(scan._SCRATCH) == scan._SCRATCH_ENTRIES
    assert (None, 1, 2, 8) not in scan._SCRATCH  # stream 1's was the oldest
    assert scan._scratch(Library, cpu, 0, 2, 8)[0] is first
