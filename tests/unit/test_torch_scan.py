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


def test_non_1d_input_is_refused():
    with pytest.raises(ValueError, match="1D"):
        scan.cumsum(torch.ones((2, 3)))
