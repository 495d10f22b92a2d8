"""K2, the sort-croupier coalescence kernel (``csrc/collision_adjacent.cu``),
against its plain PyTorch twin, both on the card. Marked ``cuda``: skipped
where torch sees no CUDA device; run on a GPU host with
``python -m pytest tests/unit/test_torch_cuda_adjacent.py --noconftest``.

Inputs: ``chip_smoke.k2_state`` (cell-sorted slots, dead trailing bucket,
ties, multiplicities up to 2^40). Tolerances: multiplicities exactly;
extensive rows to rtol 1e-6 (float32) or 1e-12 (float64) and rate rows to
rtol 1e-6, since kernel and twin round every operation alike.
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
from pysdm_tpu_torch.ops.cuda import collision as port  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", (4096, 2**16 + 3))
@pytest.mark.parametrize("n_ext", (1, 3))
@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
def test_kernel_matches_twin_on_card(device, n, n_ext, ext_dtype):
    mult, ext, kernnorm, rand, is_first, _ = chip_smoke.k2_state(
        n, 37, n_ext, ext_dtype, seed=n + n_ext
    )
    args = [
        torch.from_numpy(a).to(device)
        for a in (mult, ext, kernnorm, rand, is_first)
    ]
    before = port.coalesce_adjacent.launches
    got = port.coalesce_adjacent(*args)
    torch.cuda.synchronize()
    assert port.coalesce_adjacent.launches == before + 1
    expected = port.coalesce_adjacent_reference(*args)
    got = [x.cpu().numpy() for x in got]
    expected = [x.cpu().numpy() for x in expected]
    np.testing.assert_array_equal(got[0], expected[0])
    assert 0.05 < (got[0] != mult).mean() < 0.95
    rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got[1], expected[1], rtol=rtol)
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e, rtol=1e-6)
    assert (got[2][~is_first] == 0).all()


def test_wrapper_rejects_what_the_kernel_cannot_take(device):
    mult = torch.ones(8, dtype=torch.int64, device=device)
    ext = torch.ones((1, 8), dtype=torch.float32, device=device)
    row = torch.ones(8, dtype=torch.float32, device=device)
    is_first = torch.zeros(8, dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="rand"):
        port.coalesce_adjacent(mult, ext, row, row.cpu(), is_first)
    with pytest.raises(TypeError, match="is_first"):
        port.coalesce_adjacent(mult, ext, row, row, is_first.int())
