"""The pH solve's kernel (``csrc/chemistry.cu``) against its plain twin
(``equilibrate_H_reference``) on the card, on the same float32 and float64
CUDA inputs. Marked ``cuda``: skipped where torch sees no CUDA device; run
on a GPU host with ``python -m pytest tests/unit/test_torch_cuda_chemistry.py
--noconftest``.

Tolerance: H equal to the bit, or, where the kernel's exp and torch's round
a midpoint apart, within the bracket in which the two can part
(``chip_smoke.ph_parting_bracket``: the twin's bisection run again, the
residual's sign also taken at every float within 2 ulps of each midpoint's
exp; the bracket's width at the first midpoint where that sign can change,
else the last bracket's), plus the final exp's rounding (2 ulps of H in
either). After 48 iterations the last bracket is (log H_max - log H_min) /
2^48 = 1.2e-13 in log H in float64; in float32 the bisection stops
narrowing when lo and hi are neighbouring floats (~1e-6 at |log H| ~ 10).
The kernel rounds each of the twin's operations on its own (no FMA, IEEE
division), so with the same exp the two are bit-equal (a g++ build of its
body against the twin with the same libm exp, 20,000 drops in each dtype).
Each test prints the count of drops that differ. The kernel runs one
thread a drop (``csrc/chemistry.cu``), so the drop counts here cover a
warp and a block cut by the end of the rows (17 drops, 2^17 + 37).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
from pysdm_tpu_torch.ops import chemistry as ops  # noqa: E402
from pysdm_tpu_torch.ops.cuda import chemistry as ph  # noqa: E402

pytestmark = pytest.mark.cuda

# a ragged warp, a few blocks, the Kreidenweis parcel's drops, and a ragged
# last block there
N_DROPS = (17, 4096, 2**17, 2**17 + 37)


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(d, dtype, device):
    return {k: torch.from_numpy(v).to(dtype).to(device) for k, v in d.items()}


@pytest.mark.parametrize("n", N_DROPS)
@pytest.mark.parametrize("iters", (0, 1, ph.PH_ITERATIONS - 1, ph.PH_ITERATIONS))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_kernel_matches_twin(device, dtype, iters, n):
    """the kernel against the twin at 0, 1, 47 and 48 iterations, from a
    ragged warp to the Kreidenweis parcel's drops and a ragged last block"""
    conc, K, host = chip_smoke.ph_solve_inputs(n, seed=23)
    c, k = _on(conc, dtype, device), _on(K, dtype, device)
    before = ph.equilibrate_H.launches
    got = ops.equilibrate_H(conc=c, K_drop=k, iters=iters, **host)
    torch.cuda.synchronize()
    assert ph.equilibrate_H.launches == before + 1
    assert got.dtype == dtype and got.device == c["S_VI"].device
    assert got.shape == (n,)
    want = ph.equilibrate_H_reference(conc=c, K_drop=k, iters=iters, **host)
    assert torch.isfinite(got).all()
    seen = chip_smoke.compare_ph_solves(
        got, want, chip_smoke.ph_parting_width(got, want, c, k, host, iters),
        f"{dtype}, {iters} iterations",
    )
    print(f"{n} drops, {dtype}, {iters} iterations: {seen['differ']} of"
          f" {seen['drops']} drops differ from the twin, each within its"
          f" bound: {seen}")
    # the same bits from a second launch
    assert torch.equal(got, ops.equilibrate_H(conc=c, K_drop=k, iters=iters,
                                              **host))


def test_strided_rows(device):
    """rows that are views with a stride take the kernel on their
    contiguous copies"""
    conc, K, host = chip_smoke.ph_solve_inputs(2 * 4099, seed=29)
    c = {n: v[::2] for n, v in _on(conc, torch.float32, device).items()}
    k = {n: v[::2] for n, v in _on(K, torch.float32, device).items()}
    got = ops.equilibrate_H(conc=c, K_drop=k, **host)
    dense = ops.equilibrate_H(
        conc={n: v.contiguous() for n, v in c.items()},
        K_drop={n: v.contiguous() for n, v in k.items()}, **host,
    )
    assert torch.equal(got, dense)


def test_mixed_dtypes_raise(device):
    conc, K, host = chip_smoke.ph_solve_inputs(64, seed=31)
    c, k = _on(conc, torch.float32, device), _on(K, torch.float64, device)
    with pytest.raises(TypeError):
        ops.equilibrate_H(conc=c, K_drop=k, **host)
