"""K2's module (``pysdm_tpu_torch/ops/cuda/collision.py``
``coalesce_adjacent``) against the JAX package's TPU kernel
``fused_coalesce`` run in interpret mode on the CPU.

On the CPU the port's wrapper takes its plain PyTorch twin (the CUDA kernel
runs only on the card; ``test_torch_cuda_adjacent.py`` holds it against the
twin there). Inputs: ``chip_smoke.k2_state``, cell-sorted slots with a dead
trailing bucket, ties and multiplicities up to 2^40, R = 1 and R = 3
extensive rows. Tolerances: multiplicities exactly; extensive rows to rtol
1e-6 (float32) or 1e-12 (float64) and rate rows to rtol 1e-6, since both
sides round every operation alike.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops.pallas.collision import fused_coalesce
from pysdm_tpu_torch.ops.cuda import collision as port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402

N = 4096


def _run_both(mult, ext, kernnorm, rand, is_first):
    expected = fused_coalesce(
        jnp.asarray(mult), jnp.asarray(ext), jnp.asarray(kernnorm),
        jnp.asarray(rand), jnp.asarray(is_first), interpret=True,
    )
    got = port.coalesce_adjacent(
        *(torch.from_numpy(a) for a in (mult, ext, kernnorm, rand, is_first))
    )
    return [np.asarray(x) for x in expected], [x.numpy() for x in got]


@pytest.mark.parametrize("n_ext, ext_dtype", (
    (1, np.float32), (3, np.float32), (3, np.float64),
))
def test_twin_matches_pallas_kernel(n_ext, ext_dtype):
    mult, ext, kernnorm, rand, is_first, _ = chip_smoke.k2_state(
        N, 37, n_ext, ext_dtype, seed=n_ext
    )
    expected, got = _run_both(mult, ext, kernnorm, rand, is_first)
    np.testing.assert_array_equal(got[0], expected[0])
    assert 0.05 < (got[0] != mult).mean() < 0.95
    assert got[1].dtype == ext_dtype
    rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got[1], expected[1], rtol=rtol)
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e, rtol=1e-6)
    # the dead bucket never changes
    dead = mult == 0
    np.testing.assert_array_equal(got[0][dead], 0)
    np.testing.assert_array_equal(got[1][:, dead], ext[:, dead])


def test_large_quotient_regime_port_is_exact():
    """floor(xi_j/xi_k) between ~2^26 and the cap: the TPU kernel's f32
    quotient estimate is off by more than its 5 correction steps, so its
    gamma misses the exact floor. The port divides in int64 and is exact;
    the JAX kernel is the side at fault here (ROADMAP.md, queue 3)."""
    pairs = (
        (1057166230302, 4467),  # estimate 15 above the floor
        (1067892856719, 1973),  # estimate 28 above the floor
        (623967171686, 5461),  # estimate 7 below the floor
    )
    n = 64
    mult = np.zeros(n, np.int64)
    is_first = np.zeros(n, bool)
    for i, (mj, mk) in enumerate(pairs):
        mult[2 * i], mult[2 * i + 1] = mj, mk
        is_first[2 * i] = True
    ext = np.ones((1, n), np.float32)
    # gamma_f far above every quotient: the cap 2^31 - 128 binds, then the
    # multiplicity ratio
    kernnorm = np.full(n, 1e3, np.float32)
    rand = np.full(n, 0.5, np.float32)
    expected, got = _run_both(mult, ext, kernnorm, rand, is_first)
    for i, (mj, mk) in enumerate(pairs):
        assert got[0][2 * i] == mj - (mj // mk) * mk
        assert got[0][2 * i + 1] == mk
    assert (got[0] != expected[0]).any()
    assert (got[0] >= 0).all()


def test_wrapper_checks_its_inputs():
    mult, ext, kernnorm, rand, is_first, _ = (
        torch.from_numpy(a) for a in chip_smoke.k2_state(64, 3, 1, np.float32, 0)
    )
    with pytest.raises(TypeError, match="is_first"):
        port.coalesce_adjacent(mult, ext, kernnorm, rand, is_first.int())
    with pytest.raises(TypeError, match="mult"):
        port.coalesce_adjacent(mult.int(), ext, kernnorm, rand, is_first)
    with pytest.raises(TypeError, match="ext"):
        port.coalesce_adjacent(mult, ext[0], kernnorm, rand, is_first)
