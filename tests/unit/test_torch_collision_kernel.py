"""The port's mirror-coalescence kernel module
(``pysdm_tpu_torch/ops/cuda/collision.py``) against the JAX package's TPU
kernel ``fused_coalesce_mirror_blocks`` run in interpret mode on the CPU.

On the CPU the port's wrapper takes its plain PyTorch twin (the CUDA kernel
runs only on the card; ``test_torch_cuda_kernel.py`` holds it against the
twin there). Both take the collision kernel's attribute rows in the order of
their names: "volume" for Golovin, Linear and ConstantK; "radius",
"relative fall velocity" for Geometric; "area", "radius" for
SimpleGeometric. Tolerances: multiplicities exactly; extensive rows to rtol
1e-6 (float32) or 1e-12 (float64), since both sides round every operation
alike; rate sums to rtol 1e-5, since the float32 sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.dynamics.collisions import collision_kernels as jax_kernels
from pysdm_tpu.ops.pallas.collision import (
    _u01_hash as jax_u01_hash,
    fused_coalesce_mirror_blocks,
)
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as port_kernels
from pysdm_tpu_torch.ops.cuda import collision as port

N = 4096
BLOCK_R = 8  # N % (BLOCK_R * 128) == 0: the blocks kernel's geometry


@pytest.mark.parametrize("seed", (0, 12345, 2**31 + 7, 2**32 - 1))
def test_u01_hash_bit_equal(seed):
    pair_id = np.arange(2**16, dtype=np.int32) * 7 + 3
    expected = np.asarray(
        jax_u01_hash(jnp.uint32(seed), jnp.asarray(pair_id))
    )
    got = port._u01_hash(seed, torch.from_numpy(pair_id)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


def _state(rng, K, big, ext_dtype, names=("volume",)):
    """random single-cell state: 5% dead slots, 5% ties with the partner,
    multiplicities up to 2^40 (big) or 1000; the attribute rows ``names``:
    volumes of 1e-15-1e-12 m^3, radii of 1-100 um, fall velocities of 0-8
    m/s, areas of the radii"""
    mult = rng.integers(1, 2**40 if big else 1000, size=N).astype(np.int64)
    partner = (K - np.arange(N)) % N
    tie = rng.uniform(size=N) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=N) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, size=(2, N)).astype(ext_dtype)
    attrs = {"volume": rng.uniform(1e-15, 1e-12, size=N)}
    if names != ("volume",):
        radius = rng.uniform(1e-6, 1e-4, size=N)
        attrs = {
            "radius": radius,
            "relative fall velocity": rng.uniform(0.0, 8.0, size=N),
            "area": 4 * np.pi * radius**2,
        }
    return mult, ext, {name: attrs[name].astype(np.float32) for name in names}


def _run_both(mult, ext, attrs, jax_kernel, port_kernel, scale, K, seed):
    names = sorted(attrs)
    rows = np.stack([attrs[name] for name in names])
    expected = fused_coalesce_mirror_blocks(
        jnp.asarray(mult), jnp.asarray(ext), jnp.asarray(rows),
        names, lambda a, b: jax_kernel.pairwise(None, a, b),
        scale, K, seed, block_r=BLOCK_R, interpret=True,
    )
    got = port.coalesce_mirror(
        torch.from_numpy(mult), torch.from_numpy(ext),
        torch.from_numpy(rows), port_kernel.kernel_id,
        port_kernel.cuda_params,
        torch.tensor([scale], dtype=torch.float32), K, seed,
    )
    return [np.asarray(x) for x in expected], [x.numpy() for x in got]


KERNELS = {
    "golovin": (jax_kernels.Golovin(b=1.5e3), port_kernels.Golovin(b=1.5e3)),
    "linear": (
        jax_kernels.Linear(a=2e-10, b=1e3), port_kernels.Linear(a=2e-10, b=1e3)
    ),
    "constant": (jax_kernels.ConstantK(a=1e-9), port_kernels.ConstantK(a=1e-9)),
    "geometric": (
        jax_kernels.Geometric(collection_efficiency=0.8),
        port_kernels.Geometric(collection_efficiency=0.8),
    ),
    "simple_geometric": (
        jax_kernels.SimpleGeometric(C=3.0), port_kernels.SimpleGeometric(C=3.0)
    ),
}
CASES = [
    (kernel, big, ext_dtype, K)
    for kernel, big, ext_dtype, K in (
        ("golovin", False, np.float32, 1000),
        ("golovin", False, np.float32, 1001),
        ("golovin", True, np.float32, 2 * 1234),
        ("golovin", True, np.float32, 3001),
        ("golovin", False, np.float64, 4094),
        ("golovin", True, np.float64, 77),
        ("linear", True, np.float32, 2000),
        ("constant", False, np.float64, 3),
        ("geometric", False, np.float32, 1000),
        ("geometric", True, np.float32, 3001),
        ("geometric", True, np.float64, 2 * 1234),
        ("simple_geometric", False, np.float32, 1001),
        ("simple_geometric", True, np.float64, 4094),
    )
]


@pytest.mark.parametrize(
    "kernel, big, ext_dtype, K", CASES,
    ids=[f"{c[0]}-{'big' if c[1] else 'small'}-{c[2].__name__}-K{c[3]}" for c in CASES],
)
def test_twin_matches_pallas_blocks_kernel(kernel, big, ext_dtype, K):
    rng = np.random.default_rng(K)
    jax_kernel, port_kernel = KERNELS[kernel]
    mult, ext, attrs = _state(
        rng, K, big, ext_dtype, port.KERNEL_ROWS[port_kernel.kernel_id]
    )
    # a scale that puts the median pair near one expected collision, so the
    # cases cover gamma = 0, gamma capped by xi_j/xi_k and exhaustion splits
    partner = (K - np.arange(N)) % N
    kv = np.median(np.asarray(jax_kernel.pairwise(
        None, attrs, {name: row[partner] for name, row in attrs.items()}
    )))
    scale = float(1.0 / (np.median(mult[mult > 0]) * kv))
    seed = int(rng.integers(0, 2**32))
    expected, got = _run_both(
        mult, ext, attrs, jax_kernel, port_kernel, scale, K, seed
    )
    np.testing.assert_array_equal(got[0], expected[0])
    changed = got[0] != mult
    assert 0.05 < changed.mean() < 0.95  # the case exercises the update
    rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
    assert got[1].dtype == ext_dtype
    np.testing.assert_allclose(got[1], expected[1], rtol=rtol)
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e, rtol=1e-5)
    # the fixed points 2o = K (mod N) never change
    if K % 2 == 0:
        for o in (K // 2, K // 2 + N // 2):
            assert got[0][o] == mult[o]
            np.testing.assert_array_equal(got[1][:, o], ext[:, o])


def test_large_quotient_regime_port_is_exact():
    """floor(xi_j/xi_k) between ~2^26 and the cap: the TPU kernel's f32
    quotient estimate is off by more than its 5 correction steps, so its
    gamma misses the exact floor (and may even drive xi_j below zero). The
    port divides in int64 and is exact; the JAX kernel is the side at fault
    here (ROADMAP.md, queue 3)."""
    pairs = (
        (1057166230302, 4467),  # estimate 15 above the floor
        (1067892856719, 1973),  # estimate 28 above the floor
        (623967171686, 5461),  # estimate 7 below the floor
    )
    K = 101
    mult = np.zeros(N, np.int64)
    for i, (mj, mk) in enumerate(pairs):
        o = 10 + i
        mult[o], mult[K - o] = mj, mk
    ext = np.ones((1, N), np.float32)
    attrs = {"volume": np.full(N, 1e-12, np.float32)}
    kernel = jax_kernels.Golovin(b=1.5e3), port_kernels.Golovin(b=1.5e3)
    # gamma_f far above every quotient: the cap 2^31 - 128 binds, then the
    # multiplicity ratio
    expected, got = _run_both(mult, ext, attrs, *kernel, 1e6, K, seed=5)
    for i, (mj, mk) in enumerate(pairs):
        o = 10 + i
        assert got[0][o] == mj - (mj // mk) * mk
        assert got[0][K - o] == mk
    differs = got[0] != expected[0]
    assert differs.any()
    assert (got[0] >= 0).all()
