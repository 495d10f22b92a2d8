"""The Hopper mirror-coalescence kernels (``csrc/collision_mirror.cu``: K1,
and K1a with the kernel values given as rows) against their plain PyTorch
twins, both on the card. Marked ``cuda``: skipped
where torch sees no CUDA device; run on a GPU host with
``python -m pytest tests -m cuda``.

The kernel reads the collision kernel's attribute rows in the order of
their names (``KERNEL_ROWS``): the volume for Golovin, Linear and ConstantK,
radius and fall velocity for Geometric, area and radius for
SimpleGeometric. Tolerances: multiplicities exactly; extensive rows to rtol 1e-6 (float32) or
1e-12 (float64), and bit for bit at every K of a small n (the kernel and the
twin round the same products and sums once each); rate sums to rtol 1e-5
(the kernel sums per pair, warp and block in a fixed order, the twin with
torch.sum). Launches on the same inputs are bit-equal, rate sums included,
alone or queued on two streams at once. K1a (``coalesce_mirror_rows``) is
held to the same bounds, and bit for bit at every K of a small n. K1a's
Parameterized form (``coalesce_mirror_parameterized``), which evaluates
the Berry 1967 kernels in its body, is held to its twin bit for bit in
multiplicities and rows, float32 and float64 rows of either kind, at
sizes from one ragged warp to 2^20, Berry 1967's 2^13 among them.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pysdm_tpu_torch.ops.cuda import collision as port

pytestmark = pytest.mark.cuda


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(n, K, ext_dtype, seed, kernel_id=port.GOLOVIN):
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, size=(2, n)).astype(ext_dtype)
    volume = rng.uniform(1e-15, 1e-12, size=n)
    radius = (volume * 3 / 4 / np.pi) ** (1 / 3)
    rows = {
        "volume": volume, "radius": radius,
        "relative fall velocity": rng.uniform(0.0, 8.0, size=n),
        "area": 4 * np.pi * radius**2,
    }
    attr = np.stack([rows[name] for name in port.KERNEL_ROWS[kernel_id]])
    return mult, ext, attr.astype(np.float32)


# scales of 2e-3 put the median pair near one expected collision with
# multiplicities up to 2^40 (Golovin's median kernel value is ~1e-9)
KERNELS = (
    (port.GOLOVIN, (1.5e3, 0.0)),
    (port.LINEAR, (2e-10, 1e3)),
    (port.CONSTANT_K, (1e-9, 0.0)),
    (port.GEOMETRIC, (np.pi * 0.8, 0.0)),
    (port.SIMPLE_GEOMETRIC, (1e7, 0.0)),
)


@pytest.mark.parametrize("n", (4096, 2**16 + 3))
@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
@pytest.mark.parametrize("kernel_id, params", KERNELS)
def test_kernel_matches_twin_on_card(device, n, ext_dtype, kernel_id, params):
    K = n // 3 * 2
    mult, ext, attr = _state(n, K, ext_dtype, seed=n, kernel_id=kernel_id)
    args = [
        torch.from_numpy(a).to(device) for a in (mult, ext, attr)
    ]
    scale = torch.tensor([2e-3], dtype=torch.float32, device=device)
    before = port.coalesce_mirror.launches
    got = port.coalesce_mirror(*args, kernel_id, params, scale, K, 987654321)
    torch.cuda.synchronize()
    assert port.coalesce_mirror.launches == before + 1
    expected = port.coalesce_mirror_reference(
        *args, kernel_id, params, scale, K, 987654321
    )
    got = [x.cpu().numpy() for x in got]
    expected = [x.cpu().numpy() for x in expected]
    np.testing.assert_array_equal(got[0], expected[0])
    assert (got[0] != mult).mean() > 0.05
    rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got[1], expected[1], rtol=rtol)
    for g, e in zip(got[2:], expected[2:]):
        np.testing.assert_allclose(g, e, rtol=1e-5)


def _on(device, mult, ext, attr, K, kernel_id=port.GOLOVIN, params=(1.5e3, 0.0)):
    """the wrapper's arguments on ``device``"""
    return (
        *(torch.from_numpy(a).to(device) for a in (mult, ext, attr)),
        kernel_id, params,
        torch.tensor([2e-3], dtype=torch.float32, device=device), K, 987654321,
    )


@pytest.mark.parametrize("n", (17, 256))
@pytest.mark.parametrize("kernel_id, params", (KERNELS[0], KERNELS[3]))
def test_every_K_of_a_small_n_matches_twin_bit_for_bit(device, n, kernel_id, params):
    """odd n and the slots that pair with themselves are where a map from
    pair index to slots breaks: ξ and rows bit-equal to the twin at every K"""
    for K in range(n):
        state = _state(n, K, np.float32, seed=n + K, kernel_id=kernel_id)
        args = _on(device, *state, K, kernel_id, params)
        got = port.coalesce_mirror(*args)
        want = port.coalesce_mirror_reference(*args)
        assert torch.equal(got[0], want[0]), K
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)), K
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)


def test_launches_are_deterministic_alone_and_on_two_streams(device):
    """three launches on the same inputs bit-equal, rate sums included; two
    inputs' launches queued on two streams at once (each stream has its own
    ticket counter and partials) bit-equal to the launches alone"""
    n = 2**18 + 3
    inputs = [
        _on(device, *_state(n, K, np.float32, seed=K), K) for K in (5, 77)
    ]
    chip_smoke.check_deterministic(torch, port.coalesce_mirror, inputs, "K1")


def test_wrapper_rejects_mixed_devices(device):
    mult = torch.ones(8, dtype=torch.int64, device=device)
    ext = torch.ones((1, 8), dtype=torch.float32)
    volume = torch.ones((1, 8), dtype=torch.float32, device=device)
    scale = torch.ones(1, dtype=torch.float32, device=device)
    with pytest.raises(ValueError, match="ext"):
        port.coalesce_mirror(mult, ext, volume, port.GOLOVIN, (1.0, 0.0), scale, 3, 1)


def test_wrapper_rejects_rows_of_another_kernel(device):
    """Geometric reads two rows; one volume row is refused"""
    mult = torch.ones(8, dtype=torch.int64, device=device)
    ext = torch.ones((1, 8), dtype=torch.float32, device=device)
    volume = torch.ones((1, 8), dtype=torch.float32, device=device)
    scale = torch.ones(1, dtype=torch.float32, device=device)
    with pytest.raises(TypeError, match="relative fall velocity"):
        port.coalesce_mirror(mult, ext, volume, port.GEOMETRIC, (1.0, 0.0), scale, 3, 1)


def _rows_state(n, K, ext_dtype, seed, device):
    """K1a's arguments on ``device``: a random state as ``_state``'s, a
    kernel x norm row that gives up to ~8 collisions a pair, a u01 row"""
    mult, ext, _ = _state(n, K, ext_dtype, seed)
    rng = np.random.default_rng(seed + 1)
    kernnorm = (rng.uniform(0.0, 8.0, size=n) / 2**40).astype(np.float32)
    u01 = rng.uniform(size=n).astype(np.float32)
    return (
        *(torch.from_numpy(a).to(device) for a in (mult, ext, kernnorm, u01)),
        K,
    )


@pytest.mark.parametrize("n", (17, 4096, 2**13, 2**14, 2**16 + 3, 2**20))
@pytest.mark.parametrize("ext_dtype", (np.float32, np.float64))
def test_rows_kernel_matches_twin_on_card(device, n, ext_dtype):
    args = _rows_state(n, n // 3 * 2, ext_dtype, n, device)
    before = port.coalesce_mirror_rows.launches
    got = port.coalesce_mirror_rows(*args)
    torch.cuda.synchronize()
    assert port.coalesce_mirror_rows.launches == before + 1
    want = port.coalesce_mirror_rows_reference(*args)
    assert torch.equal(got[0], want[0])
    assert (got[0] != args[0]).float().mean().item() > 0.05
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)


def test_rows_kernel_every_K_of_a_small_n_bit_for_bit(device):
    for n in (17, 256):
        for K in range(n):
            args = _rows_state(n, K, np.float32, n + K, device)
            got = port.coalesce_mirror_rows(*args)
            want = port.coalesce_mirror_rows_reference(*args)
            assert torch.equal(got[0], want[0]), (n, K)
            assert torch.equal(got[1], want[1]), (n, K)


@pytest.mark.parametrize("n", (2**13, 2**18 + 3))
def test_rows_kernel_launches_are_deterministic(device, n):
    inputs = [_rows_state(n, K, np.float32, K, device) for K in (5, 77)]
    chip_smoke.check_deterministic(
        torch, port.coalesce_mirror_rows, inputs, "K1a"
    )


def _parameterized_state(n, K, ext_dtype, attr_dtype, seed, device,
                         kernel="Hydrodynamic"):
    """the arguments of K1a's Parameterized form on ``device``: a random
    state as ``_state``'s, radius and fall-velocity rows of cloud and rain
    drops (2% at radius 0), a scale that gives the median pair ~2
    collisions at xi ~ 2^39, a u01 row"""
    from pysdm_tpu_torch.dynamics.collisions import collision_kernels
    from pysdm_tpu_torch.ops.cuda.collision import parameterized_kernel

    mult, ext, _ = _state(n, K, ext_dtype, seed)
    rng = np.random.default_rng(seed + 2)
    radius = np.exp(rng.uniform(np.log(1e-6), np.log(300e-6), n))
    radius[rng.uniform(size=n) < 0.02] = 0.0
    fall = 8e3 * radius * rng.uniform(0.9, 1.1, n)
    params = getattr(collision_kernels, kernel)().params
    rows = {"radius": torch.from_numpy(radius),
            "relative fall velocity": torch.from_numpy(fall)}
    po = torch.remainder(K - torch.arange(n), n)
    values = parameterized_kernel(
        params, rows, {k: v[po] for k, v in rows.items()}
    ).numpy()
    positive = values[values > 0]
    scale = 4.0 / (2**40 * (np.median(positive) if positive.size else 1e-9))
    u01 = rng.uniform(size=n).astype(np.float32)
    on = lambda a, dtype=None: torch.from_numpy(  # noqa: E731
        a if dtype is None else a.astype(dtype)
    ).to(device)
    return (
        on(mult), on(ext), on(radius, attr_dtype), on(fall, attr_dtype),
        params, on(np.array([scale]), attr_dtype), on(u01), K,
    )


@pytest.mark.parametrize("n", (17, 4096, 2**13, 2**14, 2**20))
@pytest.mark.parametrize("ext_dtype, attr_dtype", (
    (np.float32, np.float32), (np.float64, np.float64),
    (np.float32, np.float64),
))
@pytest.mark.parametrize("kernel", ("Hydrodynamic", "Electric"))
def test_parameterized_kernel_matches_twin_on_card(device, n, ext_dtype,
                                                   attr_dtype, kernel):
    args = _parameterized_state(n, n // 3 * 2, ext_dtype, attr_dtype, n,
                                device, kernel)
    before = port.coalesce_mirror_parameterized.launches
    got = port.coalesce_mirror_parameterized(*args)
    torch.cuda.synchronize()
    assert port.coalesce_mirror_parameterized.launches == before + 1
    want = port.coalesce_mirror_parameterized_reference(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)
    if n >= 4096:
        assert (got[0] != args[0]).float().mean().item() > 0.05


@pytest.mark.parametrize("n", (2**13, 2**20))
def test_parameterized_kernel_launches_are_deterministic(device, n):
    inputs = [
        _parameterized_state(n, K, np.float32, np.float32, K, device)
        for K in (5, 77)
    ]
    chip_smoke.check_deterministic(
        torch, port.coalesce_mirror_parameterized, inputs,
        f"K1a's Parameterized form, n={n}",
    )

