"""The Hopper breakup kernel K5 (``csrc/collision_breakup.cu``) against its
plain PyTorch twin, both on the card. Marked ``cuda``: skipped where torch
sees no CUDA device; run on a GPU host with ``python -m pytest
tests/unit/test_torch_cuda_breakup.py --noconftest``.

Tolerances: multiplicities equal at coalescing, bouncing and idle slots; at
breakup slots equal on > 99.9% of all slots and within rel 1e-4 elsewhere
(the float32 transfer runs through expf/logf/log1pf, which the kernel and
torch's CUDA ops may round an ulp apart); extensive rows to rtol 1e-6 where
the multiplicities agree; the five sums to rtol 1e-5 (a fixed order over
pairs, warps and blocks against torch.sum). At every K of a small n, ξ and
rows bit-equal to the twin. Launches on the same inputs are bit-equal, rate
sums included, alone or queued on two streams at once.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pysdm_tpu_torch.dynamics.collisions import breakup_efficiencies as be
from pysdm_tpu_torch.dynamics.collisions import breakup_fragmentations as bf
from pysdm_tpu_torch.dynamics.collisions import coalescence_efficiencies as ce
from pysdm_tpu_torch.dynamics.collisions import collision_kernels as ck
from pysdm_tpu_torch.ops.cuda import breakup as port

pytestmark = pytest.mark.cuda

MAX_MULTIPLICITY = 2**63 // int(2e5)
FUNCTIONS = {
    "config2": (ck.Geometric(), ce.Berry1967(), be.ConstEb(1.0),
                bf.Exponential(scale=4 / 3 * np.pi * (100e-6) ** 3)),
    "mixed": (ck.ConstantK(a=1e-9), ce.ConstEc(0.5), be.ConstEb(0.5),
              bf.AlwaysN(4)),
    "linear-constmass": (ck.Linear(a=1e-10, b=1e3), ce.Berry1967(),
                         be.ConstEb(0.8), bf.ConstantMass(1e-10)),
    "golovin-nfmax": (ck.Golovin(b=1.5e3), ce.ConstEc(0.2), be.ConstEb(0.7),
                      bf.Exponential(4e-15, vmin=1e-15, nfmax=50)),
    "simplegeometric": (ck.SimpleGeometric(C=2e3), ce.ConstEc(0.5),
                        be.ConstEb(0.5), bf.AlwaysN(4)),
}


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(n, K, name, n_ext, ext_dtype, device, seed):
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    radius = np.exp(rng.uniform(np.log(5e-6), np.log(500e-6), n))
    volume = 4 / 3 * np.pi * radius**3
    ext = np.concatenate([
        volume[None, :] * 1e3, rng.uniform(1e-18, 1e-16, (n_ext - 1, n))
    ]).astype(ext_dtype)
    rows = {
        "volume": volume, "radius": radius,
        "relative fall velocity": 4 * (radius / 50e-6) ** 0.5,
        "area": 4 * np.pi * radius**2,
    }
    functions = port.PairFunctions.of(*FUNCTIONS[name])
    attrs = {
        key: torch.from_numpy(rows[key].astype(np.float32)).to(device)
        for key in port.required_rows(functions)
    }
    kernel = FUNCTIONS[name][0]
    values = kernel.pairwise(None, attrs, {k: v.flip(0) for k, v in attrs.items()})
    scale = 1.0 / (np.median(mult[mult > 0]) * float(values.median()))
    return (
        torch.from_numpy(mult).to(device), torch.from_numpy(ext).to(device), 0,
        attrs, functions,
        torch.tensor([scale], dtype=torch.float32, device=device), K, 97531,
        MAX_MULTIPLICITY,
    )


@pytest.mark.parametrize("n", (4096, 2**17 + 5))
@pytest.mark.parametrize("n_ext, ext_dtype", ((1, np.float32), (2, np.float64)))
@pytest.mark.parametrize("name", FUNCTIONS)
def test_kernel_matches_twin_on_card(device, n, n_ext, ext_dtype, name):
    K = n // 3 * 2 + 1
    args = _args(n, K, name, n_ext, ext_dtype, device, seed=n + n_ext)
    before = port.coalesce_breakup_mirror.launches
    got = port.coalesce_breakup_mirror(*args)
    torch.cuda.synchronize()
    assert port.coalesce_breakup_mirror.launches == before + 1
    processes = {}
    want = port.coalesce_breakup_mirror_reference(*args, processes=processes)
    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in want]
    broke = processes["breakup"].cpu().numpy()
    assert broke.any() and processes["coalescence"].any()
    same = got[0] == want[0]
    assert (same | broke).all()
    rel = np.abs(got[0] - want[0].astype(float)) / np.maximum(
        np.maximum(got[0], want[0]), 1
    )
    assert same.mean() > 0.999 and rel.max() < 1e-4
    assert got[1].dtype == ext_dtype
    np.testing.assert_allclose(got[1][:, same], want[1][:, same], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)


@pytest.mark.parametrize("n", (17, 256))
@pytest.mark.parametrize("name", ("config2", "mixed"))
def test_every_K_of_a_small_n_matches_twin_bit_for_bit(device, n, name):
    """odd n and the slots that pair with themselves are where a map from
    pair index to slots breaks"""
    for K in range(n):
        args = _args(n, K, name, 2, np.float32, device, seed=n + K)
        got = port.coalesce_breakup_mirror(*args)
        want = port.coalesce_breakup_mirror_reference(*args)
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
        _args(n, K, "config2", 1, np.float32, device, seed=K) for K in (5, 77)
    ]
    chip_smoke.check_deterministic(torch, port.coalesce_breakup_mirror, inputs, "K5")


def test_kernel_refuses_unknown_ids(device):
    args = list(_args(4096, 7, "mixed", 1, np.float32, device, seed=1))
    args[4] = args[4]._replace(frag=99)
    with pytest.raises(ValueError, match="fragmentation"):
        port.coalesce_breakup_mirror(*args)


def test_box_through_kernel_and_twin(device):
    """config #2's box at 2^12 on the GPU backend, one step through K5 and
    one with the twin in its place on the same draws: the bounds above"""
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as model

    runs = []
    for twin in (False, True):
        settings = model.Settings0D()
        settings.n_sd = 2**12
        saved = collision.coalesce_breakup_mirror
        if twin:
            collision.coalesce_breakup_mirror = (
                port.coalesce_breakup_mirror_reference
            )
        try:
            out = model.run_box_breakup(settings, steps=[1])
        finally:
            collision.coalesce_breakup_mirror = saved
        assert out.core.device.type == "cuda"
        runs.append(out)
    mult = [r.core.attributes["multiplicity"] for r in runs]
    rel = np.abs(mult[0] - mult[1].astype(float)) / np.maximum(mult[0], 1)
    assert (mult[0] == mult[1]).mean() > 0.999 and rel.max() < 1e-4
    np.testing.assert_allclose(runs[0].rates, runs[1].rates, rtol=1e-5)


def test_spectrum_moments_deterministic_on_card(device):
    """the per-(bin, cell) sums on the card: two calls bit-equal (no float
    atomics), and in float64 within rtol 1e-12 of the CPU's"""
    from pysdm_tpu_torch.ops.moments import spectrum_moments

    rng = np.random.default_rng(3)
    n, n_cell = 2**17, 4
    volume = 10.0 ** rng.uniform(-18, -9, n)
    args = {
        "multiplicity": rng.integers(0, 10**9, n), "attr_data": volume,
        "x_attr": volume, "cell_id": rng.integers(0, n_cell, n),
        "x_bins": 10.0 ** np.linspace(-17, -10, 64),
    }
    results = {}
    for where, dtype in (("cpu", torch.float64), (device, torch.float64),
                         (device, torch.float32)):
        tensors = {
            k: torch.from_numpy(v).to(where) if k in ("multiplicity", "cell_id")
            else torch.from_numpy(v).to(where, dtype)
            for k, v in args.items()
        }
        runs = [
            spectrum_moments(**tensors, rank=1, n_cell=n_cell) for _ in range(2)
        ]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        results[(str(where), dtype)] = [x.cpu().numpy() for x in runs[0]]
    on_card = results[(str(device), torch.float64)]
    for g, w in zip(on_card, results[("cpu", torch.float64)]):
        np.testing.assert_allclose(g, w, rtol=1e-12)
