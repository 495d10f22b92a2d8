"""Checkpoint and resume on the card at small sizes (``chip_smoke.py``
phase 46 runs them at full width). Marked ``cuda``: skipped where torch
sees no CUDA device; run on a GPU host with
``python -m pytest tests/unit/test_torch_cuda_utils.py --noconftest``.

- the adaptive Golovin box at 2^16 resumes bit for bit through
  ``save_npz`` / ``restore_npz`` and through ``save_dcp`` /
  ``restore_dcp``: every leaf, ``n_steps`` and both generator states
  (the card's a (seed, offset) pair) equal, K1's launches equal;
- an 8 x 8 x 64 warm rain resumes bit for bit, K2's, K3's and K4's
  launches equal;
- ``restore_npz`` of a card state keeps float32 and the device.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
from pysdm_tpu_torch.utils import checkpoint  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(name="gpu")
def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pysdm_tpu_torch.backends import GPU

    return GPU


def round_trip(build, tmp_path, fmt, first=5, then=10):
    """run A: ``first`` steps, the checkpoint, ``then`` more; run B, built the
    same way: the restore and ``then`` steps; returns (A, B, A's launches,
    B's launches)"""
    save = getattr(checkpoint, f"save_{fmt}")
    restore = getattr(checkpoint, f"restore_{fmt}")
    path = tmp_path / f"state.{fmt}"
    a = build()
    a.run(first)
    save(a, path)
    launches_a, _ = chip_smoke._counted_steps(a, then)
    b = build()
    restore(b, path)
    assert b.n_steps == first
    launches_b, _ = chip_smoke._counted_steps(b, then)
    return a, b, launches_a, launches_b


@pytest.mark.usefixtures("gpu")  # chip_smoke.build_box builds on the card
@pytest.mark.parametrize("fmt", ("npz", "dcp"))
def test_box_resumes_bit_for_bit_on_the_card(tmp_path, fmt):
    a, b, launches_a, launches_b = round_trip(
        lambda: chip_smoke.build_box(2**16, 1, True), tmp_path, fmt
    )
    assert b.device.type == "cuda"
    assert b.device_rng.device.type == "cuda"
    assert chip_smoke.state_differences(a, b) == []
    assert launches_a == launches_b
    assert launches_b["coalesce_mirror"] >= 10


def test_warm_rain_resumes_bit_for_bit_on_the_card(gpu, tmp_path):
    def build():
        _, p, spin_up = chip_smoke.warm_rain(gpu, (8, 8), 64)
        spin_up.finish()
        return p

    a, b, launches_a, launches_b = round_trip(build, tmp_path, "npz")
    assert chip_smoke.state_differences(a, b) == []
    assert launches_a == launches_b
    for name in ("coalesce_adjacent", "masses_new", "cumsum"):
        assert launches_b[name] > 0, name


def test_restore_keeps_float32_on_the_card(gpu, tmp_path):
    a = chip_smoke.build_parcel(32, gpu, True)
    a.run(3)
    checkpoint.save_npz(a, tmp_path / "state.npz")
    b = chip_smoke.build_parcel(32, gpu, True)
    checkpoint.restore_npz(b, tmp_path / "state.npz")
    for key, value in chip_smoke.state_leaves(b).items():
        if torch.is_tensor(value) and key.startswith(("particles/", "env/")):
            assert value.device.type == "cuda", key
            if value.is_floating_point():
                assert value.dtype == torch.float32, key
    assert chip_smoke.state_differences(a, b) == []
    a.run(2)
    b.run(2)
    assert chip_smoke.state_differences(a, b) == []
