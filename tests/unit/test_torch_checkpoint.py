"""Checkpoint and resume on the port (``pysdm_tpu_torch/utils/checkpoint.py``)
on the CPU: ``TestCheckpoint`` of ``tests/unit/test_checkpoint_and_scipy_solver.py``
replayed (the npz round trip of the Golovin box, the shape mismatch, and
the orbax case as the ``torch.distributed.checkpoint`` case), resumes that
draw on both generators (an adaptive box on the host generator, a 2D warm
rain on the sort croupier's device generator) bit for bit, and a state
written by the JAX package's ``save_npz`` carried into the port, after
which the two packages agree to rtol 1e-12 over 5 more steps.

A resume is bit for bit: every leaf of the sim-state, ``n_steps`` and both
generator states equal (``torch.equal``) to the run that went on without
the round trip. A resume that forgot a generator, the host clock or a flag
would still run, and only diverge.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pysdm_tpu import Builder as JaxBuilder
from pysdm_tpu import Formulae as JaxFormulae
from pysdm_tpu.backends import CPU as JaxCPU
from pysdm_tpu.dynamics import (
    AmbientThermodynamics as JaxAmbientThermodynamics,
    Condensation as JaxCondensation,
)
from pysdm_tpu.environments import Parcel as JaxParcel
from pysdm_tpu.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity as JaxConstantMultiplicity,
)
from pysdm_tpu.initialisation.spectra import Lognormal as JaxLognormal
from pysdm_tpu.utils import checkpoint as jax_checkpoint

from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu_torch.initialisation.spectra import Exponential
from pysdm_tpu_torch.models import arabas_et_al_2015
from pysdm_tpu_torch.physics import si
from pysdm_tpu_torch.utils import checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one intra-op thread: the tier-1 run puts several test files on the
    cores at once"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_box(seed=44, n_sd=256, adaptive=False, backend_class=CPU):
    """the JAX test's box (Golovin, 256 super-droplets)"""
    formulae = Formulae(seed=seed)
    env = Box(dv=1e6 * si.m**3, dt=1.0)
    builder = Builder(
        n_sd=n_sd, backend=backend_class(formulae), environment=env
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=adaptive)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
    ).sample(n_sd)
    return builder.build(attributes)


def build_parcel(n_sd=32, backend_class=CPU):
    """the JAX test's parcel (``chip_smoke.build_parcel`` builds it)"""
    return chip_smoke.build_parcel(n_sd, backend_class, True)


def build_jax_parcel(seed=44, n_sd=32):
    """``build_parcel`` in the JAX package"""
    formulae = JaxFormulae(seed=seed)
    env = JaxParcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.0158, T0=300.0, w=2.0,
    )
    builder = JaxBuilder(n_sd=n_sd, backend=JaxCPU(formulae), environment=env)
    builder.add_dynamic(JaxAmbientThermodynamics())
    builder.add_dynamic(JaxCondensation(adaptive=True))
    spectrum = JaxLognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = JaxConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes)


def build_warm_rain(seed=44, backend_class=CPU, grid=(6, 6), n_sd=8):
    settings = arabas_et_al_2015.Settings(
        Formulae(seed=seed), grid=grid, size=(1500.0, 1500.0),
        n_sd_per_gridbox=n_sd, spin_up_time=0.0,
    )
    particulator, spin_up = arabas_et_al_2015.make_simulation(
        settings, backend_class=backend_class
    )
    return particulator, spin_up


def assert_same_state(p1, p2):
    """every leaf of the sim-state, the host scalars, ``n_steps`` and both
    generator states equal (``chip_smoke.state_differences``)"""
    assert chip_smoke.state_differences(p1, p2) == []


def resume_round_trip(build, path, first, then, save, restore, before=None):
    """run A: ``first`` steps, the checkpoint, ``then`` more; run B, built
    the same way: the restore and ``then`` steps; returns (A, B)"""
    p1 = build()
    if before:
        before(p1)
    p1.run(first)
    save(p1, path)
    p1.run(then)
    p2 = build()
    restore(p2, path)
    assert p2.n_steps == first
    p2.run(then)
    return p1, p2


class TestCheckpoint:
    @staticmethod
    def test_npz_roundtrip_resumes_identically(tmp_path):
        p1 = build_box()
        p1.run(10)
        p1.block_until_ready()
        path = tmp_path / "state.npz"
        checkpoint.save_npz(p1, path)
        p1.run(10)
        final_ref = np.asarray(p1.attributes["multiplicity"])

        p2 = build_box()
        checkpoint.restore_npz(p2, path)
        assert p2.n_steps == 10
        p2.run(10)
        final_restored = np.asarray(p2.attributes["multiplicity"])
        np.testing.assert_array_equal(final_ref, final_restored)
        np.testing.assert_array_equal(
            np.asarray(p1.attributes["water mass"]),
            np.asarray(p2.attributes["water mass"]),
        )
        assert_same_state(p1, p2)

    @staticmethod
    def test_npz_shape_mismatch_rejected(tmp_path):
        p1 = build_box(n_sd=256)
        p1.run(1)
        path = tmp_path / "state.npz"
        checkpoint.save_npz(p1, path)
        p2 = build_box(n_sd=128)
        with pytest.raises(ValueError, match="shape mismatch"):
            checkpoint.restore_npz(p2, path)

    @staticmethod
    def test_dcp_roundtrip(tmp_path):
        """the orbax case: ``save_dcp`` / ``restore_dcp`` of the parcel"""
        p1 = build_parcel()
        p1.run(5)
        p1.block_until_ready()
        directory = tmp_path / "ckpt"
        checkpoint.save_dcp(p1, directory)
        p2 = build_parcel()
        checkpoint.restore_dcp(p2, directory)
        assert p2.n_steps == 5
        np.testing.assert_array_equal(
            np.asarray(p1.attributes["water mass"]),
            np.asarray(p2.attributes["water mass"]),
        )
        np.testing.assert_allclose(
            p1.get_env("T"), p2.get_env("T"), rtol=0
        )
        assert_same_state(p1, p2)
        p1.run(3)
        p2.run(3)
        assert_same_state(p1, p2)


def test_npz_missing_leaf_raises_key_error(tmp_path):
    p1 = build_parcel()
    path = tmp_path / "state.npz"
    checkpoint.save_npz(p1, path)
    with np.load(path) as data:
        kept = {k: data[k] for k in data.files if k != "env/thd"}
    np.savez_compressed(path, **kept)
    with pytest.raises(KeyError, match="env/thd"):
        checkpoint.restore_npz(build_parcel(), path)


def test_dcp_shape_mismatch_rejected(tmp_path):
    p1 = build_box(n_sd=256)
    checkpoint.save_dcp(p1, tmp_path / "ckpt")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_dcp(build_box(n_sd=128), tmp_path / "ckpt")


def test_parcel_resume_keeps_the_host_clock(tmp_path):
    """the parcel's clock is a Python float in ``sim["host"]``: w(t) is read
    there, so a resume that lost it would ascend from t = 0"""
    p1, p2 = resume_round_trip(
        build_parcel, tmp_path / "state.npz", 7, 5,
        checkpoint.save_npz, checkpoint.restore_npz,
    )
    assert p2.sim_state["host"]["t"] == 12.0
    assert_same_state(p1, p2)


@pytest.mark.parametrize("fmt", ("npz", "dcp"))
def test_adaptive_box_resumes_through_the_host_generator(tmp_path, fmt):
    """the adaptive mirror croupier draws each substep's (K, seed) from
    ``particulator.rng``"""
    save = getattr(checkpoint, f"save_{fmt}")
    restore = getattr(checkpoint, f"restore_{fmt}")
    p1, p2 = resume_round_trip(
        lambda: build_box(n_sd=512, adaptive=True),
        tmp_path / f"state.{fmt}", 4, 6, save, restore,
    )
    assert_same_state(p1, p2)
    assert int(p2.get_counter("coalescence_rate").sum()) > 0


@pytest.mark.parametrize("fmt", ("npz", "dcp"))
def test_warm_rain_resumes_through_the_device_generator(tmp_path, fmt):
    """the 2D warm rain at 6 x 6 x 8: the sort croupier draws its shuffle
    bits and gamma rows from ``particulator.device_rng``; spin-up over
    before the checkpoint, so that coalescence and sedimentation run in
    both halves"""
    save = getattr(checkpoint, f"save_{fmt}")
    restore = getattr(checkpoint, f"restore_{fmt}")

    def build():
        p, spin_up = build_warm_rain()
        spin_up.finish()
        return p

    def restored_flags_only(p, path):
        # run B's flags come from the file: built with the spin-up on
        p.set_flag("collision_enable", False)
        restore(p, path)
        assert p.sim_state["flags"]["collision_enable"] is True

    p1, p2 = resume_round_trip(
        build, tmp_path / f"state.{fmt}", 3, 4, save, restored_flags_only,
    )
    assert_same_state(p1, p2)
    assert p2.dynamics["Collision"].route() == "k2"


def test_a_resume_without_the_generators_diverges(tmp_path):
    """the check above can fail: the same round trip with the device
    generator left as built does not reproduce run A"""
    def build():
        p, spin_up = build_warm_rain()
        spin_up.finish()
        return p

    def restore_leaves_only(p, path):
        state = p.device_rng.get_state()
        checkpoint.restore_npz(p, path)
        p.device_rng.set_state(state)

    p1, p2 = resume_round_trip(
        build, tmp_path / "state.npz", 3, 4, checkpoint.save_npz,
        restore_leaves_only,
    )
    differ = chip_smoke.state_differences(p1, p2)
    assert "particles/multiplicity" in differ


def test_from_jax_npz_carries_a_parcel_across(tmp_path):
    """the JAX package runs the deterministic float64 parcel 5 steps and
    writes it with its ``save_npz``; ``from_jax_npz`` loads it into the
    port, and both packages run 5 more steps: the env and the water masses
    agree to rtol 1e-12"""
    jax_p = build_jax_parcel()
    jax_p.run(5)
    path = tmp_path / "jax_state.npz"
    jax_checkpoint.save_npz(jax_p, path)

    port = build_parcel()
    assert port.sim_state["particles"].ext_names == (
        jax_p.sim_state["particles"].ext_names
    )
    checkpoint.from_jax_npz(port, path)
    assert port.n_steps == 5
    assert port.sim_state["host"]["t"] == 5.0
    np.testing.assert_array_equal(
        port.attributes["water mass"], np.asarray(jax_p.attributes["water mass"])
    )
    jax_p.run(5)
    port.run(5)
    for key in ("T", "p", "RH", "qv", "thd", "rhod", "z", "t"):
        np.testing.assert_allclose(
            port.get_env(key), np.asarray(jax_p.get_env(key)), rtol=1e-12,
            err_msg=key,
        )
    np.testing.assert_allclose(
        port.attributes["water mass"],
        np.asarray(jax_p.attributes["water mass"]), rtol=1e-12,
    )
    np.testing.assert_array_equal(
        port.attributes["multiplicity"],
        np.asarray(jax_p.attributes["multiplicity"]),
    )
