"""The port's scaffolding: it imports without JAX, its formulae equal the JAX
package's in float64, and its backends keep their dtype/device policy."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU, GPU

REPO = Path(__file__).resolve().parents[2]


def test_import_leaves_jax_out():
    code = (
        "import sys, pysdm_tpu_torch, pysdm_tpu_torch.dynamics,"
        " pysdm_tpu_torch.environments, pysdm_tpu_torch.initialisation"
        ".sampling.spectral_sampling, pysdm_tpu_torch.ops.cuda.collision,"
        " pysdm_tpu_torch.ops.cuda.condensation, pysdm_tpu_torch.ops"
        ".condensation, pysdm_tpu_torch.environments.parcel,"
        " pysdm_tpu_torch.dynamics.condensation, pysdm_tpu_torch.impl.state;"
        " bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'pysdm_tpu')]; print(bad); assert not bad"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


R = np.array([1e-7, 3.2e-6, 5e-5, 1.1e-3])
FORMULAE = (
    ("trivia", "volume", (R,)),
    ("trivia", "radius", (4.0 / 3.0 * np.pi * R**3,)),
    ("trivia", "area", (R,)),
    ("trivia", "sphere_surface", (2 * R,)),
    ("trivia", "explicit_euler", (R, 0.5, R * 3)),
    ("trivia", "K2C", (R + 280.0,)),
    ("trivia", "C2K", (R - 5.0,)),
    ("trivia", "volume_of_density_mass", (1000.0, R)),
    ("particle_shape_and_density", "mass_to_volume", (R,)),
    ("particle_shape_and_density", "volume_to_mass", (R,)),
    ("particle_shape_and_density", "radius_to_mass", (R,)),
    ("particle_shape_and_density", "mass_to_radius", (R,)),
    ("particle_shape_and_density", "reynolds_number", (R, R * 1e3, 1.8e-5, 1.2)),
    ("particle_shape_and_density", "dm_dt", (R, R * 1e-3)),
    ("particle_shape_and_density", "dm_dt_over_m", (R, R * 1e-3)),
    ("particle_shape_and_density", "r_dr_dt", (R, R * 1e-3)),
)


@pytest.mark.parametrize(
    "family, name, args", FORMULAE, ids=[f"{f}.{n}" for f, n, _ in FORMULAE]
)
def test_formula_matches_jax_package(family, name, args):
    expected = getattr(getattr(pysdm_tpu.Formulae(), family), name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    got = getattr(getattr(pysdm_tpu_torch.Formulae(), family), name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-15)


def test_unported_formula_family_names_its_slice():
    with pytest.raises(NotImplementedError, match="ice, chemistry and isotopes"):
        pysdm_tpu_torch.Formulae(latent_heat_sublimation="MurphyKoop2005")
    with pytest.raises(NotImplementedError, match="the rest of physics/"):
        pysdm_tpu_torch.Formulae(ventilation="Froessling1938")
    with pytest.raises(NotImplementedError, match="the rest of physics/"):
        pysdm_tpu_torch.Formulae(saturation_vapour_pressure="AugustRocheMagnus")
    with pytest.raises(NotImplementedError, match="ice, chemistry and isotopes"):
        pysdm_tpu_torch.Formulae(particle_shape_and_density="MixedPhaseSpheres")
    with pytest.raises(ValueError):
        pysdm_tpu_torch.Formulae(no_such_family="x")


def test_cpu_backend_policy():
    backend = CPU(pysdm_tpu_torch.Formulae(seed=1))
    assert backend.dtype == torch.float64
    assert backend.mult_dtype == torch.int64
    assert backend.device.type == "cpu"
    assert backend.formulae.seed == 1


def test_gpu_backend_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPU()
