"""The port's scaffolding: it imports without JAX, its formulae equal the JAX
package's in float64, and its backends keep their dtype/device policy."""

import datetime
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
        " pysdm_tpu_torch.dynamics.condensation, pysdm_tpu_torch.impl.state,"
        " pysdm_tpu_torch.initialisation.init_fall_momenta,"
        " pysdm_tpu_torch.models.morrison_and_grabowski_2007,"
        " pysdm_tpu_torch.models.pyrcel,"
        " pysdm_tpu_torch.models.grabowski_and_pawlowska_2023,"
        " pysdm_tpu_torch.models.abdul_razzak_ghan_2000,"
        " pysdm_tpu_torch.models.rogers_1975,"
        " pysdm_tpu_torch.models.arabas_et_al_2025,"
        " pysdm_tpu_torch.models.bartman_et_al_2021,"
        " pysdm_tpu_torch.models.seeding,"
        " pysdm_tpu_torch.models.kreidenweis_et_al_2003,"
        " pysdm_tpu_torch.models.jaruga_and_pawlowska_2018,"
        " pysdm_tpu_torch.models.isotopes,"
        " pysdm_tpu_torch.models.isotope_papers,"
        " pysdm_tpu_torch.models.merlivat_and_nief_1967,"
        " pysdm_tpu_torch.models.van_hook_1968,"
        " pysdm_tpu_torch.models.gonfiantini_1986,"
        " pysdm_tpu_torch.models.jouzel_and_merlivat_1984,"
        " pysdm_tpu_torch.models.gedzelman_and_arnold_1994,"
        " pysdm_tpu_torch.models.rozanski_and_sonntag_1982,"
        " pysdm_tpu_torch.products.chemistry,"
        " pysdm_tpu_torch.parallel, pysdm_tpu_torch.parallel.multihost,"
        " pysdm_tpu_torch.parallel.verification;"
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
    """every family of the JAX package is ported: the isotope families and
    the rest of physics/ bind as in the JAX package, and no message of the
    port names "chemistry and isotopes"; a name neither package has is
    refused by both"""
    for family, variant in (
        ("isotope_meteoric_water_line", "Dansgaard1964"),
        ("isotope_equilibrium_fractionation_factors",
         "MerlivatAndNief1967+Majoube1970"),
        ("isotope_ventilation_ratio", "Brutsaert1982"),
        ("ventilation", "Froessling1938"),
        ("saturation_vapour_pressure", "AugustRocheMagnus"),
        ("particle_shape_and_density", "PorousSpheroid"),
    ):
        formulae = pysdm_tpu_torch.Formulae(**{family: variant})
        assert getattr(formulae, family).variant == variant
        pysdm_tpu.Formulae(**{family: variant})
    with pytest.raises(ValueError):
        pysdm_tpu_torch.Formulae(ventilation="NoSuchVariant")
    with pytest.raises(ValueError):
        pysdm_tpu.Formulae(ventilation="NoSuchVariant")
    with pytest.raises(ValueError):
        pysdm_tpu_torch.Formulae(no_such_family="x")
    with pytest.raises(ValueError):
        pysdm_tpu_torch.Formulae(isotope_ratio_evolution="NoSuchVariant")
    with pytest.raises(ValueError):
        pysdm_tpu.Formulae(isotope_ratio_evolution="NoSuchVariant")
    sources = (REPO / "pysdm_tpu_torch").rglob("*.py")
    assert not [
        path for path in sources
        if "chemistry and isotopes" in path.read_text()
    ]


def test_unported_options_name_their_roadmap_items(tmp_path):
    """no ROADMAP item is left unported: "multi-GPU" came last. A
    ``("shard", group)`` bc pads by ring halo exchange (on a one-rank
    group, the periodic pad), ``Displacement`` takes ``distributed_x``, and
    no source of the port names multi-GPU as to come. The SciPy ODE
    condensation solver came with "exporters and utils": ``pyrcel``'s
    ``scipy_solver`` builds the patched chain, and no source of the port
    names that item as unported; the mixed-phase 2D grid is ported, and no
    message of the port names it as unported"""
    from pysdm_tpu_torch.backends import CPU as TorchCPU
    from pysdm_tpu_torch.dynamics import Displacement
    from pysdm_tpu_torch.environments.kinematic_2d import Kinematic2D
    from pysdm_tpu_torch.initialisation import spectra
    from pysdm_tpu_torch.models import pyrcel

    from pysdm_tpu_torch.ops import mpdata

    settings = pyrcel.Settings(
        dz=10.0, n_sd_per_mode=(2, 2),
        aerosol_modes_by_kappa={
            0.54: spectra.Lognormal(norm_factor=850e6, m_mode=15e-9, s_geom=1.6),
            1.2: spectra.Lognormal(norm_factor=10e6, m_mode=850e-9, s_geom=1.2),
        },
        vertical_velocity=1.0, initial_pressure=775e2,
        initial_temperature=274.0, initial_relative_humidity=0.98,
        displacement=20.0, formulae=pysdm_tpu_torch.Formulae(seed=44),
    )
    sim = pyrcel.Simulation(settings, backend_class=TorchCPU, scipy_solver=True)
    assert sim.particulator.condensation_solver_patched.kind == "scipy_ode"
    sources = (REPO / "pysdm_tpu_torch").rglob("*.py")
    assert not [
        path for path in sources if "exporters and utils" in path.read_text()
    ]
    arr = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
    )
    try:
        group = torch.distributed.new_group([0])
        for axis in (0, 1):
            torch.testing.assert_close(
                mpdata._pad1(arr, axis, ("shard", group), depth=2),
                mpdata._pad1(arr, axis, "periodic", depth=2),
                rtol=0, atol=0,
            )
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="boundary condition"):
        mpdata._pad1(arr, 0, ("halo", 1))
    shard_x = dict(group=None, capacity=64)
    assert Displacement(distributed_x=shard_x).distributed_x == shard_x
    sources = (REPO / "pysdm_tpu_torch").rglob("*.py")
    assert not [
        path for path in sources if "with multi-GPU" in path.read_text()
    ]
    env = Kinematic2D(
        dt=1.0, grid=(2, 2), size=(100.0, 100.0),
        rhod_of=lambda zZ: np.ones_like(zZ), mixed_phase=True,
    )
    assert env.mixed_phase
    sources = (REPO / "pysdm_tpu_torch").rglob("*.py")
    assert not [
        path for path in sources
        if "mixed-phase kinematic grid comes with" in path.read_text()
    ]


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
