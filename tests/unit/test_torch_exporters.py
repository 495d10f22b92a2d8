"""The port's exporters (``pysdm_tpu_torch/exporters/``) on the CPU:
``tests/unit/test_exporters.py`` replayed on the port, then parity with
the JAX package's writers:

- the same data dict through ``NetCDFExporter_1D`` and ``VTKExporter_1D``
  of both packages: the same bytes;
- a float64 parcel run deterministically (condensation only) in both
  packages, its products captured for 10 steps and written with each
  package's ``NetCDFExporter``, and each package's ``VTKExporter`` on its
  own particulator: equal netCDF variables (the packages' products agree
  to ~1e-12, inside a float32 rounding but for the odd last bit), and
  equal VTK text after parsing, numbers at rtol 1e-6;
- tensors (on the CPU here) given to the writers in place of arrays.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from pysdm_tpu import Builder as JaxBuilder
from pysdm_tpu import Formulae as JaxFormulae
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
import pysdm_tpu.products
from pysdm_tpu.exporters import (
    NetCDFExporter as JaxNetCDFExporter,
    NetCDFExporter_1D as JaxNetCDFExporter_1D,
    VTKExporter as JaxVTKExporter,
    VTKExporter_1D as JaxVTKExporter_1D,
)
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.initialisation import spectra as jax_spectra

import pysdm_tpu_torch
import pysdm_tpu_torch.backends
import pysdm_tpu_torch.dynamics
import pysdm_tpu_torch.environments
import pysdm_tpu_torch.products
from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.exporters import (
    NetCDFExporter,
    NetCDFExporter_1D,
    VTKExporter,
    VTKExporter_1D,
)
from pysdm_tpu_torch.initialisation.sampling import spectral_sampling
from pysdm_tpu_torch.initialisation import spectra
from pysdm_tpu_torch.products import TotalParticleConcentration
from pysdm_tpu_torch.physics import si

PARCEL_STEPS = 10
RADIUS_BINS = np.logspace(np.log10(1e-8), np.log10(1e-5), 9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- test_exporters.py replayed ---------------------------------------------
def make_sim():
    n_sd = 64
    formulae = Formulae(seed=2)
    builder = Builder(n_sd=n_sd, backend=CPU(formulae),
                      environment=Box(dt=1 * si.s, dv=1e6 * si.m**3))
    builder.add_dynamic(Coalescence(collision_kernel=Golovin(b=1500), adaptive=False))
    rng = np.random.default_rng(2)
    attributes = {
        "multiplicity": np.full(n_sd, 1e10),
        "volume": rng.uniform(0.5, 2, n_sd) * (20 * si.um) ** 3,
    }
    return builder.build(attributes, products=(TotalParticleConcentration(),))


def test_netcdf_roundtrip(tmp_path):
    p = make_sim()
    output = {"total particle concentration": []}
    times = []
    for step in range(3):
        p.run(1)
        output["total particle concentration"].append(
            p.products["total particle concentration"].get()
        )
        times.append(p.n_steps * p.dt)
    path = str(tmp_path / "out.nc")
    NetCDFExporter(filename=path, particulator=p,
                   settings_attrs={"n_sd": 64}).run(output, times=times)
    with netcdf_file(path, "r") as f:
        assert f.n_sd == 64
        data = np.asarray(f.variables["total_particle_concentration"][:])
        assert data.shape[0] == 3
        np.testing.assert_allclose(
            data.ravel(),
            np.asarray(output["total particle concentration"], dtype=np.float32).ravel(),
        )


def test_vtk_export(tmp_path):
    p = make_sim()
    p.run(1)
    exporter = VTKExporter(path=str(tmp_path))
    exporter.export_attributes(p)
    exporter.export_products(p)
    files = sorted(os.listdir(tmp_path))
    assert any(f.startswith("sd_attributes") for f in files)
    assert any(f.startswith("sd_products") for f in files)
    content = open(tmp_path / files[0], encoding="utf-8").read()
    assert content.startswith("# vtk DataFile Version 3.0")
    assert "multiplicity" in content


# --- parity with the JAX package's writers ----------------------------------
def column_data(as_tensors=False):
    """a 1D column's captured series: a scalar, a (time, height) profile,
    a (time, height, bin) spectrum and the particle rows VTKExporter_1D
    takes, 3 saves, 12 levels of which the writer keeps 10"""
    rng = np.random.default_rng(5)
    n_t, nz, n_sd = 3, 12, 40
    products = {
        "surface precipitation": rng.uniform(0, 1e-3, n_t),
        "cloud water mixing ratio": rng.uniform(0, 1e-3, (n_t, nz)),
        "dry spectrum": rng.lognormal(size=(n_t, nz, 5)),
    }
    attributes = {
        "cell origin": [rng.integers(0, nz, (1, n_sd)) for _ in range(n_t)],
        "position in cell": [rng.uniform(0, 1, (1, n_sd)) for _ in range(n_t)],
        "multiplicity": [rng.integers(1, 10**9, n_sd) for _ in range(n_t)],
        "radius": [rng.lognormal(-12, 1, n_sd) for _ in range(n_t)],
    }
    if as_tensors:
        products = {k: torch.as_tensor(v) for k, v in products.items()}
        attributes = {
            k: [torch.as_tensor(x) for x in v] for k, v in attributes.items()
        }
    return products, attributes


def write_column(tmp_path, label, netcdf_class, vtk_class, particulator, data):
    products, attributes = data
    nc = tmp_path / f"{label}.nc"
    netcdf_class(
        data=products, filename=str(nc), particulator=particulator, dz=25.0,
        nz_export=10, settings_attrs={"n_sd_per_gridbox": 40},
    ).run()
    vtk_dir = tmp_path / f"{label}_vtk"
    vtk_class(
        data=attributes, dz=25.0, save_times=[0, 60, 120],
        path=str(vtk_dir), reservoir_depth=50.0,
    ).run()
    vtk = {name: (vtk_dir / name).read_bytes() for name in sorted(os.listdir(vtk_dir))}
    return nc.read_bytes(), vtk


def make_jax_box():
    formulae = JaxFormulae(seed=2)
    builder = JaxBuilder(
        n_sd=64, backend=pysdm_tpu.backends.CPU(formulae),
        environment=pysdm_tpu.environments.Box(dt=1 * si.s, dv=1e6 * si.m**3),
    )
    rng = np.random.default_rng(2)
    attributes = {
        "multiplicity": np.full(64, 1e10),
        "volume": rng.uniform(0.5, 2, 64) * (20 * si.um) ** 3,
    }
    return builder.build(
        attributes, products=(pysdm_tpu.products.TotalParticleConcentration(),)
    )


@pytest.mark.parametrize("as_tensors", (False, True))
def test_1d_writers_give_the_jax_packages_bytes(tmp_path, as_tensors):
    jax_nc, jax_vtk = write_column(
        tmp_path, "jax", JaxNetCDFExporter_1D, JaxVTKExporter_1D,
        make_jax_box(), column_data(),
    )
    nc, vtk = write_column(
        tmp_path, "port", NetCDFExporter_1D, VTKExporter_1D, make_sim(),
        column_data(as_tensors),
    )
    assert nc == jax_nc
    assert list(vtk) == list(jax_vtk) == [
        "time000.vtk", "time060.vtk", "time120.vtk"
    ]
    for name, content in vtk.items():
        assert content == jax_vtk[name], name


def parcel_products(package):
    products = package.products
    return (
        products.AmbientTemperature(name="T"),
        products.AmbientRelativeHumidity(name="RH"),
        products.ParcelDisplacement(name="z"),
        products.PeakSupersaturation(name="S_max"),
        products.MeanRadius(name="r_mean"),
        products.ParticleVolumeVersusRadiusLogarithmSpectrum(
            radius_bins_edges=RADIUS_BINS, name="dv/dlnr"
        ),
    )


def build_parcel(package, builder_class, formulae_class, sampling, spectra_module,
                 backend):
    """the parcel of ``test_checkpoint_and_scipy_solver.py`` started near
    saturation (the drops grow within 10 steps), with products"""
    env = package.environments.Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.0226, T0=300.0, w=2.0,
    )
    builder = builder_class(
        n_sd=32, backend=backend(formulae_class(seed=44)), environment=env
    )
    builder.add_dynamic(package.dynamics.AmbientThermodynamics())
    builder.add_dynamic(package.dynamics.Condensation(adaptive=True))
    spectrum = spectra_module.Lognormal(
        norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5
    )
    r_dry, n_in_dv = sampling.ConstantMultiplicity(spectrum).sample(32)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes, products=parcel_products(package))


def export_parcel(tmp_path, label, p, netcdf_class, vtk_class):
    output = {name: [] for name in p.products}
    times = []
    for _ in range(PARCEL_STEPS):
        p.run(1)
        for name, product in p.products.items():
            output[name].append(product.get())
        times.append(p.n_steps * p.dt)
    path = tmp_path / f"{label}.nc"
    netcdf_class(filename=str(path), particulator=p).run(output, times=times)
    vtk_dir = tmp_path / f"{label}_vtk"
    vtk_dir.mkdir()
    exporter = vtk_class(path=str(vtk_dir))
    exporter.export_attributes(
        p, attributes=["multiplicity", "radius", "water mass", "dry volume"]
    )
    exporter.export_products(p)
    return path, vtk_dir


def parsed_vtk(path):
    """(the header and keyword lines, the numbers) of a legacy-VTK file"""
    words, numbers = [], []
    for line in path.read_text(encoding="utf-8").splitlines():
        try:
            numbers.extend(float(x) for x in line.split())
        except ValueError:
            words.append(line)
    return words, np.asarray(numbers)


def test_parcel_exports_match_the_jax_packages(tmp_path):
    jax_p = build_parcel(
        pysdm_tpu, JaxBuilder, JaxFormulae, jax_sampling, jax_spectra,
        pysdm_tpu.backends.CPU,
    )
    port = build_parcel(
        pysdm_tpu_torch, Builder, Formulae, spectral_sampling, spectra, CPU,
    )
    jax_nc, jax_vtk = export_parcel(
        tmp_path, "jax", jax_p, JaxNetCDFExporter, JaxVTKExporter
    )
    nc, vtk = export_parcel(tmp_path, "port", port, NetCDFExporter, VTKExporter)
    with netcdf_file(str(nc), "r", mmap=False) as got, netcdf_file(
        str(jax_nc), "r", mmap=False
    ) as want:
        assert got.dimensions == want.dimensions
        assert list(got.variables) == list(want.variables)
        assert "dv/dlnr" in got.variables
        for name, var in want.variables.items():
            assert got.variables[name].dimensions == var.dimensions, name
            assert got.variables[name].units == var.units, name
            np.testing.assert_allclose(
                got.variables[name][:], var[:], rtol=1e-6, err_msg=name
            )
        # the drops grew: the export is not of the initial state
        r_mean = np.asarray(got.variables["r_mean"][:]).ravel()
        assert r_mean[-1] > r_mean[0]
    assert sorted(os.listdir(vtk)) == sorted(os.listdir(jax_vtk)) == [
        f"sd_attributes_num{PARCEL_STEPS:04d}.vtk",
        f"sd_products_num{PARCEL_STEPS:04d}.vtk",
    ]
    for name in os.listdir(vtk):
        words, numbers = parsed_vtk(vtk / name)
        jax_words, jax_numbers = parsed_vtk(jax_vtk / name)
        assert words == jax_words, name
        np.testing.assert_allclose(numbers, jax_numbers, rtol=1e-6, err_msg=name)
