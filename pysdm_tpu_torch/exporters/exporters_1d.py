"""1D-column exporters (port of ``pysdm_tpu/exporters/exporters_1d.py``;
parity: reference ``PySDM/exporters/
netcdf_exporter_1d.py`` and ``vtk_exporter_1d.py``, decoupled from the
examples-package Settings object: they take captured per-step product /
attribute series directly)."""

import os

import numpy as np
from scipy.io import netcdf_file

from ._arrays import host_array


class NetCDFExporter_1D:
    """writes scalar and (time, height[, bin]) profile products of a 1D
    column simulation; optionally excludes the below-ground particle
    reservoir rows (reference ``netcdf_exporter_1d.py``)"""

    def __init__(self, *, data, filename, particulator, dz, nz_export=None,
                 z0=0.0, times=None, settings_attrs=None):
        self.data = data
        self.filename = filename
        self.particulator = particulator
        self.dz = dz
        self.z0 = z0
        self.nz_export = nz_export
        self.times = times
        self.settings_attrs = settings_attrs or {}

    def run(self):
        n_t = len(next(iter(self.data.values())))
        with netcdf_file(self.filename, mode="w") as ncdf:
            for key, value in self.settings_attrs.items():
                setattr(ncdf, key, value)
            first_profile = next(
                (host_array(v[0]) for v in self.data.values()
                 if host_array(v[0]).ndim >= 1 and host_array(v[0]).size > 1),
                None,
            )
            nz = self.nz_export or (
                first_profile.shape[0] if first_profile is not None else 1
            )
            ncdf.createDimension("time", n_t)
            ncdf.createDimension("height", nz)
            var_t = ncdf.createVariable("time", "f", ("time",))
            var_t[:] = (
                host_array(self.times)
                if self.times is not None
                else self.particulator.dt * np.arange(n_t)
            )
            var_t.units = "seconds"
            var_z = ncdf.createVariable("height", "f", ("height",))
            var_z[:] = self.z0 + self.dz * (0.5 + np.arange(nz))
            var_z.units = "metres"
            for name, series in self.data.items():
                arr = host_array(series, dtype=np.float32)
                safe = name.replace(" ", "_")
                if arr.ndim == 1:
                    dims = ("time",)
                elif arr.ndim == 2:
                    arr = arr[:, -nz:] if arr.shape[1] >= nz else arr
                    dims = ("time", "height")
                else:
                    bin_dim = f"{safe}_bin_index"
                    ncdf.createDimension(bin_dim, arr.shape[2])
                    arr = arr[:, -nz:, :]
                    dims = ("time", "height", bin_dim)
                var = ncdf.createVariable(safe, "f", dims)
                var[:] = arr
                product = self.particulator.products.get(name)
                var.units = product.unit if product is not None else "unknown"


class VTKExporter_1D:
    """per-time-step legacy-VTK point clouds of particle attributes along
    the column (reference ``vtk_exporter_1d.py``); ``data`` maps attribute
    name -> list of per-save arrays and must include 'cell origin' and
    'position in cell'"""

    def __init__(self, *, data, dz, save_times, path="./sd_attributes",
                 reservoir_depth=0.0, exclude_particle_reservoir=True):
        self.data = data
        self.dz = dz
        self.save_times = save_times
        self.path = path
        self.reservoir_depth = reservoir_depth
        self.exclude_particle_reservoir = exclude_particle_reservoir
        if save_times and not os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
        self.num_len = len(str(int(max(save_times)))) if save_times else 1

    def run(self):
        for time_index, time in enumerate(self.save_times):
            self._export(time_index, time)

    def _export(self, time_index, time):
        payload = {}
        for key, series in self.data.items():
            arr = host_array(series[time_index])
            payload[key] = arr.ravel() if arr.ndim == 2 else arr
        z = (
            self.dz * (payload["cell origin"] + payload["position in cell"])
            - self.reservoir_depth
        )
        if self.exclude_particle_reservoir:
            keep = z >= 0
            z = z[keep]
            payload = {k: v[keep] for k, v in payload.items()}
        n = z.size
        stamp = str(int(time)).rjust(self.num_len, "0")
        path = os.path.join(self.path, f"time{stamp}.vtk")
        with open(path, "w", encoding="utf-8") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"super-droplet attributes at t = {time}\n")
            f.write("ASCII\nDATASET POLYDATA\n")
            f.write(f"POINTS {n} float\n")
            xyz = np.zeros((n, 3))
            xyz[:, 2] = z
            np.savetxt(f, xyz, fmt="%.6e")
            f.write(f"\nPOINT_DATA {n}\n")
            for name, values in payload.items():
                safe = name.replace(" ", "_")
                f.write(f"SCALARS {safe} float 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, host_array(values, dtype=float), fmt="%.6e")
