"""netCDF exporter via scipy.io.netcdf_file (port of
``pysdm_tpu/exporters/netcdf_exporter.py``; parity: reference
``PySDM/exporters/netcdf_exporter.py``, simplified: takes captured
product time series directly instead of the examples-package Storage)."""

import numpy as np
from scipy.io import netcdf_file

from ._arrays import host_array

DIM_SUFFIX = "_bin_left_edges"


class NetCDFExporter:
    """writes product time series (dict name -> list/array of per-step
    outputs) for 0D/1D/2D simulations"""

    def __init__(self, *, filename, particulator, settings_attrs=None):
        self.filename = filename
        self.particulator = particulator
        self.settings_attrs = settings_attrs or {}

    def run(self, output: dict, times=None):
        p = self.particulator
        grid = p.mesh.grid
        n_dims = p.mesh.dimension
        axis_labels = ("X", "Z")[-max(n_dims, 1):] if n_dims <= 2 else ("X", "Y", "Z")
        with netcdf_file(self.filename, mode="w") as ncdf:
            for key, value in self.settings_attrs.items():
                setattr(ncdf, key, value)
            n_t = len(next(iter(output.values())))
            ncdf.createDimension("T", n_t)
            if n_dims > 0:
                for index, label in enumerate(axis_labels):
                    ncdf.createDimension(label, grid[index])
            var_t = ncdf.createVariable("T", "f", ("T",))
            var_t.units = "seconds"
            var_t[:] = (
                host_array(times)
                if times is not None
                else p.dt * np.arange(n_t)
            )
            if n_dims > 0:
                for index, label in enumerate(axis_labels):
                    var = ncdf.createVariable(label, "f", (label,))
                    var[:] = (p.mesh.size[index] / grid[index]) * (
                        0.5 + np.arange(grid[index])
                    )
                    var.units = "metres"
            for name, series in output.items():
                arr = host_array(series, dtype=np.float32)
                safe = name.replace(" ", "_")
                extra_dims = []
                for ax, n in enumerate(arr.shape[1:]):
                    if n_dims > 0 and ax < len(axis_labels) and n == grid[ax]:
                        extra_dims.append(axis_labels[ax])
                    else:
                        dim = f"{safe}_dim{ax}"
                        ncdf.createDimension(dim, n)
                        extra_dims.append(dim)
                var = ncdf.createVariable(safe, "f", ("T", *extra_dims))
                var[:] = arr
                product = p.products.get(name)
                var.units = product.unit if product is not None else "unknown"
