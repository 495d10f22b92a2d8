"""VTK exporter (port of ``pysdm_tpu/exporters/vtk_exporter.py``; parity:
reference ``PySDM/exporters/vtk_exporter.py``).
The reference uses the pyevtk package; here the writer is self-contained:
super-droplet attributes go to legacy-VTK polydata files (one per time step,
readable by ParaView), products to structured-points files."""

import os

import numpy as np

from ._arrays import host_array


class VTKExporter:
    def __init__(self, *, path=".", particles_filename="sd_attributes",
                 products_filename="sd_products", verbose=False):
        self.path = path
        self.particles_filename = particles_filename
        self.products_filename = products_filename
        self.verbose = verbose
        self.exported_times = {"particles": {}, "products": {}}

    def _file(self, kind, step):
        base = {"particles": self.particles_filename,
                "products": self.products_filename}[kind]
        return os.path.join(self.path, f"{base}_num{step:04d}.vtk")

    def export_attributes(self, particulator, attributes=None):
        """one legacy-VTK polydata file with per-particle scalars"""
        step = particulator.n_steps
        path = self._file("particles", step)
        self.exported_times["particles"][path] = step * particulator.dt
        mesh = particulator.mesh
        n_dims = mesh.dimension
        alive = host_array(particulator.attributes["multiplicity"]) > 0
        n = int(alive.sum())
        if n_dims > 0:
            origin = host_array(particulator.attributes["cell origin"])
            in_cell = host_array(particulator.attributes["position in cell"])
            pos = (origin + in_cell) * (
                np.asarray(mesh.size) / np.asarray(mesh.grid)
            ).reshape(-1, 1)
            pos = pos[:, alive]
        else:
            pos = np.zeros((1, n))
        xyz = np.zeros((3, n))
        if n_dims == 2:
            xyz[0] = pos[0]
            xyz[2] = pos[1]
        else:
            xyz[2] = pos[-1]

        attributes = attributes or ["multiplicity", "radius", "water mass"]
        with open(path, "w", encoding="utf-8") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"super-droplet attributes at t = {step * particulator.dt}\n")
            f.write("ASCII\nDATASET POLYDATA\n")
            f.write(f"POINTS {n} float\n")
            np.savetxt(f, xyz.T, fmt="%.6e")
            f.write(f"\nPOINT_DATA {n}\n")
            for name in attributes:
                data = host_array(particulator.attributes[name], dtype=float)[alive]
                safe = name.replace(" ", "_")
                f.write(f"SCALARS {safe} float 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, data, fmt="%.6e")
        if self.verbose:
            print("Exported particles to", path)

    def export_products(self, particulator):
        """one legacy-VTK structured-points file with product fields"""
        step = particulator.n_steps
        path = self._file("products", step)
        self.exported_times["products"][path] = step * particulator.dt
        mesh = particulator.mesh
        grid = mesh.grid
        n_dims = mesh.dimension
        if n_dims == 2:
            dims = (grid[0], 1, grid[1])
            spacing = (mesh.size[0] / grid[0], 1.0, mesh.size[1] / grid[1])
        elif n_dims == 1:
            dims = (1, 1, grid[-1])
            spacing = (1.0, 1.0, mesh.size[-1] / grid[-1])
        else:
            dims = (1, 1, 1)
            spacing = (1.0, 1.0, 1.0)
        n_cell = int(np.prod(dims))
        with open(path, "w", encoding="utf-8") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"products at t = {step * particulator.dt}\n")
            f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
            f.write("ORIGIN 0 0 0\n")
            f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n")
            f.write(f"POINT_DATA {n_cell}\n")
            for name, product in particulator.products.items():
                data = host_array(product.get(), dtype=float).ravel()
                if data.size != n_cell:
                    continue
                safe = name.replace(" ", "_")
                f.write(f"SCALARS {safe} float 1\nLOOKUP_TABLE default\n")
                # VTK structured points iterate x fastest; our layout is
                # x-major (cell_id = x * nz + z) -> transpose for 2D
                if n_dims == 2:
                    data = data.reshape(grid).T.ravel()
                np.savetxt(f, data, fmt="%.6e")
        if self.verbose:
            print("Exported products to", path)
