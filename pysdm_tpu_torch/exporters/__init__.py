"""exporters (port of ``pysdm_tpu/exporters/``; parity: reference
PySDM/exporters/): netCDF via scipy, self-contained legacy-VTK writers.
The same inputs give the JAX package's files; tensors are copied to the
host (``.cpu().numpy()``) before they are written."""
from .netcdf_exporter import NetCDFExporter
from .vtk_exporter import VTKExporter
from .exporters_1d import NetCDFExporter_1D, VTKExporter_1D
