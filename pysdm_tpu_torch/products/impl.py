"""Product base class (port of ``pysdm_tpu/products/impl.py``; reference
``PySDM/products/impl/``). Products are pull-based: ``get()`` computes
from the state on the device and returns a NumPy array."""

import numpy as np


class Product:
    def __init__(self, name=None, unit="dimensionless"):
        self.name = name or type(self).__name__
        self.unit = unit
        self.particulator = None
        self.shape = None

    def register(self, builder):
        self.particulator = builder.particulator
        self.shape = self.particulator.mesh.grid

    def get(self, **kwargs):
        result = np.asarray(self._impl(**kwargs))
        return result.reshape(self.shape_for_output(result))

    def shape_for_output(self, result):
        return result.shape

    def _impl(self, **kwargs):
        raise NotImplementedError()
