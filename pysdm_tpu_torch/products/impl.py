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


class MomentProduct(Product):
    """products computed from per-cell statistical moments (reference
    ``products/impl/moment_product.py``)"""

    def _download_moment(
        self,
        *,
        attr,
        rank,
        filter_range=(-np.inf, np.inf),
        filter_attr="volume",
        weighting_attribute=None,
        weighting_rank=0,
        skip_division_by_m0=False,
    ):
        m0, mk = self.particulator.moments(
            attr_name=attr,
            ranks=(rank,),
            filter_attr=filter_attr,
            filter_range=filter_range,
            weighting_attribute=weighting_attribute,
            weighting_rank=weighting_rank,
            skip_division_by_m0=skip_division_by_m0,
        )
        return m0, mk[0]
