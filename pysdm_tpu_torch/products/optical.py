"""Optical products (port of ``pysdm_tpu/products/optical.py``; reference
``PySDM/products/optical/``): formulas of the ``optical_albedo`` and
``optical_depth`` families evaluated on what the caller passes."""

import numpy as np

from .impl import Product


class CloudAlbedo(Product):
    """cloud albedo from optical depth (reference ``cloud_albedo.py``;
    needs an ``optical_albedo`` variant, e.g. Bohren1987)"""

    def __init__(self, *, name=None, unit="dimensionless"):
        super().__init__(name=name or "cloud albedo", unit=unit)

    def _impl(self, *, optical_depth, **kwargs):
        return self.particulator.formulae.optical_albedo.albedo(optical_depth)

    def shape_for_output(self, result):
        return np.asarray(result).shape


class CloudOpticalDepth(Product):
    """cloud optical depth from liquid water path and effective radius
    (reference ``cloud_optical_depth.py``; needs an ``optical_depth``
    variant, e.g. Stephens1978)"""

    def __init__(self, *, name=None, unit="dimensionless"):
        super().__init__(name=name or "cloud optical depth", unit=unit)

    def _impl(self, *, liquid_water_path, effective_radius, **kwargs):
        return self.particulator.formulae.optical_depth.tau(
            liquid_water_path, effective_radius
        )

    def shape_for_output(self, result):
        return np.asarray(result).shape
