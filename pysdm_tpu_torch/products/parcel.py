"""Parcel-environment products (port of ``pysdm_tpu/products/parcel.py``;
reference ``PySDM/products/parcel/``)."""

import numpy as np

from .impl import MomentProduct, Product
from .size_spectral import _ActivationFiltered


class ParcelDisplacement(Product):
    """the parcel's altitude z (reference ``parcel_displacement.py``)"""

    def __init__(self, name=None, unit="m"):
        super().__init__(name=name or "parcel displacement", unit=unit)

    def register(self, builder):
        super().register(builder)
        from ..environments import Parcel

        assert isinstance(self.particulator.environment, Parcel)

    def _impl(self, **kwargs):
        return np.asarray(self.particulator.get_env("z"))


class ParcelLiquidWaterPath(MomentProduct, _ActivationFiltered):
    """the liquid water path over the parcel's ascent, the trapezoidal
    integral in z of the (un)activated water content (reference
    ``cloud_water_path.py``). It observes the particulator
    (``Particulator.observers``) and integrates after every step, as the
    JAX package does; each step then reads the water content back."""

    def __init__(self, *, count_unactivated, count_activated, name=None,
                 unit="kg/m^2"):
        super().__init__(name=name or "parcel liquid water path", unit=unit)
        self._init_activation_filter(
            count_activated=count_activated, count_unactivated=count_unactivated
        )
        self.previous = {"z": 0.0, "cwc": 0.0}
        self.cwp = 0.0

    def register(self, builder):
        super().register(builder)
        from ..environments import Parcel

        assert isinstance(self.particulator.environment, Parcel)
        self.particulator.observers.append(self)

    def notify(self):
        _, mass = self._activation_filtered_moment(
            attr="water mass", rank=1, skip_division_by_m0=True
        )
        cwc = np.asarray(mass) / self.particulator.mesh.dv
        current_z = np.asarray(self.particulator.get_env("z"))
        dz = current_z - self.previous["z"]
        cwc_mean = (cwc + self.previous["cwc"]) / 2
        if np.any(self.previous["cwc"] > 0):
            self.cwp = self.cwp + cwc_mean * dz
        self.previous["z"] = current_z
        self.previous["cwc"] = cwc

    def _impl(self, **kwargs):
        return np.asarray(self.cwp)
