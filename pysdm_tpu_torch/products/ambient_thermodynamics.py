"""Ambient-thermodynamics products (port of
``pysdm_tpu/products/ambient_thermodynamics.py``; reference
``PySDM/products/ambient_thermodynamics/``): the committed env fields."""

import numpy as np

from .impl import Product


class _EnvProduct(Product):
    env_key = None

    def __init__(self, name=None, unit=None, var=None):
        super().__init__(name=name or self.env_key, unit=unit or "SI")
        if var is not None:
            self.env_key = var

    def _impl(self, **kwargs):
        return self.particulator.get_env(self.env_key)


class AmbientTemperature(_EnvProduct):
    env_key = "T"

    def __init__(self, name=None, unit="K", var=None):
        super().__init__(name=name or "T", unit=unit, var=var)


class AmbientPressure(_EnvProduct):
    env_key = "p"

    def __init__(self, name=None, unit="Pa", var=None):
        super().__init__(name=name or "p", unit=unit, var=var)


class AmbientRelativeHumidity(_EnvProduct):
    env_key = "RH"

    def __init__(self, name=None, unit="dimensionless", var=None):
        super().__init__(name=name or "RH", unit=unit, var=var)

    def _impl(self, **kwargs):
        value = super()._impl(**kwargs)
        return value * 100 if self.unit == "%" else value


class AmbientRelativeHumidityWrtIce(_EnvProduct):
    """RH with respect to ice: RH * pvs_water(T) / pvs_ice(T), evaluated on
    the host in float64 whatever the state's float type (the saturation
    polynomials in float32 put RH_ice 3.3e-5 off at 220 K where the
    float32 state's own T and RH give it to 1e-8)"""

    env_key = "RH"

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "RH_ice", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        T = np.asarray(p.get_env("T"), dtype=np.float64)
        svp = p.formulae.saturation_vapour_pressure
        value = (
            np.asarray(p.get_env("RH"), dtype=np.float64)
            * np.asarray(svp.pvs_water(T)) / np.asarray(svp.pvs_ice(T))
        )
        return value * 100 if self.unit == "%" else value


class AmbientDryAirDensity(_EnvProduct):
    env_key = "rhod"

    def __init__(self, name=None, unit="kg/m^3", var=None):
        super().__init__(name=name or "rhod", unit=unit, var=var)


class AmbientDryAirPotentialTemperature(_EnvProduct):
    env_key = "thd"

    def __init__(self, name=None, unit="K", var=None):
        super().__init__(name=name or "thd", unit=unit, var=var)


class AmbientWaterVapourMixingRatio(_EnvProduct):
    env_key = "qv"

    def __init__(self, name=None, unit="kg/kg", var=None):
        super().__init__(name=name or "water_vapour_mixing_ratio", unit=unit,
                         var=var)
