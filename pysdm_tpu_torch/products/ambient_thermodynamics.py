"""Ambient-thermodynamics products (port of the two of
``pysdm_tpu/products/ambient_thermodynamics.py`` the 1D column reads;
reference ``PySDM/products/ambient_thermodynamics/``): env fields of the
state."""

from .impl import Product


class _EnvProduct(Product):
    env_key = None

    def _impl(self, **kwargs):
        return self.particulator.get_env(self.env_key)


class AmbientTemperature(_EnvProduct):
    env_key = "T"

    def __init__(self, name=None, unit="K"):
        super().__init__(name=name or "T", unit=unit)


class AmbientRelativeHumidity(_EnvProduct):
    env_key = "RH"

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "RH", unit=unit)

    def _impl(self, **kwargs):
        value = super()._impl(**kwargs)
        return value * 100 if self.unit == "%" else value
