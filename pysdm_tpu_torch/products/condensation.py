"""Condensation products (port of the peak-saturation and event-rate
products of ``pysdm_tpu/products/condensation.py``; reference
``PySDM/products/condensation/``).

Both peak products read the ``condensation_RH_max`` counter and zero it,
so of two such products read one after the other the second sees the
maximum since the first read, as in the JAX package."""

from .impl import Product


class PeakSupersaturation(Product):
    """max (RH - 1) since the last read (reference
    ``peak_supersaturation.py``)"""

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "S_max", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        rh_max = p.get_counter("condensation_RH_max")
        p.reset_counter("condensation_RH_max")
        out = rh_max - 1.0
        return out * 100 if self.unit == "%" else out


class PeakSaturation(Product):
    """max RH since the last read (reference ``peak_saturation.py``)"""

    def __init__(self, name=None, unit="dimensionless"):
        super().__init__(name=name or "peak saturation", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        rh_max = p.get_counter("condensation_RH_max")
        p.reset_counter("condensation_RH_max")
        return rh_max


class _EventRate(Product):
    """multiplicity-weighted event rate per mass of dry air, averaged over
    the steps since the previous read, which resets the counter (reference
    ``event_rates.py``: count / (n_steps * dt * dv * rhod))"""

    counter_name = None

    def __init__(self, name=None, unit="s^-1 kg^-1"):
        super().__init__(name=name or self.counter_name, unit=unit)
        self._steps_at_last_read = 0

    def _impl(self, **kwargs):
        p = self.particulator
        steps = max(p.n_steps - self._steps_at_last_read, 1)
        self._steps_at_last_read = p.n_steps
        count = p.get_counter(self.counter_name)
        p.reset_counter(self.counter_name)
        rhod = p.get_env("rhod")
        return count / (steps * p.dt * p.mesh.dv * rhod)


class RipeningRate(_EventRate):
    counter_name = "condensation_ripening"


class ActivatingRate(_EventRate):
    counter_name = "condensation_activating"


class DeactivatingRate(_EventRate):
    counter_name = "condensation_deactivating"
