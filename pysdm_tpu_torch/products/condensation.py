"""Condensation products (port of ``pysdm_tpu/products/condensation.py``;
reference ``PySDM/products/condensation/``): peak saturation, the event
rates, the substep's length and the activable fraction.

Both peak products read the ``condensation_RH_max`` counter and zero it,
so of two such products read one after the other the second sees the
maximum since the first read, as in the JAX package."""

import numpy as np
import torch

from .impl import MomentProduct, Product


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


class CondensationTimestepMin(Product):
    """dt over the substeps counted per cell (reference
    ``condensation_timestep.py``)"""

    def __init__(self, name=None, unit="s"):
        super().__init__(name=name or "dt_cond_min", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        n = np.maximum(np.asarray(p.get_counter("condensation_n_substeps")), 1)
        return p.dt / n


class CondensationTimestepMax(CondensationTimestepMin):
    """dt over the substeps counted per cell: the solver keeps one count
    per cell between reads, so min and max agree, as in the JAX package
    (the reference's tracks an extremum across steps)"""

    def __init__(self, name=None, unit="s"):
        super().__init__(name=name or "dt_cond_max", unit=unit)


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


class ActivableFraction(MomentProduct):
    """the fraction of particles per cell whose critical saturation lies
    below 1 + S_max / 100 (reference ``activable_fraction.py``; the
    kappa-Koehler curve at the cell's temperature with the constant surface
    tension of water, as in the JAX package)"""

    def __init__(self, name=None, unit="dimensionless",
                 filter_attr="critical supersaturation"):
        super().__init__(name=name or "activable fraction", unit=unit)
        self.filter_attr = filter_attr

    def _impl(self, S_max=0.0, **kwargs):
        p = self.particulator
        particles = p.particles
        f = p.formulae
        cell = particles.cell_id.long()
        T = p.sim_state["env"]["T"][cell]
        rd3 = particles.ext("dry volume") / f.constants.PI_4_3
        kappa = p.get_attribute("kappa")
        r_cr = f.hygroscopicity.r_cr(kappa, rd3, T, f.constants.sgm_w)
        s_cr = f.hygroscopicity.RH_eq(r_cr, T, kappa, rd3, f.constants.sgm_w)
        mult = particles.multiplicity
        activable = torch.where(s_cr < 1.0 + S_max / 100.0, mult, 0)
        sums = torch.zeros(
            (2, p.mesh.n_cell), dtype=mult.dtype, device=mult.device
        ).index_add_(1, cell, torch.stack([activable, mult]))
        num, den = sums.cpu().numpy()
        return num / np.maximum(den, 1)
