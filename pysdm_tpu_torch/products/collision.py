"""Collision products (port of ``pysdm_tpu/products/collision.py``;
reference ``PySDM/products/collision/``): the rates, each of which reads
and resets one counter the collision step accumulates, and the adaptive
substep's mean and minimum length."""

import warnings

import numpy as np

from .impl import Product

#: largest integer the float32 rate sums of a substep represent exactly
F32_EXACT_MAX = float(2**24)


class _CounterProduct(Product):
    counter_name = None

    def __init__(self, name=None, unit="s^-1"):
        super().__init__(name=name or self.counter_name, unit=unit)
        self._precision_warned = False

    def _impl(self, **kwargs):
        p = self.particulator
        vals = p.get_counter(self.counter_name)
        p.reset_counter(self.counter_name)
        if not self._precision_warned:
            step_max = float(p.get_counter("rate_step_sum_max")[0])
            if step_max > F32_EXACT_MAX:
                self._precision_warned = True
                warnings.warn(
                    f"per-substep per-cell rate sums reached {step_max:.3g} >"
                    " 2^24: the float32 rate sums are no longer exact (~1e-7"
                    " relative error; the reference adds int64 atomics)"
                )
        return vals


class CollisionRatePerGridbox(_CounterProduct):
    counter_name = "collision_rate"


class CollisionRateDeficitPerGridbox(_CounterProduct):
    counter_name = "collision_rate_deficit"


class CoalescenceRatePerGridbox(_CounterProduct):
    counter_name = "coalescence_rate"


class BreakupRatePerGridbox(_CounterProduct):
    counter_name = "breakup_rate"


class BreakupRateDeficitPerGridbox(_CounterProduct):
    counter_name = "breakup_rate_deficit"


class CollisionTimestepMean(Product):
    """mean adaptive collision substep length per cell since the previous
    read (reference ``collision_timestep_mean.py``): steps * dt over the
    substeps counted, which the read resets; NaN where no substep ran"""

    def __init__(self, name=None, unit="s"):
        super().__init__(name=name or "collision timestep mean", unit=unit)
        self._steps_at_last_read = 0

    def _impl(self, **kwargs):
        p = self.particulator
        steps = max(p.n_steps - self._steps_at_last_read, 1)
        self._steps_at_last_read = p.n_steps
        n = np.asarray(p.get_counter("collision_n_substep"), dtype=float)
        p.reset_counter("collision_n_substep")
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(n > 0, steps * p.dt / n, np.nan)


class CollisionTimestepMin(Product):
    """dt over the substeps counted per cell (reference
    ``collision_timestep_min.py`` keeps the extremum between reads; as in
    the JAX package, the counter holds one count per cell)"""

    def __init__(self, name=None, unit="s"):
        super().__init__(name=name or "collision timestep min", unit=unit)

    def _impl(self, **kwargs):
        p = self.particulator
        n = np.maximum(
            np.asarray(p.get_counter("collision_n_substep"), dtype=float), 1.0
        )
        return p.dt / n
