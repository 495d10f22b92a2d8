"""Collision-rate products (port of ``pysdm_tpu/products/collision.py``;
reference ``PySDM/products/collision/``): each reads and resets one counter
the collision step accumulates."""

import warnings

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
