"""Housekeeping products (port of ``pysdm_tpu/products/housekeeping.py``;
reference ``PySDM/products/housekeeping/``): the super-droplet count,
timers and the simulated time.

The wall-clock timers wait for the device (``Particulator.block_until_ready``,
``torch.cuda.synchronize`` on the card) before they read the clock, so that
they time the work and not the host's queueing of it; ``CPUTime`` reads the
process's CPU clock."""

import time

import numpy as np
import torch

from .impl import Product


class SuperDropletCountPerGridbox(Product):
    """live super-droplets per cell, an integer count (a sum of integers
    is exact in any order, so no float atomics are involved)"""

    def __init__(self, name=None):
        super().__init__(name=name or "super droplet count per gridbox")

    def _impl(self, **kwargs):
        p = self.particulator
        particles = p.particles
        counts = torch.zeros(
            p.mesh.n_cell, dtype=torch.int64, device=particles.cell_id.device
        ).index_add_(0, particles.cell_id.long(), particles.alive.long())
        return counts.cpu().numpy()


class _Timer(Product):
    """seconds of a clock since the last ``reset`` (at registration, and by
    the caller); the device is waited for before the clock is read"""

    clock = staticmethod(time.perf_counter)

    def __init__(self, name):
        super().__init__(name=name, unit="s")
        self._start = self.clock()

    def register(self, builder):
        super().register(builder)
        self.reset()

    def reset(self):
        self._start = self.clock()

    def get(self, **kwargs):
        self.particulator.block_until_ready()
        return float(self.clock() - self._start)


class WallTime(_Timer):
    """wall-clock seconds since the last reset (reference
    ``housekeeping/timers.py``)"""

    def __init__(self, name=None):
        super().__init__(name=name or "wall time")


class CPUTime(_Timer):
    """seconds of the process's CPU time since the last reset"""

    clock = staticmethod(time.process_time)

    def __init__(self, name=None):
        super().__init__(name=name or "CPU time")


class Time(Product):
    """the simulated time, steps times dt"""

    def __init__(self, name=None):
        super().__init__(name=name or "time")

    def get(self, **kwargs):
        return self.particulator.n_steps * self.particulator.dt


class DynamicWallTime(Product):
    """wall time spent in one dynamic since the last read, which resets it
    (reference ``dynamic_wall_time.py``). Needs the per-dynamic timing of
    ``Particulator.enable_per_dynamic_timing``, which waits for the device
    after each dynamic; without it the value is NaN rather than a made-up
    number, as in the JAX package."""

    def __init__(self, dynamic, name=None, unit="s"):
        super().__init__(name=name or f"{dynamic} wall time", unit=unit)
        self.dynamic = dynamic

    def register(self, builder):
        super().register(builder)
        self.shape = ()

    def _impl(self, **kwargs):
        timers = self.particulator.timers
        value = timers.get(self.dynamic, np.nan)
        if self.dynamic in timers:
            timers[self.dynamic] = 0.0
        return np.asarray(value)

    def shape_for_output(self, result):
        return ()
