"""Particulator: simulation driver and mediator (API parity with
``pysdm_tpu/particulator.py``).

The per-step work of the registered dynamics is composed by ``Builder`` into
one Python function over the simulation-state dict; ``run(steps)`` is a
Python loop over it. PyTorch runs eagerly, so no compilation step exists.
Observers (``observers``, each with ``notify()``) are called after every
step. ``enable_per_dynamic_timing`` runs the dynamics one by one and waits
for the device after each, so that ``timers`` (read by
``DynamicWallTime``) hold each dynamic's wall time; without it a step waits
for nothing.
"""

import time

import numpy as np
import torch

from .impl.attributes import AttributeResolver
from .ops import moments as moments_ops


class _AttributeView:
    """dict-like read access to (possibly derived) attributes as numpy arrays"""

    def __init__(self, particulator):
        self._p = particulator

    def __getitem__(self, name):
        return self._p.get_attribute(name).cpu().numpy()

    def __contains__(self, name):
        try:
            self._p.get_attribute(name)
        except KeyError:
            return False
        return True


class Particulator:
    def __init__(self, n_sd, backend):
        self.n_sd = n_sd
        self.backend = backend
        self.formulae = backend.formulae
        self.dtype = backend.dtype
        self.mult_dtype = backend.mult_dtype
        self.device = backend.device
        self.environment = None
        self.mesh = None
        self.dt = None
        self.dynamics = {}
        self.products = {}
        self.observers = []
        self.timers = {}
        self.per_dynamic_timing = False
        self.n_steps = 0
        # {'particles', 'env', 'counters', 'flags', 'host'}
        self.sim_state = None
        # generators seeded by Builder: host-side (per-substep scalars) and
        # on the device (per-slot rows)
        self.rng = None
        self.device_rng = None
        self.u01_injection = False
        self._step_fn = None
        # (name, step function) of each dynamic and of the environment's
        # commit, in the order of the composed step
        self._named_step_fns = ()
        self._resolver = AttributeResolver(self.formulae)
        self.attributes = _AttributeView(self)

    def run(self, steps):
        """advance ``steps`` time steps, the observers notified after each;
        ``timers["total"]`` adds the host's time of the call"""
        t0 = time.perf_counter()
        for _ in range(steps):
            if self.per_dynamic_timing:
                self._timed_step()
            else:
                self.sim_state = self._step_fn(self.sim_state)
            self.n_steps += 1
            for observer in self.observers:
                observer.notify()
        self.timers["total"] = self.timers.get("total", 0.0) + (
            time.perf_counter() - t0
        )

    def _timed_step(self):
        """one step, dynamic by dynamic, each timed up to the end of its
        device work"""
        sim = self.sim_state
        for name, fn in self._named_step_fns:
            t0 = time.perf_counter()
            sim = fn(sim)
            self.block_until_ready()
            self.timers[name] = self.timers.get(name, 0.0) + (
                time.perf_counter() - t0
            )
        self.sim_state = sim

    def enable_per_dynamic_timing(self, enable=True):
        """time each dynamic of a step apart (``timers``, ``DynamicWallTime``),
        waiting for the device after each: a profiling mode, as in the JAX
        package (reference ``impl/wall_timer.py``)"""
        self.per_dynamic_timing = enable

    def block_until_ready(self):
        """wait until the device has finished the queued steps"""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def particles(self):
        return self.sim_state["particles"]

    def get_attribute(self, name):
        return self._resolver.get(
            self.sim_state["particles"], name, env=self.sim_state["env"]
        )

    def get_counter(self, name):
        return self.sim_state["counters"][name].cpu().numpy()

    def inject_u01(self, streams: dict):
        """parity mode: replace the injected u01 rows (one per purpose, shape
        (n_sd,)) that the NEXT step consumes; needs a simulation built after
        ``Builder.enable_u01_injection``"""
        if not self.u01_injection:
            raise RuntimeError(
                "u01 injection not enabled (Builder.enable_u01_injection)"
            )
        for name, values in streams.items():
            if name not in self.sim_state["u01"]:
                raise KeyError(f"unknown u01 purpose: {name}")
            self.sim_state["u01"][name] = torch.as_tensor(
                values, dtype=self.dtype, device=self.device
            )

    def get_env(self, key):
        if key in self.sim_state["env"]:
            return self.sim_state["env"][key].cpu().numpy()
        return np.asarray(self.environment[key])

    def reset_counter(self, name):
        # a new tensor: on the CPU, arrays get_counter returned share the
        # old one's memory
        counters = self.sim_state["counters"]
        counters[name] = torch.zeros_like(counters[name])

    def set_flag(self, name, value):
        if name not in self.sim_state["flags"]:
            raise KeyError(f"unknown flag: {name}")
        self.sim_state["flags"][name] = bool(value)

    # -- reductions for products ----------------------------------------
    def moments(
        self,
        *,
        attr_name,
        ranks,
        filter_attr="volume",
        filter_range=(-np.inf, np.inf),
        weighting_attribute=None,
        weighting_rank=0,
        skip_division_by_m0=False,
    ):
        """per-cell moments (numpy): moment 0 (n_cell,) and the moments of
        ``ranks`` (n_ranks, n_cell) of the particles whose ``filter_attr``
        lies in [filter_range[0], filter_range[1])"""
        weight = (
            self.get_attribute(weighting_attribute)
            if weighting_attribute
            else None
        )
        m0, mk = moments_ops.moments(
            multiplicity=self.particles.multiplicity,
            attr_data=self.get_attribute(attr_name),
            cell_id=self.particles.cell_id,
            ranks=tuple(ranks),
            filter_attr_data=self.get_attribute(filter_attr),
            min_x=filter_range[0],
            max_x=filter_range[1],
            n_cell=self.mesh.n_cell,
            weighting_attribute=weight,
            weighting_rank=weighting_rank,
            skip_division_by_m0=skip_division_by_m0,
        )
        return m0.cpu().numpy(), mk.cpu().numpy()

    def spectrum_moments(
        self,
        *,
        attr_name,
        rank,
        attr_bins,
        filter_attr=None,
        weighting_attribute=None,
        weighting_rank=0,
    ):
        """per-(bin, cell) moments (numpy), each (n_bins, n_cell)"""
        attr = self.get_attribute(attr_name)
        weight = (
            self.get_attribute(weighting_attribute)
            if weighting_attribute
            else None
        )
        m0, mk = moments_ops.spectrum_moments(
            multiplicity=self.particles.multiplicity,
            attr_data=attr,
            x_attr=self.get_attribute(filter_attr) if filter_attr else attr,
            cell_id=self.particles.cell_id,
            x_bins=torch.as_tensor(attr_bins, dtype=self.dtype, device=self.device),
            rank=rank,
            n_cell=self.mesh.n_cell,
            weighting_attribute=weight,
            weighting_rank=weighting_rank,
        )
        return m0.cpu().numpy(), mk.cpu().numpy()
