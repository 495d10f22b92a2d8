"""Particulator: simulation driver and mediator (API parity with
``pysdm_tpu/particulator.py``).

The per-step work of the registered dynamics is composed by ``Builder`` into
one Python function over the simulation-state dict; ``run(steps)`` is a
Python loop over it. PyTorch runs eagerly, so no compilation step exists.
"""

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
        self.n_steps = 0
        # {'particles', 'env', 'counters', 'flags', 'host'}
        self.sim_state = None
        # generators seeded by Builder: host-side (per-substep scalars) and
        # on the device (per-slot rows)
        self.rng = None
        self.device_rng = None
        self.u01_injection = False
        self._step_fn = None
        self._resolver = AttributeResolver(self.formulae)
        self.attributes = _AttributeView(self)

    def run(self, steps):
        """advance ``steps`` time steps"""
        for _ in range(steps):
            self.sim_state = self._step_fn(self.sim_state)
            self.n_steps += 1

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
