"""Particulator: simulation driver and mediator (API parity with
``pysdm_tpu/particulator.py``).

The per-step work of the registered dynamics is composed by ``Builder`` into
one Python function over the simulation-state dict; ``run(steps)`` is a
Python loop over it. PyTorch runs eagerly, so no compilation step exists.
"""

import numpy as np
import torch

from .impl.attributes import AttributeResolver


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
        self.n_steps = 0
        # {'particles', 'env', 'counters', 'flags', 'host'}
        self.sim_state = None
        # host-side generator of the per-substep draws, seeded by Builder
        self.rng = None
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

    def get_env(self, key):
        if key in self.sim_state["env"]:
            return self.sim_state["env"][key].cpu().numpy()
        return np.asarray(self.environment[key])

    def reset_counter(self, name):
        self.sim_state["counters"][name].zero_()

    def set_flag(self, name, value):
        if name not in self.sim_state["flags"]:
            raise KeyError(f"unknown flag: {name}")
        self.sim_state["flags"][name] = bool(value)
