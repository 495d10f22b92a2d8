"""Builder: wires environment + dynamics + attributes into a Particulator
(API parity with ``pysdm_tpu/builder.py``), then composes the per-step
function.

Randomness: the builder gives the particulator a host-side
``torch.Generator`` seeded with ``Formulae(seed=...)``. Each collision
substep draws its two scalars (K, seed) from it on the host, so the kernel
takes them by value and a non-adaptive step reads nothing back from the
device.
"""

import numpy as np
import torch

from .impl.attributes import (
    EXTENSIVE_NAMES,
    MAXIMUM_NAMES,
    canonical_ext_name,
)
from .impl.state import ParticleState
from .particulator import Particulator


class Builder:
    def __init__(self, n_sd, backend, environment=None):
        self.n_sd = n_sd
        self.particulator = Particulator(n_sd, backend)
        self.formulae = backend.formulae
        self.requested_attributes = {"multiplicity", "cell id"}
        self._counters = {}
        self._flags = {}
        self.environment = environment
        if environment is not None:
            environment.register(self)

    def add_dynamic(self, dynamic):
        # key by base class name as the reference does (builder.py:54-58)
        key = type(dynamic).__mro__[-2].__name__
        key = type(dynamic).__name__ if key == "object" else key
        self.particulator.dynamics[key] = dynamic

    def request_attribute(self, name):
        self.requested_attributes.add(name)

    def get_attribute(self, name):
        self.request_attribute(name)
        return name

    def add_counter(self, name, n_cell, dtype=None, fill=0):
        """a per-cell counter; ``dtype=None`` takes the backend's float
        dtype (as ``pysdm_tpu/builder.py:50`` does)"""
        dtype = dtype or self.particulator.dtype
        self._counters[name] = torch.full(
            (n_cell,), fill, dtype=dtype, device=self.particulator.device
        )

    def add_flag(self, name, default: bool):
        """on/off switch of a dynamic, togglable between steps"""
        self._flags[name] = bool(default)

    def build(self, attributes: dict, products=()):
        if products:
            raise NotImplementedError(
                "products are not ported yet: they come with the rest of"
                " slice 1 (ops/moments.py, products/size_spectral.py)"
            )
        particulator = self.particulator
        attributes = dict(attributes)
        if "volume" in attributes and "water mass" not in attributes:
            attributes["water mass"] = np.asarray(
                self.formulae.particle_shape_and_density.volume_to_mass(
                    np.asarray(attributes.pop("volume"))
                )
            )
        multiplicity = np.asarray(attributes.pop("multiplicity"))
        if np.issubdtype(multiplicity.dtype, np.floating):
            from .initialisation.discretise_multiplicities import (
                discretise_multiplicities,
            )

            multiplicity = discretise_multiplicities(multiplicity)
        cell_id = attributes.pop("cell id", None)
        for name in ("cell origin", "position in cell"):
            if name in attributes:
                raise NotImplementedError(
                    f"{name!r}: spatial domains come with slice 3"
                )

        for dynamic in particulator.dynamics.values():
            dynamic.register(self)

        extensive = {}
        for name, value in attributes.items():
            cname = canonical_ext_name(name)
            if cname in MAXIMUM_NAMES:
                raise NotImplementedError(
                    f"{name!r}: max-merged attributes come with slice 5"
                )
            if cname not in EXTENSIVE_NAMES:
                raise ValueError(f"unknown base attribute: {name}")
            extensive[cname] = np.asarray(value, dtype=np.float64)
        if "signed water mass" not in extensive:
            raise ValueError("water mass / volume must be initialised")
        # requested extensive attributes not user-initialised default to zero
        for name in self.requested_attributes:
            cname = canonical_ext_name(name)
            if cname in EXTENSIVE_NAMES and cname not in extensive:
                extensive[cname] = np.zeros(multiplicity.shape[0])

        ext_names = tuple(extensive)
        particulator.rng = torch.Generator(device="cpu").manual_seed(
            self.formulae.seed
        )
        particulator.sim_state = {
            "particles": ParticleState.from_numpy(
                multiplicity=multiplicity,
                extensive=np.stack([extensive[k] for k in ext_names]),
                ext_names=ext_names,
                cell_id=cell_id,
                dtype=particulator.dtype,
                mult_dtype=particulator.mult_dtype,
                device=particulator.device,
            ),
            "env": self.environment.init_env_state(
                particulator.dtype, particulator.device
            ),
            "counters": dict(self._counters),
            "flags": dict(self._flags),
            # host-side scalars of the environment (the parcel's clock)
            "host": getattr(self.environment, "init_host_state", dict)(),
        }

        # insertion order is semantically significant (reference
        # particulator.py:50-56)
        step_fns = [
            dynamic.make_step(particulator)
            for dynamic in particulator.dynamics.values()
            if hasattr(dynamic, "make_step")
        ]
        # the environment's predicted -> current commit runs last (the
        # reference's swap-on-notify observer order, particulator.py:58-61)
        if hasattr(self.environment, "make_commit_step"):
            step_fns.append(self.environment.make_commit_step(particulator))

        def full_step(sim):
            for fn in step_fns:
                sim = fn(sim)
            return sim

        particulator._step_fn = full_step
        return particulator
