"""Builder: wires environment + dynamics + attributes into a Particulator
(API parity with ``pysdm_tpu/builder.py``), then composes the per-step
function.

Randomness: the builder gives the particulator two ``torch.Generator``s
seeded with ``Formulae(seed=...)``: ``rng`` on the host, from which each
mirror-croupier substep draws its two scalars (K, seed), so the kernel
takes them by value; and ``device_rng`` on the state's device, from which
the sort croupier draws its per-slot shuffle bits and gamma u01 rows, so
nothing is drawn on the host and copied over. A non-adaptive step reads
nothing back from the device.

Shared sort: Collision's sort croupier leaves the state cell-sorted,
Displacement breaks that, Condensation needs it. The builder runs the JAX
package's fixpoint over the dynamics' order (``pysdm_tpu/builder.py``
``:204-265``): where the state provably enters Condensation sorted (the
warm-rain order Condensation -> Advection -> Displacement -> Collision ends
sorted, which is what the next step's Condensation needs), Condensation
skips its own sort, the initial state is sorted once at build, and a
spin-up-disabled Collision still sorts. One full-state sort per step.

Deferred commits: a dynamic may split its communication into a start
inside its step and a commit (``make_commit_step``) that runs after the
last physics dynamic and before the environment's commit, as the
decomposed Displacement's particle migration does
(``pysdm_tpu/builder.py:216-240``). A commit scatters arrivals into grave
slots, so the state ends a step unsorted wherever one exists.
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
        self._u01_purposes = []
        self._extra_env = {}
        self.u01_injection = False
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

    def enable_u01_injection(self):
        """parity mode (as ``pysdm_tpu/builder.py:53-73``): the dynamics
        draw their u01 streams from ``sim_state["u01"][purpose]``, which the
        host replaces between steps with ``Particulator.inject_u01``,
        instead of from the generators"""
        self.u01_injection = True
        self.particulator.u01_injection = True

    def add_u01_purpose(self, name):
        """called by dynamics in ``register`` to reserve an injected stream"""
        if name not in self._u01_purposes:
            self._u01_purposes.append(name)

    def add_flag(self, name, default: bool):
        """on/off switch of a dynamic, togglable between steps"""
        self._flags[name] = bool(default)

    def add_env_field(self, name, value):
        """a dynamic-owned env-state row (``pysdm_tpu/builder.py:81-83``),
        e.g. the trace-gas mixing ratios ``chem_<compound>``: host values
        now, at build a tensor in the env's dtype (the backend's float
        dtype) on the particulator's device, as every env row"""
        self._extra_env[name] = np.asarray(value, dtype=np.float64)

    def build(self, attributes: dict, products=()):
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
        # with AqueousChemistry the dry volume follows the S(VI) amount
        # (``pysdm_tpu/builder.py:109-123``; reference
        # ``attributes/physics/dry_volume.py`` DryVolumeDynamic)
        chemistry = particulator.dynamics.get("AqueousChemistry")
        if (
            "dry volume" not in attributes
            and "moles_S_VI" in attributes
            and chemistry is not None
            and chemistry.dry_rho is not None
        ):
            attributes["dry volume"] = (
                np.asarray(attributes["moles_S_VI"])
                * chemistry.dry_molar_mass
                / chemistry.dry_rho
            )
        cell_id = attributes.pop("cell id", None)
        cell_origin = attributes.pop("cell origin", None)
        position_in_cell = attributes.pop("position in cell", None)

        for dynamic in particulator.dynamics.values():
            dynamic.register(self)
        # products register before the state is assembled, so that the
        # attributes they request get rows (``pysdm_tpu/builder.py:133-141``)
        for product in products:
            product.register(self)
            if product.name in particulator.products:
                raise ValueError(f"duplicate product name: {product.name}")
            particulator.products[product.name] = product

        extensive, maximum = {}, {}
        for name, value in attributes.items():
            cname = canonical_ext_name(name)
            if cname in EXTENSIVE_NAMES:
                extensive[cname] = np.asarray(value, dtype=np.float64)
            elif cname in MAXIMUM_NAMES:
                maximum[cname] = np.asarray(value, dtype=np.float64)
            else:
                raise ValueError(f"unknown base attribute: {name}")
        if "signed water mass" not in extensive:
            raise ValueError("water mass / volume must be initialised")
        # requested extensive attributes not user-initialised default to zero
        for name in self.requested_attributes:
            cname = canonical_ext_name(name)
            if cname in EXTENSIVE_NAMES and cname not in extensive:
                extensive[cname] = np.zeros(multiplicity.shape[0])
        # the max-merged records the dynamics and products ask for start at
        # NaN, "not recorded yet" (``pysdm_tpu/builder.py:163-176``)
        if "cooling rate" in self.requested_attributes:
            self.requested_attributes.add("cooling rate prev T")
        for name in self.requested_attributes:
            if name in MAXIMUM_NAMES and name not in maximum:
                if name == "freezing temperature":
                    raise ValueError(
                        "freezing temperature must be initialised"
                        " (spectro-glacial sampling)"
                    )
                maximum[name] = np.full(multiplicity.shape[0], np.nan)
        particulator._resolver.dt = particulator.dt

        ext_names = tuple(extensive)
        env = self.environment.init_env_state(
            particulator.dtype, particulator.device
        )
        for name, value in self._extra_env.items():
            env[name] = torch.as_tensor(
                value, dtype=particulator.dtype, device=particulator.device
            )
        particulator.rng = torch.Generator(device="cpu").manual_seed(
            self.formulae.seed
        )
        particulator.device_rng = torch.Generator(
            device=particulator.device
        ).manual_seed(self.formulae.seed)
        particulator.sim_state = {
            "particles": ParticleState.from_numpy(
                multiplicity=multiplicity,
                extensive=np.stack([extensive[k] for k in ext_names]),
                ext_names=ext_names,
                maximum=(
                    np.stack(list(maximum.values())) if maximum else None
                ),
                max_names=tuple(maximum),
                cell_id=cell_id,
                cell_origin=cell_origin,
                position_in_cell=position_in_cell,
                dtype=particulator.dtype,
                mult_dtype=particulator.mult_dtype,
                device=particulator.device,
            ),
            "env": env,
            "counters": dict(self._counters),
            "flags": dict(self._flags),
            # host-side scalars of the environment (the parcel's clock)
            "host": getattr(self.environment, "init_host_state", dict)(),
        }
        if self.u01_injection:
            particulator.sim_state["u01"] = {
                name: torch.zeros(
                    multiplicity.shape[0], dtype=particulator.dtype,
                    device=particulator.device,
                )
                for name in self._u01_purposes
            }
        commit_fns = [
            (name + "Commit", fn)
            for name, dynamic in particulator.dynamics.items()
            if hasattr(dynamic, "make_commit_step")
            for fn in [dynamic.make_commit_step(particulator)]
            if fn is not None
        ]
        self._share_sort(commits=bool(commit_fns))

        # insertion order is semantically significant (reference
        # particulator.py:50-56)
        named_step_fns = [
            (name, dynamic.make_step(particulator))
            for name, dynamic in particulator.dynamics.items()
            if hasattr(dynamic, "make_step")
        ]
        named_step_fns.extend(commit_fns)
        # the environment's predicted -> current commit runs last (the
        # reference's swap-on-notify observer order, particulator.py:58-61)
        if hasattr(self.environment, "make_commit_step"):
            named_step_fns.append(
                ("EnvCommit", self.environment.make_commit_step(particulator))
            )
        if "cooling rate" in self.requested_attributes:
            # each drop's cell T after the step, which the next step's
            # "cooling rate" compares with (the reference's CoolingRate
            # observer, ``attributes/ice/cooling_rate.py:23-29``)
            def record_prev_T(sim):
                particles = sim["particles"]
                particles = particles.set_max(
                    "cooling rate prev T",
                    sim["env"]["T"][particles.cell_id.long()],
                )
                return {**sim, "particles": particles}

            named_step_fns.append(("CoolingRatePrevT", record_prev_T))
        particulator._named_step_fns = tuple(named_step_fns)
        particulator._compose()
        return particulator

    def _share_sort(self, commits=False):
        """the shared-sort fixpoint (module docstring); sets each
        consumer's ``_assume_sorted`` and each sorter's
        ``_sort_when_disabled`` and pre-sorts the initial state;
        ``commits``: a deferred commit step ends every step"""
        particulator = self.particulator
        dynamics = particulator.dynamics
        n_cell = particulator.mesh.n_cell

        def fixpoint(start):
            flags, sorted_ = {}, start
            for name, dyn in dynamics.items():
                if getattr(dyn, "wants_cell_sort", False):
                    flags[name] = sorted_
                    sorted_ = True  # it sorts if the state was not sorted
                if getattr(dyn, "restores_cell_sort", False):
                    sorted_ = True
                if getattr(dyn, "breaks_cell_sort", False):
                    sorted_ = False
            return flags, sorted_ and not commits

        flags, end_sorted = fixpoint(True)
        if not end_sorted:
            flags, _ = fixpoint(False)
        presort = False
        for name, dyn in dynamics.items():
            if getattr(dyn, "wants_cell_sort", False):
                dyn._assume_sorted = n_cell > 1 and flags[name]
                presort = presort or dyn._assume_sorted
            if getattr(dyn, "restores_cell_sort", False):
                dyn._sort_when_disabled = any(flags.values())
        if presort:
            from .ops.segments import sort_state_by_cell

            particulator.sim_state["particles"], _, _ = sort_state_by_cell(
                particulator.sim_state["particles"], n_cell, particulator.mesh
            )
