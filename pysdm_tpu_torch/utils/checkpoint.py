"""Checkpoint / resume of the full prognostic simulation state (port of
``pysdm_tpu/utils/checkpoint.py``).

The reference has no checkpointing (SURVEY.md §5; its nearest equivalents
are the VTK/netCDF exporters, ``PySDM/exporters/``). The fixed-size state
serialises losslessly. What a later step depends on, all of it stored:

- every tensor of ``particulator.sim_state``: the particles by field
  (``ParticleState``'s tensors), ``env``, ``counters``, ``flags`` (Python
  bools, stored as 0-d arrays) and the injected ``u01`` rows, each keyed
  by its path ("particles/multiplicity", "env/thd", ...), as the JAX
  package keys its pytree leaves;
- ``sim_state["host"]`` (the parcel's or the column's clock, a Python
  float) and ``n_steps``, as JSON in the meta entry;
- the states of the two generators the builder seeds,
  ``particulator.rng`` (host) and ``particulator.device_rng`` (on the
  state's device), from ``Generator.get_state()``, under
  "generators/rng" and "generators/device_rng". They take the place of the
  JAX package's threefry key.

Two container formats:

- ``save_npz`` / ``restore_npz``: one compressed numpy archive, staged in
  host memory, for tests and small runs;
- ``save_dcp`` / ``restore_dcp``: a ``torch.distributed.checkpoint``
  directory, the counterpart of the JAX package's ``save_orbax`` /
  ``restore_orbax``: multi-host-aware (each rank writes its own shards
  under a process group), and usable without one in a single process.
  Like orbax, it skips zero-size leaves.

Restoring rebuilds the running particulator in place: the caller builds
the same configuration (the same Builder wiring: dynamics, products,
mesh), then calls ``restore_*``, which swaps in the stored state, step
counter and generator states. Each restored leaf keeps the dtype and
device of the leaf it replaces, so float32 state on the card comes back
as float32 on the card. A leaf of another shape raises ``ValueError``
("shape mismatch"), a missing leaf ``KeyError`` (zero-size leaves are not
stored and are kept as built).

``from_jax_npz`` carries a state across: it loads a file written by the
JAX package's ``save_npz`` into a port particulator built the same way.
"""

import dataclasses
import json
import warnings

import numpy as np
import torch

_META_KEY = "__pysdm_tpu_meta__"
_GROUPS = ("env", "counters", "flags", "u01")
_GENERATORS = ("rng", "device_rng")


def _leaves(sim_state):
    """(path, leaf) of every leaf of ``sim_state``"""
    particles = sim_state["particles"]
    for field in dataclasses.fields(particles):
        value = getattr(particles, field.name)
        if torch.is_tensor(value):
            yield f"particles/{field.name}", value
    for group in _GROUPS:
        for name, value in sim_state.get(group, {}).items():
            yield f"{group}/{name}", value


def _shape(value):
    return tuple(value.shape) if hasattr(value, "shape") else ()


def _size(value):
    return int(np.prod(_shape(value), dtype=np.int64))


def _generator_states(particulator):
    return {
        f"generators/{name}": getattr(particulator, name).get_state()
        for name in _GENERATORS
    }


def _meta(particulator, paths):
    return {
        "n_steps": int(particulator.n_steps),
        "paths": list(paths),
        "host": dict(particulator.sim_state.get("host", {})),
    }


def _stored(key, leaf, shape):
    """whether a stored leaf of ``shape`` (None: not stored) restores
    ``leaf``: False for an unstored zero-size leaf (kept as built);
    ``KeyError`` for another unstored leaf, ``ValueError`` for a shape
    mismatch"""
    if shape is None:
        if _size(leaf) == 0:
            return False
        raise KeyError(f"checkpoint is missing state leaf: {key}")
    if tuple(shape) != _shape(leaf):
        raise ValueError(
            f"checkpoint shape mismatch for {key}: "
            f"{tuple(shape)} vs {_shape(leaf)} - was the simulation "
            "built with the same configuration?"
        )
    return True


def _restored(key, leaf, saved):
    """``saved`` (an array or a tensor, None if not stored) as the leaf it
    replaces: its dtype and device, or a Python bool for a flag"""
    if not _stored(key, leaf, None if saved is None else _shape(saved)):
        return leaf
    if not torch.is_tensor(leaf):
        return type(leaf)(saved.item())
    if torch.is_tensor(saved):
        return saved.to(dtype=leaf.dtype, device=leaf.device, copy=True)
    return torch.as_tensor(np.array(saved), dtype=leaf.dtype, device=leaf.device)


def _rebuilt(sim_state, flat, keep=()):
    """a sim-state of ``sim_state``'s structure with every leaf taken from
    ``flat`` ({path: array or tensor}); leaves of the groups in ``keep``
    that ``flat`` lacks stay as they are"""
    restored = {
        key: (
            leaf if key not in flat and key.split("/")[0] in keep
            else _restored(key, leaf, flat.get(key))
        )
        for key, leaf in _leaves(sim_state)
    }
    state = dict(sim_state)
    state["particles"] = sim_state["particles"].replace(**{
        key.split("/", 1)[1]: value
        for key, value in restored.items() if key.startswith("particles/")
    })
    for group in _GROUPS:
        if group in sim_state:
            state[group] = {
                name: restored[f"{group}/{name}"] for name in sim_state[group]
            }
    return state


def _set_generators(particulator, flat):
    for name in _GENERATORS:
        key = f"generators/{name}"
        generator = getattr(particulator, name)
        saved = _restored(key, generator.get_state(), flat.get(key))
        # set_state takes the state as a CPU byte tensor, for the card's
        # generator too
        generator.set_state(saved.cpu())


def _host_arrays(particulator):
    """{path: numpy array} of the sim-state and the generators"""
    flat = {}
    for key, leaf in _leaves(particulator.sim_state):
        flat[key] = (
            leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
            else np.asarray(leaf)
        )
    for key, state in _generator_states(particulator).items():
        flat[key] = state.numpy()
    return flat


def save_npz(particulator, path):
    """write the complete prognostic state to a single .npz file"""
    flat = _host_arrays(particulator)
    meta = _meta(particulator, flat)
    np.savez_compressed(path, **flat, **{_META_KEY: json.dumps(meta)})


def _load_npz(path):
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    return flat, meta


def restore_npz(particulator, path):
    """restore state saved by ``save_npz`` into an identically built
    particulator (in place)"""
    flat, meta = _load_npz(path)
    particulator.sim_state = _rebuilt(particulator.sim_state, flat)
    particulator.sim_state["host"] = dict(meta["host"])
    _set_generators(particulator, flat)
    particulator.n_steps = meta["n_steps"]
    return particulator


def _dcp_quietly(call, *args, **kwargs):
    """``call`` with the warning that no process group is initialised
    silenced: in a single process that is the intent"""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled"
        )
        return call(*args, **kwargs)


def save_dcp(particulator, directory):
    """write the state through ``torch.distributed.checkpoint`` (the
    counterpart of the JAX package's ``save_orbax``); tensors go from where
    they lie, zero-size leaves are skipped"""
    import torch.distributed.checkpoint as dcp

    state = {}
    for key, leaf in _leaves(particulator.sim_state):
        if _size(leaf) == 0:
            continue
        state[key] = leaf if torch.is_tensor(leaf) else torch.tensor(leaf)
    state.update(_generator_states(particulator))
    meta = _meta(particulator, state)
    state[_META_KEY] = json.dumps(meta)
    _dcp_quietly(dcp.save, state, checkpoint_id=str(directory))


def restore_dcp(particulator, directory):
    """restore state saved by ``save_dcp`` (in place); each leaf is read
    into a tensor of the target leaf's dtype and device"""
    import torch.distributed.checkpoint as dcp

    stored = dcp.FileSystemReader(str(directory)).read_metadata()
    stored = stored.state_dict_metadata
    targets = {}
    for key, leaf in [
        *_leaves(particulator.sim_state),
        *_generator_states(particulator).items(),
    ]:
        if _stored(key, leaf, stored[key].size if key in stored else None):
            targets[key] = (
                torch.empty_like(leaf) if torch.is_tensor(leaf)
                else torch.tensor(leaf)
            )
    targets[_META_KEY] = ""
    _dcp_quietly(dcp.load, targets, checkpoint_id=str(directory))
    meta = json.loads(targets.pop(_META_KEY))
    particulator.sim_state = _rebuilt(particulator.sim_state, targets)
    particulator.sim_state["host"] = dict(meta["host"])
    _set_generators(particulator, targets)
    particulator.n_steps = int(meta["n_steps"])
    return particulator


def from_jax_npz(particulator, path):
    """load a file written by the JAX package's ``save_npz`` into a port
    particulator built the same way (the checkpoint counterpart of
    ``ParticleState.from_numpy``, in place).

    The leaves the two packages share map by path; each takes the port
    leaf's dtype and device. The extensive rows go in the order of the
    port's ``ext_names``, which a particulator built the same way shares
    with the JAX one. The JAX ``env/t`` also becomes ``sim["host"]["t"]``,
    where the port's environment keeps its clock. Injected u01 rows the file
    lacks stay the port's; every other port leaf missing from the file
    raises ``KeyError``. The port's generators stay as built: threefry
    keys and Philox streams cannot be converted, so a carried state's
    later draws are the port's own."""
    flat, meta = _load_npz(path)
    flat.pop("key", None)  # the threefry key
    sim_state = _rebuilt(particulator.sim_state, flat, keep=("u01",))
    init_host_state = getattr(particulator.environment, "init_host_state", None)
    if init_host_state and "env/t" in flat:
        sim_state["host"] = init_host_state({"t": flat["env/t"]})
    particulator.sim_state = sim_state
    particulator.n_steps = int(meta["n_steps"])
    return particulator
