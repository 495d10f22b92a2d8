"""Structured profiling helpers (port of ``pysdm_tpu/utils/profiling.py``;
SURVEY.md §5: the reference has only wall-clock timers,
``PySDM/impl/wall_timer.py``, and no profiler integration; on the card the
native tool is ``torch.profiler``, over CUPTI).

Two entry points:

- :func:`trace`: a context manager around ``torch.profiler.profile``, with
  the CUDA activity where a card is present; the trace goes to
  ``logdir`` as a Chrome/Perfetto JSON file.
- :func:`profile_run`: runs the particulator dynamic by dynamic
  (``Particulator._timed_step``, the per-dynamic timing mode), each under a
  span named after the dynamic, so that each dynamic's device time is
  attributable in the trace, and returns the per-dynamic wall times as a
  dict (the programmatic counterpart of the ``DynamicWallTime`` product).

The program's own spans and counts, active only while a ``torch.profiler``
records (:func:`recording`), so that a step nobody profiles pays one flag
check at each site:

- :func:`span`: a record-function scope (the C++ scope that
  ``torch.profiler.record_function`` enters through a Python op call:
  ~1.7 us an enter and exit while a profiler records, against ~11.8 us,
  torch 2.13's CPU build, 20,000 each; the trace files it under
  ``cpu_op``). The composed step puts each dynamic under one named after
  it, with the step number as its ``step`` argument (in the trace where
  the profiler records shapes); inside, each part of a dynamic has one
  named ``<Dynamic>.<part>``, and each read of a device value the host
  branches on one named ``<Dynamic>.read``. A span
  is stamped on the profiler's host clock, on which CUPTI places the
  device operations, and adds no synchronise.
- :func:`counters`: each CUDA kernel's wrapper registers the host counters
  it keeps (``launches``, and ``rows``, ``bytes`` or ``drops``), which
  :func:`host_counts` gives by name.
- :func:`record`: ``Particulator.run`` adds the deltas of its host counters
  (``Particulator.counts``: the dynamics' and :func:`host_counts`) over a
  recorded call, and the call's steps.
- :func:`device_counts`: int64 counts on the device into which a kernel
  adds what it counts (K3: its active drops, the drops that needed a
  solve, its minfun evaluations, the drops it swept) on the launches
  :func:`sample` picks while a profiler records; read by :func:`totals`
  alone, after the recorded stretch.
- :func:`timed`: the host seconds of a once-per-process set-up phase
  (``setup.equilibrate``), which runs before any profiler: always added.
- :func:`totals` gives all of it as one flat dict; :func:`reset` clears it.
"""

import contextlib
import os
import time

import torch

_NO_SPAN = contextlib.nullcontext()
_scope = torch._C._profiler._RecordFunctionFast
# (owner, counter names) of the wrappers' host counters
_COUNTERS = []
# recorded host-counter deltas and steps, by name
_COUNTS = {}
# host seconds of the set-up phases, by name
_SECONDS = {}
# (name, device) -> (int64 counts on the device, the names of a slot's
# first entries)
_DEVICE_COUNTS = {}
# recorded calls of :func:`sample`, by name
_SAMPLED = {}


def recording():
    """true while a ``torch.profiler`` records"""
    return torch.autograd._profiler_enabled()


def span(name, step=None):
    """a record-function scope named ``name`` (with ``step`` as its
    argument, where given) while a profiler records, else a shared no-op
    context"""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    if step is None:
        return _scope(name)
    return _scope(name, (), {"step": step})


@contextlib.contextmanager
def timed(name):
    """add the host seconds of a ``with`` block to the set-up seconds of
    ``name``, whether or not a profiler records (then also a span)"""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _SECONDS[name] = _SECONDS.get(name, 0.0) + time.perf_counter() - t0


def counters(owner, *names):
    """registers the int attributes ``names`` of ``owner`` (a kernel's
    wrapper) as host counters, given by :func:`host_counts` as
    ``<owner.__name__>.<name>``; returns ``owner``"""
    _COUNTERS.append((owner, names))
    return owner


def host_counts():
    """the registered host counters' values, by name"""
    return {
        f"{owner.__name__}.{name}": getattr(owner, name)
        for owner, names in _COUNTERS for name in names
    }


def record(deltas, steps):
    """add a recorded stretch's counter deltas and its steps"""
    for name, delta in deltas.items():
        _COUNTS[name] = _COUNTS.get(name, 0) + delta
    _COUNTS["steps"] = _COUNTS.get("steps", 0) + steps


def sample(name, every):
    """while a profiler records, true at the first of every ``every`` calls
    with ``name`` (counted while recording, since :func:`reset`); false
    while nothing records"""
    if not torch.autograd._profiler_enabled():
        return False
    calls = _SAMPLED.get(name, 0)
    _SAMPLED[name] = calls + 1
    return calls % every == 0


def device_counts(name, keys, device, slots, width):
    """the int64 counts of ``name`` on ``device``: ``slots`` slots of
    ``width`` entries, entry k of every slot counting ``keys[k]``, so that
    a kernel can spread its atomic adds over the slots; zeroed when first
    asked for. A kernel's launch asks for them
    every time, so that the first launch (in set-up) allocates them and no
    fill falls inside a recorded stretch"""
    key = (name, device)
    if key not in _DEVICE_COUNTS:
        counts = torch.zeros((slots, width), dtype=torch.int64, device=device)
        _DEVICE_COUNTS[key] = (counts, tuple(keys))
    return _DEVICE_COUNTS[key][0]


def totals():
    """what was recorded so far, as one flat dict: ``steps``, the host
    counters' deltas (``<dynamic>.<counter>``, ``<wrapper>.<counter>``),
    the device counts of each kernel whose launches :func:`sample` saw
    (``<kernel>.<count>``, read from the device here) and the set-up
    seconds"""
    out = dict(_COUNTS)
    for (name, _), (counts, keys) in _DEVICE_COUNTS.items():
        if not _SAMPLED.get(name):  # no launch of it was recorded
            continue
        for key, value in zip(keys, counts.sum(0).tolist()):
            out[f"{name}.{key}"] = out.get(f"{name}.{key}", 0) + value
    out.update(_SECONDS)
    return out


def reset():
    """forget every count and set-up second recorded so far"""
    _COUNTS.clear()
    _SECONDS.clear()
    _SAMPLED.clear()
    for counts, _ in _DEVICE_COUNTS.values():
        counts.zero_()


@contextlib.contextmanager
def trace(logdir):
    """profile a ``with`` block into ``logdir``
    (``trace_<pid>.json``, for Perfetto or chrome://tracing); yields the
    ``torch.profiler.profile`` object"""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(str(logdir), f"trace_{os.getpid()}.json")
    )


def profile_run(particulator, n_steps, logdir=None):
    """run ``n_steps`` dynamic by dynamic under named spans, waiting for the
    device after each; returns {dynamic name: total wall seconds}. When
    ``logdir`` is given the run is captured as a ``torch.profiler`` trace
    there. Observers are not notified, as in the JAX package."""
    ctx = trace(logdir) if logdir is not None else contextlib.nullcontext()
    times = {name: 0.0 for name, _ in particulator._named_step_fns}
    with ctx:
        for _ in range(n_steps):
            particulator._timed_step(times)
            particulator.n_steps += 1
    return times
