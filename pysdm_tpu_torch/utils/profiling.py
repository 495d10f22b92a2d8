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
  ``torch.profiler.record_function`` scope named after the dynamic, so that
  each dynamic's device time is attributable in the trace, and returns the
  per-dynamic wall times as a dict (the programmatic counterpart of the
  ``DynamicWallTime`` product).
"""

import contextlib
import os

import torch


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
    """run ``n_steps`` dynamic by dynamic under named scopes, waiting for the
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
