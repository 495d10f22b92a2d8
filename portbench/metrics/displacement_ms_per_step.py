"""Device milliseconds per step of the operations launched inside the
benchmark's span around the Displacement dynamic: the displacement layer
(dynamics/displacement.py, ops/displacement.py). Moves
``sd_steps_per_s``."""

SPAN = "Displacement"


def read(trace):
    if SPAN not in trace.spans():
        return None
    return trace.span_device_s(SPAN) * 1e3 / trace.steps
