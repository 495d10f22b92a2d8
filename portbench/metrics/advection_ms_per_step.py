"""Device milliseconds per step of the operations launched inside the
benchmark's span around the EulerianAdvection dynamic: the advection
layer (dynamics/eulerian_advection.py, ops/mpdata.py). Moves
``sd_steps_per_s``."""

SPAN = "EulerianAdvection"


def read(trace):
    if SPAN not in trace.spans():
        return None
    return trace.span_device_s(SPAN) * 1e3 / trace.steps
