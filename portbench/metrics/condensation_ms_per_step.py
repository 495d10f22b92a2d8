"""Device milliseconds per step of the operations launched inside the
benchmark's span around the Condensation dynamic: the condensation layer
(dynamics/condensation.py, ops/condensation.py, K3). Moves
``sd_steps_per_s``."""

SPAN = "Condensation"


def read(trace):
    if SPAN not in trace.spans():
        return None
    return trace.span_device_s(SPAN) * 1e3 / trace.steps
