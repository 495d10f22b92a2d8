"""Device milliseconds per step of the operations launched inside the
benchmark's span around the Collision dynamic: the collision layer
(dynamics/collisions/, ops/collisions.py, ops/pairing.py,
ops/segments.py, K1, K2, K4). Moves ``sd_steps_per_s``."""

SPAN = "Collision"


def read(trace):
    if SPAN not in trace.spans():
        return None
    return trace.span_device_s(SPAN) * 1e3 / trace.steps
