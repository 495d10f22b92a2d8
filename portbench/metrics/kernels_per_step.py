"""Device kernels and memory operations (copies, fills) per step in the
traced episode. Moves ``sd_steps_per_s``: each launch costs the host a few
microseconds and the device a gap where the host cannot keep ahead."""


def read(trace):
    if not trace.ops:
        return None
    return len(trace.ops) / trace.steps
