"""The device's idle share of the traced episode: 100 x (1 - the union of
the device operations' intervals / the traced stretch's host seconds), in a
stretch with no synchronise added. Moves ``sd_steps_per_s``."""


def read(trace):
    if not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
