"""K2's share of its roofline: the least time of its launches, by the bytes
of ``harness/rooflines.py`` ``k2_bytes`` (the state's slots and extensive
rows) over 3.35 TB/s, divided by the device time of the kernels named
``coalesce_adjacent_kernel``. Moves ``sd_steps_per_s``."""

from portbench.harness import rooflines

PATTERN = "coalesce_adjacent_kernel"


def read(trace):
    s = trace.shapes
    return rooflines.roofline_pct(
        trace, PATTERN, rooflines.k2_bytes(s["n_sd"], s["extensive_rows"])
    )
