"""K1's share of its roofline: the least time of its launches, by the bytes
of ``harness/rooflines.py`` ``k1_bytes`` (the state's slots, extensive rows
and the collision kernel's attribute rows) over 3.35 TB/s, divided by the
device time of the kernels named ``coalesce_mirror_kernel``. Moves
``sd_steps_per_s``."""

from portbench.harness import rooflines

PATTERN = "coalesce_mirror_kernel"


def read(trace):
    s = trace.shapes
    return rooflines.roofline_pct(
        trace, PATTERN,
        rooflines.k1_bytes(s["n_sd"], s["extensive_rows"], s["k1_attribute_rows"]),
    )
