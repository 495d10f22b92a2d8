"""K3's share of its roofline: the least time of its launches, by the bytes
of ``harness/rooflines.py`` ``k3_bytes`` (29 B a drop) over 3.35 TB/s,
divided by the device time of the kernels named ``masses_new_kernel``.
Moves ``sd_steps_per_s``."""

from portbench.harness import rooflines

PATTERN = "masses_new_kernel"


def read(trace):
    return rooflines.roofline_pct(
        trace, PATTERN, rooflines.k3_bytes(trace.shapes["n_sd"])
    )
