"""K4's share of its roofline: the least time of its launches, by the bytes
the program counted at its wrapper (``cumsum.bytes``: each element read
once and its prefix written once, 2 x itemsize x rows x n a launch,
``harness/counts.py``) over 3.35 TB/s, divided by the device time of the
kernels named ``scan_kernel`` (``csrc/scan.cu``) in the traced episode.
Moves ``sd_steps_per_s``."""

from portbench.harness import counts, rooflines

# K4's kernel, a template: ``(anonymous namespace)::scan_kernel<float>(...)``
PATTERN = "::scan_kernel<"


def read(trace):
    recorded = counts.recorded(trace)
    launches = trace.kernels(PATTERN)
    if recorded is None or not launches or not recorded.get("cumsum.bytes"):
        return None
    measured_s = sum(op.dur_us for op in launches) * 1e-6
    return 100.0 * rooflines.bound_s(recorded["cumsum.bytes"]) / measured_s
