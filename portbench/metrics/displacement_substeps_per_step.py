"""Displacement substeps per step: the recorded delta of the program's
``Displacement.substeps_run`` (the adaptive count, a power of two, read
once a step) over the traced episode's steps (``harness/counts.py``).
Moves ``sd_steps_per_s``."""

from portbench.harness import counts


def read(trace):
    return counts.ratio(trace, "Displacement.substeps_run", "steps")
