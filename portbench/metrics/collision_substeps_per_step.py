"""Collision substeps per step: the recorded delta of the program's
``Collision.substeps_run`` (one K2 launch each on the sort croupier) over
the traced episode's steps (``harness/counts.py``). The adaptive substep
count decides how often the sort, the pairs and K2 run. Moves
``sd_steps_per_s``."""

from portbench.harness import counts


def read(trace):
    return counts.ratio(trace, "Collision.substeps_run", "steps")
