"""Condensation solves per step: the recorded delta of the program's
``Condensation.substep_solves`` (every per-drop solve, of the fake
substeps of the adaptation and of the real ones; one K3 launch each) over
the traced episode's steps (``harness/counts.py``). Moves
``sd_steps_per_s``."""

from portbench.harness import counts


def read(trace):
    return counts.ratio(trace, "Condensation.substep_solves", "steps")
