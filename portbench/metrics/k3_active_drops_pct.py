"""K3's useful share of its sweeps: 100 x the drops K3 found active (their
cell still substepping, a multiplicity above 0, water) over the drops it
swept, over the launches of the traced episode that counted (the
program's device counts ``masses_new.active`` and ``masses_new.swept``,
``harness/counts.py``; one launch in 64 counts). The lockstep substep loop
sweeps every drop as often as the cell with most substeps needs. Moves
``sd_steps_per_s``."""

from portbench.harness import counts


def read(trace):
    return counts.ratio(trace, "masses_new.active", "masses_new.swept", 100.0)
