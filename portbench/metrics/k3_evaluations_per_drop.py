"""K3's root-search cost: its minfun evaluations over the drops that
needed a solve (active and off their equilibrium), over the launches of
the traced episode that counted (the program's device counts
``masses_new.evaluations`` and ``masses_new.need_solve``,
``harness/counts.py``; one launch in 64 counts). Each evaluation waits
for the one before: what K3's arithmetic costs per drop. Moves
``sd_steps_per_s``."""

from portbench.harness import counts


def read(trace):
    return counts.ratio(trace, "masses_new.evaluations", "masses_new.need_solve")
