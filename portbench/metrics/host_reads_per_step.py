"""Values the program read back from the device to branch on, per step:
the deltas of its ``host_reads`` counters (Collision, Displacement and the
condensation solver) over the traced episode. Each read drains the queue.
Moves ``sd_steps_per_s``."""


def read(trace):
    return trace.host_reads / trace.steps
