"""The program's own counts over the traced episode.

While a ``torch.profiler`` records, ``pysdm_tpu_torch.utils.profiling``
adds the deltas of the program's counters over each ``Particulator.run``
call, and the call's steps, to its recorded totals; its kernels add what
they count on the device, and its set-up phases their host seconds
(``totals``). The traced episode is the only stretch of a run that a
profiler records, so the totals hold that episode's counts.

A program without these totals (``profiling.totals`` missing), or totals
that cover other steps than the trace's, give None: the reader's metric
is left out of the result line.
"""


def recorded(trace):
    """the program's recorded totals, a flat dict, where they cover the
    trace's steps; else None"""
    try:
        from pysdm_tpu_torch.utils import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    counts = totals()
    if counts.get("steps") != trace.steps:
        return None
    return counts


def ratio(trace, numerator, denominator, scale=1.0):
    """``scale`` x the recorded ``numerator`` over the recorded
    ``denominator`` (a count, or ``"steps"``); None where the totals, or
    the numerator, are missing, or the denominator is 0"""
    counts = recorded(trace)
    if counts is None or numerator not in counts or not counts.get(denominator):
        return None
    return scale * counts[numerator] / counts[denominator]
