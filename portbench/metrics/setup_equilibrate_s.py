"""Host seconds of set-up in the program's equilibration of the initial
wet radii (``initialisation/equilibrate_wet_radii.py``, a NumPy bisection
over every drop), recorded by the program as ``setup.equilibrate``
(``harness/counts.py``). Part of set-up only the program can shorten.
Moves ``setup_s``."""

from portbench.harness import counts


def read(trace):
    recorded = counts.recorded(trace)
    if recorded is None:
        return None
    return recorded.get("setup.equilibrate")
