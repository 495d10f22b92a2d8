"""What the profiling tools read from a ``torch.profiler`` chrome trace:
its kernel events, and the device's busy time as the union of their
intervals. Imported by ``tools/profile_torch_*.py``.

The benchmark's traced run (``python portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace 1``) reads the same from the program's own
spans and counts; these tools time one case or one kernel outside it.
"""

import json


def kernel_events(trace_path):
    """the kernel events of the chrome trace at ``trace_path``"""
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def busy_us(kernels):
    """length of the union of the kernel intervals"""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
