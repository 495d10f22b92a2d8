"""Where the time of the PyTorch port's breakup box step goes, on a CUDA
device.

Runs ``chip_smoke.py``'s config #2 (the de Jong/Mackay 2023 breakup box,
``bench.py``'s recipe: 2^17 super-droplets, adaptive, dt = 1 s), times a few
steps after warm-up with the host clock, then the same number of steps under
``torch.profiler``, and prints per step: wall time with and without the
profiler, collision substeps and host reads, device time per kernel (from
the trace's kernel events), and the device's busy share (the union of
kernel intervals over the profiled wall time). The chrome trace goes to
``--out``.

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_breakup.py [--steps 20] [--out build/profiles]``
"""

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from trace_events import busy_us, kernel_events  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--out", default="build/profiles")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_breakup: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.backends import GPU

    os.makedirs(args.out, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu)
    steps = args.steps
    p = chip_smoke.build_breakup_box(chip_smoke.BREAKUP_N, GPU)
    dyn = p.dynamics["Collision"]
    p.run(2)
    p.block_until_ready()
    t0 = time.perf_counter()
    p.run(steps)
    p.block_until_ready()
    wall = (time.perf_counter() - t0) / steps
    substeps0, reads0 = dyn.substeps_run, dyn.host_reads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(steps)
        p.block_until_ready()
        wall_prof = (time.perf_counter() - t0) / steps
    substeps = (dyn.substeps_run - substeps0) / steps
    reads = (dyn.host_reads - reads0) / steps
    trace = os.path.join(args.out, "trace_breakup.json")
    prof.export_chrome_trace(trace)
    kernels = kernel_events(trace)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e["name"]][0] += e["dur"]
        per_name[e["name"]][1] += 1
    busy = busy_us(kernels) / steps
    print(f"== breakup box 2^17 (config #2): {steps} steps after {2 + steps},"
          f" {substeps!r} collision substeps/step, {reads!r} host reads/step;"
          f" wall {wall * 1e3!r} ms/step, profiled {wall_prof * 1e3!r} ms/step;"
          f" device busy {busy!r} us/step = {busy / (wall_prof * 1e6)!r} of the"
          f" profiled wall time; {len(kernels) / steps!r} kernels/step [{gpu}]")
    for name, (dur, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {dur / steps:9.2f} us/step {count / steps:6.1f}/step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
