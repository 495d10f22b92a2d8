"""Where the time of the PyTorch port's parcel step goes, on a CUDA device.

Runs ``chip_smoke.py``'s parcel (2^17 super-droplets, adaptive
condensation) to step 400, inside the cloud, times a few steps with the
host clock, then the same number of steps under ``torch.profiler``, and
prints per step: K3 launches, K4 launches and rows (none: one cell sums
without a prefix sum), substep solves and host reads, wall time with and
without the profiler, device time per kernel (from the trace's kernel
events) and the device's busy share (the union of kernel intervals over the
profiled and the unprofiled wall time: the profiler's own host cost varies
between runs). The chrome trace goes to ``--out``.

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_parcel.py [--steps 20] [--out build/profiles]``
"""

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
        print("profile_torch_parcel: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    os.makedirs(args.out, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu)
    steps = args.steps
    p = chip_smoke.build_parcel(chip_smoke.N_PARCEL, GPU, adaptive=True)
    p.run(400)
    solver = p.dynamics["Condensation"].solver

    def counts():
        return (k3.masses_new.launches, solver.substep_solves,
                solver.host_reads, scan.cumsum.launches, scan.cumsum.rows)

    t0 = time.perf_counter()
    p.run(steps)
    p.block_until_ready()
    wall = (time.perf_counter() - t0) / steps
    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(steps)
        p.block_until_ready()
        wall_prof = (time.perf_counter() - t0) / steps
    launches, solves, reads, k4, k4_rows = (
        (b - a) / steps for a, b in zip(before, counts())
    )
    trace = os.path.join(args.out, "trace_parcel.json")
    prof.export_chrome_trace(trace)
    kernels = kernel_events(trace)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e["name"]][0] += e["dur"]
        per_name[e["name"]][1] += 1
    busy = busy_us(kernels) / steps
    print(f"== parcel 2^17 adaptive from step 400: {steps} steps; per step"
          f" {launches!r} K3 launches, {k4!r} K4 launches of {k4_rows!r} rows,"
          f" {solves!r} solves, {reads!r} host reads; wall {wall * 1e3!r} ms/step, profiled"
          f" {wall_prof * 1e3!r} ms/step; device busy {busy!r} us/step ="
          f" {busy / (wall_prof * 1e6)!r} of the profiled and"
          f" {busy / (wall * 1e6)!r} of the unprofiled wall time;"
          f" {len(kernels) / steps!r} kernels/step [{gpu}]")
    for name, (dur, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {dur / steps:9.2f} us/step {count / steps:6.1f}/step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
