"""Where the time of the PyTorch port's 2D warm-rain step goes, on a CUDA
device.

Builds ``chip_smoke.py``'s full-width warm rain (config #5: 25 x 25 cells,
2^12 super-droplets per cell, collisions and sedimentation on), runs one
warm-up step, times a few steps with the host clock, then the same number
of steps under ``torch.profiler``, and prints per step: the launches of K2
(sort-croupier coalescence), K3 (condensation solve) and K4 (prefix sum,
with the rows it scanned), collision substeps, condensation solves and host reads, wall time with and
without the profiler, device time per kernel (from the trace's kernel
events) and the device's busy share (the union of kernel intervals over the
profiled and the unprofiled wall time). The chrome trace goes to ``--out``.

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_warmrain.py [--steps 10] [--out build/profiles]``
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
from profile_torch_box import busy_us, kernel_events  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--out", default="build/profiles")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_warmrain: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    os.makedirs(args.out, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu)
    steps = args.steps
    _, p, spin_up = chip_smoke.warm_rain(
        None, chip_smoke.WARM_RAIN_GRID, chip_smoke.WARM_RAIN_SD_PER_CELL
    )
    spin_up.finish()
    p.run(1)
    p.block_until_ready()
    collision = p.dynamics["Collision"]
    solver = p.dynamics["Condensation"].solver

    def counts():
        return (
            kern.coalesce_adjacent.launches, k3.masses_new.launches,
            scan.cumsum.launches, collision.substeps_run,
            solver.substep_solves, chip_smoke._host_reads(p),
            scan.cumsum.rows,
        )

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
    k2, k3_n, k4, substeps, solves, reads, k4_rows = (
        (b - a) / steps for a, b in zip(before, counts())
    )
    trace = os.path.join(args.out, "trace_warmrain.json")
    prof.export_chrome_trace(trace)
    kernels = kernel_events(trace)
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e["name"]][0] += e["dur"]
        per_name[e["name"]][1] += 1
    busy = busy_us(kernels) / steps
    print(f"== warm rain {chip_smoke.WARM_RAIN_GRID} x"
          f" {chip_smoke.WARM_RAIN_SD_PER_CELL}: {steps} steps; per step"
          f" {k2!r} K2, {k3_n!r} K3, {k4!r} K4 launches ({k4_rows!r} rows), {substeps!r} collision"
          f" substeps, {solves!r} condensation solves, {reads!r} host reads;"
          f" wall {wall * 1e3!r} ms/step, profiled {wall_prof * 1e3!r}"
          f" ms/step; device busy {busy!r} us/step ="
          f" {busy / (wall_prof * 1e6)!r} of the profiled and"
          f" {busy / (wall * 1e6)!r} of the unprofiled wall time;"
          f" {len(kernels) / steps!r} kernels/step [{gpu}]")
    for name, (dur, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:40]:
        print(f"  {dur / steps:9.2f} us/step {count / steps:6.1f}/step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
