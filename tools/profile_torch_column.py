"""Where the time of the PyTorch port's 1D column step goes, on a CUDA
device.

Builds ``chip_smoke.py``'s full-width Shipway and Hill 2012 column (config
#4: 145 cells of 25 m, 2^12 super-droplets per cell, dt = 1 s) through
``Simulation``, and at each of the ``--at`` times (s; the default is one
window below cloud and one in cloud) runs on to that time, times
``--steps`` steps with the host clock, then the same number of steps under
``torch.profiler``, and prints per step: the launches of K2 (sort-croupier
coalescence), K3 (condensation solve) and K4 (prefix sum, with the rows it
scanned), collision substeps, condensation solves and host reads, wall time
with and without the profiler, device time per kernel (from the trace's
kernel events: the 30 longest, and K2's, K3's and K4's whatever their
rank) and the device's busy share (the union of kernel intervals over the
profiled and the unprofiled wall time). The chrome traces go to ``--out``.

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_column.py [--steps 10] [--at 1,400]
[--out build/profiles]``
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

# the entry points of K2, K3 and K4, printed whatever their rank
PORT_KERNELS = ("coalesce_adjacent_kernel", "masses_new_kernel", "scan_kernel")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--at", default="1,400")
    parser.add_argument("--out", default="build/profiles")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_column: torch sees no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu)
    steps = args.steps
    settings, simulation = chip_smoke.shipway_hill(
        None, n_sd_per_gridbox=chip_smoke.COLUMN_SD_PER_CELL
    )
    p = simulation.particulator
    p.run(1)
    p.block_until_ready()
    for at in (float(t) for t in args.at.split(",")):
        p.run(max(int(at / settings.dt) - p.n_steps, 0))
        t_start = p.n_steps * settings.dt
        wall = chip_smoke.column_launches(p, lambda: p.run(steps))["seconds"] / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            counts = chip_smoke.column_launches(p, lambda: p.run(steps))
        wall_prof = counts.pop("seconds") / steps
        per_step = {k: v / steps for k, v in counts.items()}
        trace = os.path.join(args.out, f"trace_column_{int(t_start)}.json")
        prof.export_chrome_trace(trace)
        kernels = kernel_events(trace)
        per_name = collections.defaultdict(lambda: [0.0, 0])
        for e in kernels:
            per_name[e["name"]][0] += e["dur"]
            per_name[e["name"]][1] += 1
        busy = busy_us(kernels) / steps
        print(f"== column {p.mesh.n_cell} cells x"
              f" {chip_smoke.COLUMN_SD_PER_CELL} from t = {t_start!r} s:"
              f" {steps} steps; per step {per_step}; wall"
              f" {wall * 1e3!r} ms/step, profiled {wall_prof * 1e3!r}"
              f" ms/step; device busy {busy!r} us/step ="
              f" {busy / (wall_prof * 1e6)!r} of the profiled and"
              f" {busy / (wall * 1e6)!r} of the unprofiled wall time;"
              f" {len(kernels) / steps!r} kernels/step [{gpu}]")
        for name, (dur, count) in sorted(
            per_name.items(), key=lambda kv: -kv[1][0]
        )[:30]:
            print(f"  {dur / steps:9.2f} us/step {count / steps:6.1f}/step  {name[:100]}")
        for name, (dur, count) in per_name.items():
            if any(k + "(" in name or k + "<" in name for k in PORT_KERNELS):
                print(f"  K {dur / steps:9.2f} us/step {count / steps:6.1f}/step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
