"""The readings a cell's limits are set from: the program's and the
control's, against the plain reference. The control is the reference put
in the program's place and computed in a lower precision than the
configuration states (its state kept in bfloat16); it has to come out not
correct. The benchmark's own runs never run this.

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]
    python portbench/control.py --workload <cell> --scan --seed 1 [--stride 5]

The first makes one run of the cell for each seed (``run.py``, ``--trace
0``) and, after its comparison, compares the control with the reference the
same way: the run's line then holds ``control_checks`` beside ``checks``.
``--scan`` is for a cell whose compared step is drawn from the seed
(``case.k``): one process builds the cell once and, for every ``--stride``-th
step of the episode in turn, replays the episode from the snapshot and
prints the program's and the control's readings at that step, one JSON
line each.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.harness import episodes  # noqa: E402
from portbench.harness.catalog import Catalog  # noqa: E402

CONTROL = torch.bfloat16
GIB = 2.0**30
# a scan that holds more than this much host memory stops
RSS_LIMIT = 32 * GIB


def scan(workload, seed, root=run.ROOT, backend_class=None, device="cuda", stride=1):
    catalog = Catalog(root)
    cell = catalog.cell(workload)
    case = catalog.config_module(cell.config).build(
        cell.config_data, cell.traffic_data, seed, backend_class=backend_class
    )
    p = case.particulator
    snap = episodes.snapshot(p)
    for k in range(0, case.episode_steps, stride):
        case.k, case.stops = k, [k, k + 1]
        episodes.restore(p, snap)
        episodes.run_episode(p, case, 0)
        want = case.reference(device)
        line = {
            "k": k,
            "checks": {n: v for n, (v, _) in case.compare(case.outputs(), want).items()},
            "control_checks": {
                n: v for n, (v, _) in
                case.compare(case.reference(device, store=CONTROL), want).items()
            },
        }
        print(json.dumps(line), flush=True)
        rss = _rss_bytes()
        print(f"control: k={k} host {rss / GIB!r} GiB, device"
              f" {torch.cuda.memory_allocated() / GIB if device == 'cuda' else 0.0!r} GiB",
              file=sys.stderr, flush=True)
        if rss > RSS_LIMIT:
            raise MemoryError(f"the scan holds {rss} B of host memory")
    return 0


def _rss_bytes():
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--scan", action="store_true")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--stride", type=int, default=1)
    args = parser.parse_args(argv)
    if args.scan:
        return scan(args.workload, args.seed, stride=args.stride)
    rc = 0
    for seed in args.seeds.split(","):
        rc = rc or run.main(
            ["--workload", args.workload, "--seed", seed,
             "--seconds", str(args.seconds), "--trace", "0"],
            control=CONTROL,
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
