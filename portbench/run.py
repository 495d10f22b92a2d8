"""The benchmark of the PyTorch and CUDA port, ``pysdm_tpu_torch``.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process on one card. It builds the cell's simulation from
its configuration, its traffic and the seed, warms up with one whole
episode, snapshots the state and both generators on the device, and then
replays episodes from the snapshot for ``--seconds`` (``harness/episodes.py``).
With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` the per-layer metrics read from one traced episode
(``harness/trace.py``, ``metrics/``). After the window it compares what the
timed path produced with the plain reference (``reference/``) and prints one
JSON line: ``correct``, ``attempted`` (steps run), ``failed`` (steps of an
episode whose end state failed its checks), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit, which also close standard error.

It never falls back to the CPU: without a CUDA card, or without the program
in the checkout, it exits non-zero and prints no result. Nothing it runs
imports JAX or the JAX package (``harness/guard.py``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import device, episodes, guard, stats, trace  # noqa: E402
from portbench.harness.catalog import Catalog  # noqa: E402

GIB = 2.0**30


def process_age_s():
    """seconds since this process started: the kernel's start time where
    /proc has it, else since this module began"""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if age > 0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_START


class Cuda:
    """what a run needs of the card"""

    backend_class = None  # the program's GPU backend
    torch_device = "cuda"

    @staticmethod
    def missing(chips):
        return device.cards_missing(chips)

    @staticmethod
    def describe(chips):
        return device.describe(chips)

    @staticmethod
    def synchronize():
        torch.cuda.synchronize()

    @staticmethod
    def clock(steps):
        return episodes.StepClock(steps)

    @staticmethod
    def memory_peak():
        return torch.cuda.max_memory_allocated()

    @staticmethod
    def free():
        torch.cuda.empty_cache()


def host_reads(particulator):
    """the sum of the program's ``host_reads`` counters: each dynamic's
    (Collision, Displacement) and its solver's (Condensation)"""
    total = 0
    for dynamic in particulator.dynamics.values():
        total += getattr(dynamic, "host_reads", 0)
        total += getattr(getattr(dynamic, "solver", None), "host_reads", 0)
    return total


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def say(*lines):
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def main(argv=None, platform=None, root=ROOT, control=None, tamper=None):
    """one run; exit code. ``control``: also judge the reference computed
    in that precision (``control.py``); ``tamper(case)``: a fault planted
    in the program after its build (the tests)"""
    args = parse_args(argv)
    platform = platform or Cuda()
    catalog = Catalog(root)
    try:
        cell = catalog.cell(args.workload)
    except KeyError as e:
        say(f"portbench: {e}; no result")
        return 2
    why = platform.missing(cell.chips)
    if why:
        say(f"portbench: {why}; no result")
        return 3
    dev = platform.describe(cell.chips)
    say(f"portbench: {cell.name} on {dev['count']} x {dev['kind']},"
        f" power limit {dev.get('power_limit_w')} W")
    try:
        import pysdm_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f"portbench: the program is not in this checkout ({e}); no result")
        return 4

    seed = args.seed % 2**63
    case = catalog.config_module(cell.config).build(
        cell.config_data, cell.traffic_data, seed,
        backend_class=platform.backend_class,
    )
    if tamper is not None:
        tamper(case)
    p = case.particulator
    snap = episodes.snapshot(p)
    clock = platform.clock(case.episode_steps)
    p.observers.append(clock)
    if args.trace:
        trace.install_spans(p)
    # warm-up: one whole episode through every path the window takes
    episodes.run_episode(p, case, -1)
    platform.synchronize()
    case.after_episode()
    episodes.restore(p, snap)
    platform.synchronize()
    setup_s = process_age_s()
    say(f"portbench: set-up {setup_s!r} s")

    metrics, extra, breakdown = {}, {}, None
    if not args.trace:
        window = episodes.run_window(
            p, case, snap, clock, args.seconds, platform.synchronize
        )
        attempted, failed = len(window.step_ms), window.failed
        values = {
            "sd_steps_per_s": case.n_sd * attempted / window.seconds,
            "setup_s": setup_s,
        }
        extra = {
            "episodes": len(window.episode_ms),
            "episode_ms": window.episode_ms,
            "window_s": window.seconds,
            "step_ms_median": stats.median(window.step_ms),
            "step_ms_p95": stats.p95(window.step_ms),
            "peak_mem_gib": platform.memory_peak() / GIB,
            "between_episodes_share": 1.0 - sum(window.step_ms) * 1e-3 / window.seconds,
        }
        # a metric named for its cells (``sd_steps_per_s.box``) reports the
        # quantity before the first dot
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[m.name.split(".")[0]], "unit": m.unit}
    else:
        reads0 = host_reads(p)
        events, window_s = trace.profile_episode(
            lambda: episodes.run_episode(p, case, 0), platform.synchronize
        )
        attempted = case.episode_steps
        failed = case.after_episode()
        ops = trace.device_ops(events)
        tr = trace.Trace(
            ops=ops, window_s=window_s,
            busy_s=trace.busy_us((o.start_us, o.start_us + o.dur_us) for o in ops) * 1e-6,
            steps=attempted, host_reads=host_reads(p) - reads0,
            shapes=case.shapes(),
        )
        breakdown = {
            "device_ops": trace.top_device_ops(ops),
            "idle_gaps": trace.idle_gaps(events, ops),
        }
        del events
        for m in cell.per_layer:
            value = catalog.metric_reader(m.name)(tr)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
                # a share of a roofline holds for the card's power limit
                limit = (f" at a {dev.get('power_limit_w')} W power limit"
                         if m.name.endswith("_roofline_pct") else "")
                say(f"portbench: {m.name} {value!r} {m.unit}{limit}")
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        extra = {"spans": sorted(tr.spans())}
    dev["memory_peak_bytes"] = platform.memory_peak()

    # the program's state goes before the reference runs, so that the
    # reference sets no peak of its own and fits beside what is kept
    outputs = case.outputs()
    p.sim_state = None
    del snap
    platform.free()
    t0 = time.perf_counter()
    want = case.reference(platform.torch_device)
    checks = case.compare(outputs, want)
    checks["failed_steps"] = (failed, 0)
    extra["reference_s"] = time.perf_counter() - t0
    if control is not None:
        got = case.reference(platform.torch_device, store=control)
        extra["control_checks"] = {
            name: {"value": value, "limit": limit}
            for name, (value, limit) in case.compare(got, want).items()
        }
    correct = all(value <= limit for value, limit in checks.values())
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(extra)
    found = guard.forbidden_modules()
    if found:
        say(f"portbench: the run loaded {', '.join(found)}; no result")
        return 5
    result["checks"] = {
        name: {"value": value, "limit": limit}
        for name, (value, limit) in checks.items()
    }
    print(json.dumps(result), flush=True)
    say(*(f"check {name} {value!r} limit {limit!r}"
          for name, (value, limit) in checks.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
