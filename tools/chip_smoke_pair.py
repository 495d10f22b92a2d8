"""``chip_smoke.py`` of several checkouts, one after the other on one card,
to compare commits inside one call: each runs from its own directory, its
output into ``chiprun_out/smoke_<directory name>.log``; then a line with
its exit code, its wall time on the host clock, the processes of it still
running 5 s after its end and its last line. Exits 1 if a run failed or
left a process.

Unpack each commit (``git archive``) into a directory that ``.gitignore``
lists, then, from the root of the checkout on a GPU host:
``python tools/chip_smoke_pair.py build/parent build/change``.
"""

import os
import subprocess
import sys
import time


def main(directories):
    os.makedirs("chiprun_out", exist_ok=True)
    failed = 0
    for directory in directories:
        log_path = os.path.join(
            "chiprun_out", f"smoke_{os.path.basename(os.path.normpath(directory))}.log"
        )
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            rc = subprocess.call([sys.executable, "chip_smoke.py"],
                                 cwd=directory, stdout=log,
                                 stderr=subprocess.STDOUT)
        wall = time.perf_counter() - t0
        time.sleep(5)
        ps = subprocess.run(["ps", "-eo", "pid,ppid,etimes,cmd"],
                            capture_output=True, text=True).stdout
        # the script itself, or a helper it spawned (multihost's fork
        # server, multiprocessing's resource tracker)
        left = [line for line in ps.splitlines()
                if ("chip_smoke.py" in line or "multiprocessing" in line)
                and "chip_smoke_pair" not in line]
        with open(log_path) as log:
            lines = log.read().strip().splitlines()
        print(f"{directory}: rc={rc} wall {wall!r} s; left {left}; last line"
              f" {lines[-1] if lines else ''}", flush=True)
        failed += rc != 0 or bool(left)
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
