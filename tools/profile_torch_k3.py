"""Device time of K3, the per-drop condensation solve, on a CUDA device, by
what its drops do.

Times ``masses_new`` (CUDA events behind a queued device sleep, as
``chip_smoke.py`` times kernels) on ``chip_smoke.k3_rows`` with its haze
settled, at 2^17, 2^20 and the warm rain's 2.56 M drops, for four sets of
rows: the mixed five cells of phase 5; every drop growing (cell 0's state
for all cells); every drop haze at its float32 equilibrium; every cell
inactive. The last shows what a drop that does not solve costs, the first
two what the solve costs beyond the preamble. Where the plain twin reports
them, the minfun evaluations per drop stand beside each time.

``--no-fma`` builds the kernel with ``-fmad=false``, as the port's other
kernels are built.

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_k3.py [--no-fma]``
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from pysdm_tpu_torch import Formulae  # noqa: E402
from pysdm_tpu_torch.ops.condensation import DropSolveSettings  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402

SIZES = (2**17, 2**20, 2_560_000)


def row_sets(formulae, n, device):
    """{name: rows} of the four sets at n drops"""
    mixed = chip_smoke.settle_haze(
        formulae, chip_smoke.k3_rows(n, seed=n), device
    )
    uniform = chip_smoke.k3_uniform_rows
    return {
        "mixed": mixed, "growing": uniform(mixed, 0), "haze": uniform(mixed, 1),
        "inactive": uniform(mixed, 0, active=False),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--no-fma", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k3: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.no_fma:
        from pysdm_tpu_torch.ops.cuda import _build

        _build.SOURCE_FLAGS["condensation"] = _build.FMAD_DEFAULT
    device = torch.device("cuda")
    gpu = chip_smoke.gpu_line()
    label = "without FMA contraction" if args.no_fma else "as built"
    print(f"{gpu}; K3 {label}, from {os.getcwd()}")
    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    for n in SIZES:
        for name, rows in row_sets(formulae, n, device).items():
            tensors = [
                torch.from_numpy(rows[k]).to(device) for k in chip_smoke.K3_ARGS
            ]
            ms = chip_smoke._time_ms(
                torch, lambda: k3.masses_new(formulae, settings, *tensors), 50
            )
            stats = {}
            k3.masses_new_reference(formulae, settings, *tensors, stats=stats)
            per_drop = stats["minfun_evaluations"] / n
            print(f"K3 n={n} {name}: {ms!r} ms; the twin counts {per_drop!r}"
                  f" minfun evaluations per drop [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
