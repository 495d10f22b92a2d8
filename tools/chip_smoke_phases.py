"""Some phases of ``chip_smoke.py`` alone on a CUDA device: every kernel
built first (as phase 1 builds them), then each named function of
``chip_smoke`` that takes the card's line alone (the model phases 38-50,
``_kreidenweis_on_card`` and its neighbours), each followed by a ``phase
<name>: wall X s, total Y s`` line, and their records as one JSON line.

Run from the root of the checkout on a GPU host, for example
``python tools/chip_smoke_phases.py _kreidenweis_on_card
_kreidenweis_float32_vs_float64 _jaruga_on_card`` (phases 43, 43b, 44).
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(names):
    if not torch.cuda.is_available():
        print("chip_smoke_phases: torch sees no CUDA device", file=sys.stderr)
        return 2
    phases = [getattr(chip_smoke, name) for name in names]
    clock = chip_smoke.PhaseClock()
    gpu = chip_smoke.gpu_line()
    print(gpu)
    chip_smoke.build_kernels()
    clock("build")
    records = {}
    for name, phase in zip(names, phases):
        records[name] = phase(gpu)
        clock(name)
    print(json.dumps(records, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
