"""K4, the prefix sum, alone on a CUDA device: ``chip_smoke.py``'s phase 8
without the other phases.

Builds ``csrc/scan.cu`` and runs ``chip_smoke._k4_vs_twin``: integers exact,
float32 within bound and bit-equal over three runs, over the rows of a
``(4, n)`` call and across two streams, then the device times of the
kernel, of a ``(4, n)`` call and of ``torch.cumsum`` at the warm rain's
2.56 M float32, on one input (which stays in the L2) and over a rotation of
inputs (which does not).

Run from the root of the checkout on a GPU host:
``python tools/profile_torch_scan.py``
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pysdm_tpu_torch.ops.cuda import scan  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profile_torch_scan: torch sees no CUDA device", file=sys.stderr)
        return 2
    gpu = chip_smoke.gpu_line()
    print(gpu)
    chip_smoke._k4_vs_twin(torch, scan, torch.device("cuda"), gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
