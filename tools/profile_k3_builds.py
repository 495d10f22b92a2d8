"""K3 (``csrc/condensation.cu``) in several builds side by side on a CUDA
device: the package's source and variants of it made by replacing one
snippet of its text, each built with the package's nvcc flags into
``build/k3_builds/<label>/`` and called through the wrapper
(``ops/cuda/condensation.py`` ``masses_new``) with its library swapped.

The variants (``VARIANTS``) ask what the Ovadnevaite film costs: without
the test of v_beta before the film's quotient (``no_v_beta_test``), and
with the reference's film volume v_wet - 4/3 pi (r - delta)^3
(``difference``), which rounds differently.

For Lowe's film set (``chip_smoke.k3_variant_formulae("c_lowe_film")``),
the AugustRocheMagnus set and the parcel slice's set, at 2^17 and 2^20
drops of ``chip_smoke.k3_variant_rows`` / ``k3_rows`` with their haze
settled: each build's (mass, success) bit-equal to the package's, except
``difference``'s, which is not compared; then the device time of each
build, CUDA events behind a queued sleep (``chip_smoke._time_ms``), the
builds in turns, three rounds. Prints one JSON line per set and size and
the card's name and power limit.

Run from the root of the checkout on a GPU host:
``python tools/profile_k3_builds.py``
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pysdm_tpu_torch import Formulae  # noqa: E402
from pysdm_tpu_torch.ops.condensation import DropSolveSettings  # noqa: E402
from pysdm_tpu_torch.ops.cuda import _build  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402

OUT = "build/k3_builds"
TEST = """    const float c_beta =
        f.v_beta == 0.0f ? 0.0f : nan_min(f.v_beta / v_delta, 1.0f);"""
NO_TEST = "    const float c_beta = nan_min(f.v_beta / v_delta, 1.0f);"
FORM = ("    const float v_delta = c.pi_4_3 * d * (3.0f * r_wet * (r_wet - d)"
        " + d * d);")
DIFFERENCE = "    const float v_delta = v_wet - c.pi_4_3 * ((r_wet - d) * " \
    "((r_wet - d) * (r_wet - d)));"
# label -> [(snippet of the package's source, its replacement)]
VARIANTS = {
    "package": [],
    "no_v_beta_test": [(TEST, NO_TEST)],
    "difference": [(FORM, DIFFERENCE)],
}
COMPARED = ("package", "no_v_beta_test")
SETS = ("c_lowe_film", "a_august_roche_magnus", "parcel")


def build(label, replacements):
    """the ctypes library of the package's source with ``replacements``"""
    text = (_build.CSRC / "condensation.cu").read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"{label}: the snippet is not in the source once")
        text = text.replace(old, new)
    out = os.path.join(OUT, label)
    os.makedirs(out, exist_ok=True)
    source = os.path.join(out, "condensation.cu")
    with open(source, "w", encoding="utf-8") as f:
        f.write(text)
    lib_path = os.path.join(out, "libcondensation.so")
    subprocess.run(
        [_build.nvcc_path(), *_build.flags("condensation"), "-o", lib_path,
         source], check=True, capture_output=True,
    )
    return k3.declare(ctypes.CDLL(os.path.abspath(lib_path)))


def main():
    if not torch.cuda.is_available():
        print("profile_k3_builds: torch sees no CUDA device", file=sys.stderr)
        return 2
    libs = {label: build(label, r) for label, r in VARIANTS.items()}
    device = torch.device("cuda")
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    packaged = k3.library
    try:
        for name in SETS:
            formulae = (Formulae(seed=44) if name == "parcel"
                        else chip_smoke.k3_variant_formulae(name))
            for n in chip_smoke.K3_VARIANT_NS:
                rows = (chip_smoke.k3_rows(n, seed=n) if name == "parcel"
                        else chip_smoke.k3_variant_rows(name, n, seed=n))
                k3.library = packaged
                rows = chip_smoke.settle_haze(formulae, rows, device)
                args = [torch.from_numpy(rows[k]).to(device)
                        for k in chip_smoke.K3_ARGS]
                extra = chip_smoke.k3_optional(torch, rows, device)

                def call():
                    return k3.masses_new(formulae, settings, *args, **extra)

                times = {label: [] for label in libs}
                reference = None
                for _ in range(3):
                    for label, lib in libs.items():
                        k3.library = lambda lib=lib: lib
                        got = call()
                        if label == COMPARED[0]:
                            reference = got
                        elif label in COMPARED and not all(
                            torch.equal(a, b) for a, b in zip(got, reference)
                        ):
                            raise AssertionError(
                                f"{label} is not bit-equal to the package's"
                                f" build on {name} at n={n}"
                            )
                        times[label].append(chip_smoke._time_ms(torch, call, 20))
                print(json.dumps({"set": name, "n": n, "ms": times}), flush=True)
    finally:
        k3.library = packaged
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
