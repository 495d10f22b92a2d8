"""Registers, shared memory and spills of the PyTorch port's CUDA kernels,
and the instruction count of K3's minfun, from the compiler.

For every ``pysdm_tpu_torch/csrc/*.cu`` runs ``nvcc -Xptxas -v`` with the
source's flags and prints ptxas's lines per kernel. Then builds
``condensation.cu`` with ``-DK3_MINFUN_PROBE`` into a cubin, which adds a
kernel that evaluates minfun once under the default variant set, and
counts the SASS instructions (``cuobjdump -sass``) of that kernel (an
evaluation, three loads, a store and their addresses) and of the solve's
kernel (all variants, every branch), and prints the card's name, power
limit and largest SM clock beside them.

Run from the root of the checkout on a host with the CUDA toolkit:
``python tools/kernel_resources.py [--out build/resources]``
"""

import argparse
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pysdm_tpu_torch.ops.cuda import _build  # noqa: E402


def _flags(name, extra):
    """the source's nvcc flags without those that ask for a shared library"""
    drop = {"-shared", "-Xcompiler", "-fPIC"}
    return [f for f in (*_build.flags(name), *extra) if f not in drop]


def ptxas_report(nvcc, source, out_dir, extra=()):
    cubin = os.path.join(out_dir, source.stem + "".join(extra) + ".cubin")
    proc = subprocess.run(
        [nvcc, *_flags(source.stem, extra), "-Xptxas", "-v", "-cubin", "-o",
         cubin, str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return cubin, proc.stderr


def sass_counts(nvcc, cubin):
    """{function name: SASS instructions} of a cubin"""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True
    ).stdout
    with open(cubin + ".sass", "w") as out:
        out.write(sass)
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[name] += 1
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="build/resources")
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    nvcc = _build.nvcc_path()
    for source in sorted(_build.CSRC.glob("*.cu")):
        _, report = ptxas_report(nvcc, source, args.out)
        print(f"== {source.name}")
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.replace("ptxas info    : ", ""))
    cubin, _ = ptxas_report(
        nvcc, _build.CSRC / "condensation.cu", args.out,
        extra=("-DK3_MINFUN_PROBE",),
    )
    print("== condensation.cu with the minfun probe: SASS instructions")
    for name, count in sass_counts(nvcc, cubin).items():
        print(f"  {count:6d}  {name}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
