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

Last, it builds a probe source beside the outputs that includes
``collision_breakup.cu`` and adds one kernel per piece of K5's per-pair
arithmetic (Berry's Ec, the fragment mass, the transfer), each called once
on loaded arguments, and counts their SASS instructions: what a pair with
gamma > 0, or one that breaks up, adds to a pair that does neither.

With ``--k3-parent SRC`` (another ``condensation.cu``, such as the one
``chip_smoke.py`` keeps in ``build/k3_parent``), prints ptxas's lines and
the SASS instructions of the solve's kernels of both sources, side by side.

Then the pH solve's loops (``chemistry.cu``, and with ``--ph-source SRC``,
which may be given more than once, each other form of the solve beside it,
such as a parent's ``chemistry.cu``): for each kernel, each loop of its
SASS (a backward branch and the instructions from its target to it) with
its instructions by class, MUFU (exp2, reciprocal), FP32, FP64 and branch
(BRA, BSSY, BSYNC, CALL, RET, the warp's votes and syncs), and all. The
bisection's loop is the largest: an iteration (or two, where the compiler
unrolls it).

Run from the root of the checkout on a host with the CUDA toolkit:
``python tools/kernel_resources.py [--out build/resources] [--k3-parent SRC]
[--ph-source SRC ...]``
"""

import argparse
import os
import pathlib
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
        [nvcc, *_flags(source.stem, extra), "-I", str(_build.CSRC), "-Xptxas",
         "-v", "-cubin", "-o", cubin, str(source)],
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


SASS_CLASSES = {
    "MUFU": ("MUFU",),
    "FP32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
             "FRND", "FSET", "FSWZADD"),
    "FP64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "VOTE", "WARPSYNC",
               "BREAK", "EXIT"),
}


def sass_loops(sass):
    """{function: [(first address, last address, {class: count, "all":
    count})]} for each backward branch of a cuobjdump SASS listing"""
    loops, name, body, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        found = []
        for k, (addr, text) in enumerate(body):
            target = re.search(r"BRA\s+(?:\S+\s+)?`?\(?(\.L_x_\d+|0x[0-9a-f]+)",
                               text)
            if not target:
                continue
            label = target.group(1)
            start = (labels.get(label) if label.startswith(".L")
                     else int(label, 16))
            if start is None or start > addr:
                continue
            ops = [t.split()[0] for a, t in body if start <= a <= addr]
            ops = [o for o in ops if not o.startswith("@")] + [
                t.split()[1] for a, t in body
                if start <= a <= addr and t.split()[0].startswith("@")
            ]
            counts = {cls: sum(o.split(".")[0] in names for o in ops)
                      for cls, names in SASS_CLASSES.items()}
            counts["all"] = len(ops)
            found.append((start, addr, counts))
        loops[name] = found

    pending = []
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            close()
            name, body, labels, pending = header.group(1), [], {}, []
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        inst = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inst and name:
            addr = int(inst.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            body.append((addr, inst.group(2).strip()))
    close()
    return loops


def ph_loop_report(nvcc, source, out_dir, label):
    """ptxas's lines and the loops of each kernel of a ``chemistry.cu``"""
    out = os.path.join(out_dir, label)
    os.makedirs(out, exist_ok=True)
    cubin, report = ptxas_report(nvcc, source, out)
    print(f"== the pH solve, {label} ({source}): ptxas; loops by SASS class")
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.replace("ptxas info    : ", ""))
    sass_counts(nvcc, cubin)
    with open(cubin + ".sass") as f:
        loops = sass_loops(f.read())
    for name, found in loops.items():
        for start, end, counts in found:
            print(f"  {name} loop 0x{start:04x}-0x{end:04x}: {counts}")


K5_PROBE = r"""
#include "collision_breakup.cu"

__global__ void probe_berry_1967_ec(const float* a, const float* b, float* out) {
  const int i = threadIdx.x;
  out[i] = berry_1967_ec(a[i], b[i]);
}

__global__ void probe_fragment_mass(PairFunctions f, const float* a,
                                    const float* b, float* out) {
  const int i = threadIdx.x;
  out[i] = fragment_mass(f, a[i], b[i], out[i]);
}

__global__ void probe_transfer(const float* a, float* out) {
  const int i = threadIdx.x;
  const Transfer t = transfer_closed_form(a[i], a[i + 32], a[i + 64],
                                          a[i + 96], a[i + 128], a[i + 160],
                                          a[i + 192]);
  out[i] = t.take;
  out[i + 32] = t.nmk;
  out[i + 64] = t.g;
}
"""


def k5_probe_counts(nvcc, out_dir):
    """{probe kernel: SASS instructions} of K5's per-pair pieces"""
    probe = os.path.join(out_dir, "k5_probe.cu")
    with open(probe, "w", encoding="utf-8") as f:
        f.write(K5_PROBE)
    cubin = os.path.join(out_dir, "k5_probe.cubin")
    proc = subprocess.run(
        [nvcc, *_flags("collision_breakup", ()), "-I", str(_build.CSRC),
         "-cubin", "-o", cubin, probe],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {probe}:\n{proc.stderr}")
    return {
        name: count for name, count in sass_counts(nvcc, cubin).items()
        if "probe_" in name
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="build/resources")
    parser.add_argument("--k3-parent", default=None)
    parser.add_argument("--ph-source", action="append", default=[])
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
    if args.k3_parent:
        for label, source in (
            ("this build", _build.CSRC / "condensation.cu"),
            ("parent", pathlib.Path(args.k3_parent)),
        ):
            out = os.path.join(args.out, label.replace(" ", "_"))
            os.makedirs(out, exist_ok=True)
            cubin, report = ptxas_report(nvcc, source, out)
            print(f"== K3, {label} ({source}): ptxas, SASS instructions")
            for line in report.splitlines():
                if "Compiling entry" in line or "registers" in line:
                    print("  " + line.replace("ptxas info    : ", ""))
            for name, count in sass_counts(nvcc, cubin).items():
                print(f"  {count:6d}  {name}")
    ph_loop_report(nvcc, _build.CSRC / "chemistry.cu", args.out, "ph_this_build")
    for k, source in enumerate(args.ph_source):
        ph_loop_report(nvcc, pathlib.Path(source), args.out, f"ph_source_{k}")
    print("== K5's per-pair pieces (collision_breakup.cu probes): SASS"
          " instructions")
    for name, count in k5_probe_counts(nvcc, args.out).items():
        print(f"  {count:6d}  {name}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
