"""K1 (mirror coalescence, ``csrc/collision_mirror.cu``) and K5 (mirror
collision with breakup, ``csrc/collision_breakup.cu``) alone on a CUDA
device, in one or more builds side by side.

A version is a directory that holds ``collision_mirror.cu``,
``collision_breakup.cu`` and the ``sdm_pair.cuh`` they include, built with
the package's nvcc flags into ``build/mirror_versions/<label>/``. Its C
interface is either the one of the two-launch kernels (per-block partials
passed in, ``pysdm_coalesce_mirror_partials``) or the one-launch kernels'
(scratch kept per stream, ``pysdm_coalesce_mirror_scratch_bytes``), and
K1's takes the volume row alone or the collision kernel's attribute rows
with their count (``n_attr``, the sources since the geometric kernels came
into K1); the tool calls each as its wrapper would. ``--threads`` adds builds of the
package's own sources with another number of threads a block.

For each kernel and shape it checks every version's multiplicities and
extensive rows bit-equal to the first version's and its rate sums within
rtol 1e-5 of them; then it times each version with CUDA events in turns
(the versions in order, then in reverse) on one input, which stays in the
L2, and over a rotation of inputs past the L2, and reads the device time of
each kernel by name under ``torch.profiler`` (a main kernel and a second
pass apart). Shapes: K1 as ``chip_smoke.py`` phase 2 (2^20 slots, two
float32 rows; also 2^16 and float64 rows, multiplicities up to 2^40); K5 as
phase 13 (2^17 and 2^20, config #2's functions and a mixed set) and on 16
substeps captured from config #2's main path.

An ``--ablation`` build (one that leaves some work out) is timed but not
checked.

Run from the root of the checkout on a GPU host, the first version the
reference of the bit checks:
``python tools/profile_torch_mirror.py --version parent=DIR
--version new=pysdm_tpu_torch/csrc [--ablation LABEL=DIR] [--threads
64,256]``
"""

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from profile_torch_box import kernel_events  # noqa: E402
from pysdm_tpu_torch.ops.cuda import _build  # noqa: E402
from pysdm_tpu_torch.ops.cuda import breakup as k5  # noqa: E402

SOURCES = ("collision_mirror", "collision_breakup")
OUT = os.path.join("build", "mirror_versions")


class Version:
    """the two kernels of one source directory, called as their wrappers
    call them"""

    def __init__(self, label, src, threads=None, checked=True):
        self.label = label
        self.checked = checked
        out = os.path.join(OUT, label)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        for name in (*SOURCES, "sdm_pair"):
            ext = ".cuh" if name == "sdm_pair" else ".cu"
            text = open(os.path.join(src, name + ext), encoding="utf-8").read()
            if threads is not None and ext == ".cu":
                text, found = re.subn(
                    r"constexpr int THREADS = \d+;",
                    f"constexpr int THREADS = {threads};", text,
                )
                if found != 1:
                    raise ValueError(f"{src}/{name}.cu: no THREADS constant")
            if name == "collision_mirror":
                # the interface that takes the attribute rows and their count
                self.attr_rows = "int n_attr" in text
            with open(os.path.join(out, name + ext), "w", encoding="utf-8") as f:
                f.write(text)
        self.libs = {}
        nvcc = _build.nvcc_path()
        procs = {
            name: subprocess.Popen(
                [nvcc, *_build.flags(name), "-o",
                 os.path.join(out, f"lib{name}.so"),
                 os.path.join(out, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name in SOURCES
        }
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {label}/{name}.cu:\n{log}")
            self.libs[name] = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        mirror, breakup = self.libs["collision_mirror"], self.libs["collision_breakup"]
        mirror.pysdm_coalesce_mirror.argtypes = [
            vp, vp, ctypes.c_int, ctypes.c_int, vp,
            *((ctypes.c_int,) if self.attr_rows else ()), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, vp, ll, ll, ctypes.c_uint, vp, vp,
            vp, vp, vp,
        ]
        breakup.pysdm_coalesce_breakup_mirror.argtypes = [
            vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, vp,
            ctypes.POINTER(k5._Functions), vp, ll, ll, ctypes.c_uint,
            ctypes.c_float, vp, vp, vp, vp, vp,
        ]
        self.two_launches = hasattr(mirror, "pysdm_coalesce_mirror_partials")
        suffix = "_partials" if self.two_launches else "_scratch_bytes"
        self.size = {
            "collision_mirror": getattr(mirror, "pysdm_coalesce_mirror" + suffix),
            "collision_breakup": getattr(
                breakup, "pysdm_coalesce_breakup_mirror" + suffix
            ),
        }
        for fn in self.size.values():
            fn.argtypes, fn.restype = [ll], ll
        self.buffers = {}

    def buffer(self, name, n):
        """the per-block partials (float32, as the two-launch wrappers
        allocated them) or the zeroed-once scratch"""
        key = (name, n)
        if key not in self.buffers:
            size = self.size[name](n)
            self.buffers[key] = (
                torch.empty(size, dtype=torch.float32, device="cuda")
                if self.two_launches
                else torch.zeros(size, dtype=torch.uint8, device="cuda")
            )
        return self.buffers[key]

    def k1(self, mult, ext, attr, kernel_id, params, scale, K, seed):
        n = mult.shape[0]
        mult_out, ext_out = torch.empty_like(mult), torch.empty_like(ext)
        sums = torch.empty(3, dtype=torch.float32, device="cuda")
        rows = (attr.shape[0],) if self.attr_rows else ()
        err = self.libs["collision_mirror"].pysdm_coalesce_mirror(
            mult.data_ptr(), ext.data_ptr(), int(ext.dtype == torch.float64),
            ext.shape[0], attr.data_ptr(), *rows, int(kernel_id), float(params[0]),
            float(params[1]), scale.data_ptr(), n, int(K), int(seed),
            mult_out.data_ptr(), ext_out.data_ptr(),
            self.buffer("collision_mirror", n).data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"{self.label} K1: CUDA error {err}")
        return mult_out, ext_out, *sums.unbind()

    def k5(self, mult, ext, wm_index, attrs, functions, scale, K, seed, max_mult):
        n = mult.shape[0]
        rows = k5.required_rows(functions)

        def pointer(name):
            return attrs[name].data_ptr() if name in rows else None

        mult_out, ext_out = torch.empty_like(mult), torch.empty_like(ext)
        sums = torch.empty(5, dtype=torch.float32, device="cuda")
        c_functions = k5._c_functions(functions)
        err = self.libs["collision_breakup"].pysdm_coalesce_breakup_mirror(
            mult.data_ptr(), ext.data_ptr(), int(ext.dtype == torch.float64),
            ext.shape[0], int(wm_index), pointer("volume"), pointer("radius"),
            pointer("area" if functions.kernel == k5.SIMPLE_GEOMETRIC
                    else "relative fall velocity"),
            ctypes.byref(c_functions),
            scale.data_ptr(), n, int(K), int(seed), float(max_mult),
            mult_out.data_ptr(), ext_out.data_ptr(),
            self.buffer("collision_breakup", n).data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"{self.label} K5: CUDA error {err}")
        return mult_out, ext_out, *sums.unbind()


def check_bits(label, versions, kernel, args):
    """the versions whose ξ and rows are bit-equal to the first version's
    and whose sums are within rtol 1e-5 of its; a version that differs is
    reported and left out of what follows"""
    outs = [getattr(v, kernel)(*args) for v in versions]
    torch.cuda.synchronize()
    first = outs[0]
    agree = [versions[0]]
    for v, out in zip(versions[1:], outs[1:]):
        if not v.checked:
            agree.append(v)
            continue
        bits = torch.int64 if out[1].dtype == torch.float64 else torch.int32
        got = np.array([x.item() for x in out[2:]])
        want = np.array([x.item() for x in first[2:]])
        if not torch.equal(out[0], first[0]):
            print(f"{label}: {v.label}'s multiplicities differ: dropped")
        elif not torch.equal(out[1].view(bits), first[1].view(bits)):
            print(f"{label}: {v.label}'s extensive rows differ: dropped")
        elif not np.allclose(got, want, rtol=1e-5, atol=0.0):
            print(f"{label}: {v.label}'s sums {got} differ from {want}: dropped")
        else:
            agree.append(v)
    return agree


def time_in_turns(versions, kernel, inputs, reps):
    """{label: [ms on inputs[0], ms over the rotation] read forward and
    backward}"""
    times = collections.defaultdict(list)
    for v in versions + versions[::-1]:
        fn = getattr(v, kernel)
        times[v.label].append((
            chip_smoke._time_ms(torch, lambda: fn(*inputs[0]), reps),
            chip_smoke._time_rotated_ms(torch, lambda a: fn(*a), inputs, reps),
        ))
    return times


def kernel_times(versions, kernel, args, reps=50):
    """{label: {kernel name: device µs per call}} under torch.profiler"""
    out = {}
    for v in versions:
        fn = getattr(v, kernel)
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        trace = os.path.join(OUT, f"trace_{v.label}_{kernel}.json")
        prof.export_chrome_trace(trace)
        per_name = collections.defaultdict(float)
        for e in kernel_events(trace):
            per_name[e["name"].split("(")[0].split("<")[0]] += e["dur"] / reps
        out[v.label] = dict(per_name)
    return out


def report(label, versions, kernel, inputs, gpu, reps=200):
    versions = check_bits(label, versions, kernel, inputs[0])
    times = time_in_turns(versions, kernel, inputs, reps)
    split = kernel_times(versions, kernel, inputs[0])
    for v in versions:
        one = [t[0] for t in times[v.label]]
        rot = [t[1] for t in times[v.label]]
        kernels = ", ".join(f"{k} {us:.2f} us" for k, us in split[v.label].items())
        print(f"{label} {v.label}: one input {one} ms, rotation of"
              f" {len(inputs)} {rot} ms; profiler: {kernels} [{gpu}]")
    return versions


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--version", action="append", default=[],
                        help="LABEL=DIR, in the order of the turns")
    parser.add_argument("--ablation", action="append", default=[],
                        help="LABEL=DIR, timed but not held to the first"
                             " version (a build that leaves work out)")
    parser.add_argument("--threads", default="",
                        help="comma-separated threads a block for builds of"
                             " the package's sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mirror: torch sees no CUDA device", file=sys.stderr)
        return 2
    gpu = chip_smoke.gpu_line()
    print(gpu)
    specs = [(*spec.split("=", 1), None, True) for spec in args.version]
    specs += [(*spec.split("=", 1), None, False) for spec in args.ablation]
    specs += [
        (f"threads{threads}", str(_build.CSRC), int(threads), True)
        for threads in filter(None, args.threads.split(","))
    ]
    versions = []
    for spec in specs:
        try:
            versions.append(Version(*spec))
        except RuntimeError as err:
            if not versions:
                raise
            print(f"{spec[0]}: left out, {err}")
    print("versions: " + ", ".join(
        f"{v.label} ({'two launches' if v.two_launches else 'one launch'}"
        f"{'' if v.checked else ', ablation'})"
        for v in versions
    ))

    device = torch.device("cuda")
    # K1 at phase 2's shapes
    for n, dtype in ((2**16, np.float32), (2**16, np.float64),
                     (2**20, np.float64)):
        versions = check_bits(
            f"K1 n={n} {np.dtype(dtype).name}", versions, "k1",
            chip_smoke.k1_args(torch, n, dtype, n, device),
        )
    inputs = [
        chip_smoke.k1_args(torch, 2**20, np.float32, seed, device)
        for seed in (2**20, 1, 2, 3)
    ]
    versions = report("K1 n=2^20 float32 x2", versions, "k1", inputs, gpu)
    del inputs

    # K5 at phase 13's shapes
    sets = chip_smoke.k5_function_sets()
    for n, name, n_ext, dtype in (
        (2**17, "mixed", 2, np.float64), (2**20, "config2", 2, np.float32),
        (2**20, "mixed", 1, np.float32),
    ):
        K = n // 3 * 2 + 1
        state = chip_smoke.k5_state(n, K, n_ext, dtype, seed=n + n_ext)
        kernel, functions = sets[name]
        label = f"K5 n={n} {name} n_ext={n_ext} {np.dtype(dtype).name}"
        one = chip_smoke.k5_args(torch, state, kernel, functions, K, device)
        if n == 2**20:
            versions = report(label, versions, "k5", [one], gpu)
        else:
            versions = check_bits(label, versions, "k5", one)
    kernel, functions = sets["config2"]
    inputs = [
        chip_smoke.k5_args(
            torch, chip_smoke.k5_state(2**17, K, 1, np.float32, seed), kernel,
            functions, K, device,
        )
        for seed, K in ((2**17 + 1, 2**17 // 3 * 2 + 1),
                        *enumerate(range(1001, 1016)))
    ]
    versions = report(
        "K5 n=2^17 config2 random states", versions, "k5", inputs, gpu
    )
    captured = chip_smoke.capture_k5_substeps(k5, chip_smoke.K5_CAPTURED)
    for k, state in enumerate(captured):
        versions = check_bits(f"K5 captured substep {k}", versions, "k5", state)
    report("K5 n=2^17 config2 captured substeps", versions, "k5", captured, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
