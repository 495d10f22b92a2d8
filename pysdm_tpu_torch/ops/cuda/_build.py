"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and may include the shared
device headers ``csrc/*.cuh``. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/pysdm_tpu_torch/`` at the root of the checkout, named by a hash of
the source and the flags, and loaded with ``ctypes``. A missing ``nvcc`` or a
failed build raises; nothing falls back to another implementation.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "pysdm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# contraction of a*b+c into FMA, per source. Off by default: the collision
# kernels, the scan and the pH solve mirror separately rounded operations
# bit for bit. On for the condensation solve, which is held to its twin by a
# tolerance: an FMA is one instruction for two and rounds once.
FMAD_DEFAULT = ("-fmad=false",)
SOURCE_FLAGS = {"condensation": ("-fmad=true",)}


def flags(name):
    """the nvcc flags of ``csrc/<name>.cu``"""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, FMAD_DEFAULT)


def nvcc_path():
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises if neither exists"""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are"
        " built from csrc/ at first use"
    )


def library_path(name):
    """the source and its library's path; the name hashes the source, the
    shared headers ``csrc/*.cuh`` and the flags"""
    source = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(flags(name)).encode()
    ).hexdigest()[:16]
    return source, BUILD_DIR / f"lib{name}_{digest}.so"


def load(name):
    """the ctypes library built from ``csrc/<name>.cu`` (built first if no
    library of this source and these flags exists yet)"""
    source, target = library_path(name)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name and rename: concurrent builders never
        # load a half-written library
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags(name), "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))


def scratch(table, key, n_bytes, device, entries):
    """a zeroed-once device buffer of ``n_bytes()`` bytes kept in ``table``
    under ``key`` (the device index, the stream and what fixes the buffer's
    layout), and the number of launches made with it, this one included:
    ``[buffer, generation]``. A kernel's one-launch scheme keeps its ticket
    counter (and flags) there: launches on one stream never overlap, so
    they can share one buffer, and no launch clears it. ``table`` keeps at
    most ``entries`` buffers in the order of last use and drops the one used
    longest ago to make room. A stream's handle that CUDA hands out again
    after the stream was destroyed finds the old stream's entry: its
    generations go on rising, so no stale flag passes for a new one."""
    entry = table.pop(key, None)
    if entry is None or entry[1] == 2**32 - 1:
        if len(table) >= entries:
            del table[next(iter(table))]
        # allocated under the current stream, so the caching allocator
        # orders a later reuse of the memory after this stream's launches
        entry = [torch.zeros(n_bytes(), dtype=torch.uint8, device=device), 0]
    table[key] = entry
    entry[1] += 1
    return entry
