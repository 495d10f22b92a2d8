"""Inclusive prefix sum: the Hopper kernel ``csrc/scan.cu``, its wrapper
and its plain PyTorch twin.

Replaces the TPU kernel ``cumsum`` -> ``_cumsum_pallas``
(``pysdm_tpu/ops/pallas/scan.py:105``/``:63``, body ``_cumsum_kernel``
``:30``), the scan under every per-cell sum (``ops/segments.py``
``sorted_segment_sum``). The JAX package takes its kernel only from 32768
elements up, a TPU dispatch choice; here every CUDA tensor goes through
the kernel, 1D or the rows of a contiguous ``(R, n)`` tensor in one launch.

The kernel is one launch and one pass (8 B per float32 element): a tile
publishes its total under a flag and takes its exclusive prefix from the
totals published before it, summed in an order that depends on the tile's
position only (the source states it). So float32 results differ from
``torch.cumsum`` in the last bits but not from one run to the next, a row
of an ``(R, n)`` call equals its 1D scan bit for bit, and integer results
are exact.

The flags carry a generation number, so no launch clears them: the wrapper
keeps a scratch buffer per device, stream and shape (zeroed once, when it
is allocated) and numbers the launches on it. It keeps at most
``_SCRATCH_ENTRIES`` of them (8 bytes per tile and group: ~5 KB a row at
2.56 M elements) and drops the one used longest ago to make room.
"""

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}
# (device index, stream, rows, n) -> [scratch buffer, last generation], in
# the order of last use
_SCRATCH = {}
_SCRATCH_ENTRIES = 64


def cumsum_reference(x):
    """plain twin: ``torch.cumsum`` along the last axis in the input's dtype
    (torch would widen int32 to int64)"""
    return torch.cumsum(x, -1, dtype=x.dtype)


def cumsum(x):
    """inclusive cumsum along the last axis of a 1D or 2D tensor in its own
    dtype. CPU tensors take the plain twin; CUDA tensors launch the Hopper
    kernel once (float32, int32 or int64) or raise."""
    if x.dim() not in (1, 2):
        raise ValueError(
            f"cumsum: 1D or 2D tensor expected, got shape {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return cumsum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"cumsum kernel: float32, int32 or int64, not {x.dtype}")
    return _launch(x)


# launches of the kernel, and the rows they scanned
cumsum.launches = 0
cumsum.rows = 0


@functools.cache
def library():
    """the built library with its entry points' C signatures declared"""
    lib = _build.load("scan")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.pysdm_cumsum.argtypes = [
        vp, ctypes.c_int, ll, ll, vp, ctypes.c_uint, vp, vp,
    ]
    lib.pysdm_cumsum.restype = ctypes.c_int
    lib.pysdm_cumsum_scratch_bytes.argtypes = [ll, ll]
    lib.pysdm_cumsum_scratch_bytes.restype = ll
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(lib, device, stream, rows, n):
    """the zeroed-once flag buffer of this device, stream and shape, and the
    next generation number on it. A stream's handle that CUDA hands out
    again after the stream was destroyed finds the old stream's entry:
    its generations go on rising, so no stale flag passes for a new one."""
    key = (device.index, stream, rows, n)
    entry = _SCRATCH.pop(key, None)
    if entry is None or entry[1] == 2**32 - 1:
        if len(_SCRATCH) >= _SCRATCH_ENTRIES:
            del _SCRATCH[next(iter(_SCRATCH))]
        # allocated under the current stream, so the caching allocator
        # orders a later reuse of the memory after this stream's launches
        buffer = torch.zeros(
            lib.pysdm_cumsum_scratch_bytes(rows, n), dtype=torch.uint8,
            device=device,
        )
        entry = [buffer, 0]
    _SCRATCH[key] = entry
    entry[1] += 1
    return entry


def _launch(x):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.shape[0] if x.dim() == 2 else 1
    n = x.shape[-1]
    if n == 0 or rows == 0:
        return out
    lib = library()
    x = x.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        buffer, generation = _scratch(lib, x.device, stream, rows, n)
        err = lib.pysdm_cumsum(
            x.data_ptr(), _DTYPES[x.dtype], rows, n, buffer.data_ptr(),
            generation, out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"scan launch failed: {msg} ({err})")
    cumsum.launches += 1
    cumsum.rows += rows
    return out
