"""Inclusive prefix sum: the Hopper kernel ``csrc/scan.cu``, its wrapper
and its plain PyTorch twin.

Replaces the TPU kernel ``cumsum`` -> ``_cumsum_pallas``
(``pysdm_tpu/ops/pallas/scan.py:105``/``:63``, body ``_cumsum_kernel``
``:30``), the scan under every per-cell sum (``ops/segments.py``
``sorted_segment_sum``). The JAX package takes its kernel only from 32768
elements up, a TPU dispatch choice; here every 1D CUDA tensor goes through
the kernel.

The kernel sums in a fixed order (tile-local scans and a scan of the tile
totals), so float32 results differ from ``torch.cumsum`` in the last bits
but not from one run to the next; integer results are exact.

Bound on the card: bytes, 12 B per float32 element read and written by the
three passes, 8 B per element for any scan.
"""

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}


def cumsum_reference(x):
    """plain twin: ``torch.cumsum`` in the input's dtype (torch would widen
    int32 to int64)"""
    return torch.cumsum(x, 0, dtype=x.dtype)


def cumsum(x):
    """inclusive cumsum of a 1D tensor in its own dtype. CPU tensors take the
    plain twin; CUDA tensors launch the Hopper kernel (float32, int32 or
    int64) or raise."""
    if x.dim() != 1:
        raise ValueError(f"cumsum: 1D tensor expected, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return cumsum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"cumsum kernel: float32, int32 or int64, not {x.dtype}")
    return _launch(x)


cumsum.launches = 0


@functools.cache
def library():
    """the built library with its entry points' C signatures declared"""
    lib = _build.load("scan")
    vp = ctypes.c_void_p
    lib.pysdm_cumsum.argtypes = [vp, ctypes.c_int, ctypes.c_longlong, vp, vp, vp]
    lib.pysdm_cumsum.restype = ctypes.c_int
    lib.pysdm_cumsum_scratch.argtypes = [ctypes.c_longlong]
    lib.pysdm_cumsum_scratch.restype = ctypes.c_longlong
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x):
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = library()
    x = x.contiguous()
    scratch = torch.empty(
        lib.pysdm_cumsum_scratch(n), dtype=x.dtype, device=x.device
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pysdm_cumsum(
            x.data_ptr(), _DTYPES[x.dtype], n, scratch.data_ptr(),
            out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"scan launch failed: {msg} ({err})")
    cumsum.launches += 1
    return out
