"""The pH solve of aqueous chemistry: the Hopper kernel ``csrc/chemistry.cu``,
its wrapper ``equilibrate_H`` and its plain PyTorch twin
``equilibrate_H_reference``.

Replaces no Pallas kernel: the JAX package's ``equilibrate_H``
(``pysdm_tpu/ops/chemistry.py:74-85``) unrolls its bisection inside
``jit``, and XLA fuses the solve into one elementwise pass over the drops.
The twin runs the same bisection eagerly, ~31 kernels an iteration and
~1,500 a solve; the kernel is the fused pass, one launch a solve, one
thread a drop, all iterations in registers.

The twin is the port's eager solve: the residual's factors that do not
depend on H formed once a solve (``acidity_terms``), then the fixed-count
bisection in log H over the host floats [H_min, H_max] with the midpoint
rule and no early exit. The kernel takes the twin's operations in the
twin's order, each rounded on its own, so on the card the two agree to the
bit wherever torch's exp and the kernel's round alike, and otherwise by at
most the last bracket's width in log H (``tests/unit/
test_torch_cuda_chemistry.py`` counts the drops that differ).
"""

import ctypes
import functools
import math

import torch

from ...utils import profiling
from . import _build

# the bisection's iteration count (``pysdm_tpu/ops/chemistry.py:74``)
PH_ITERATIONS = 48
# the kernel's per-drop rows, in the order ``csrc/chemistry.cu`` reads them
CONC_ROWS = ("S_VI", "S_IV", "C_IV", "N_V", "N_mIII")
K_ROWS = ("K_NH3", "K_HNO3", "K_SO2", "K_HSO3", "K_CO2", "K_HCO3", "K_HSO4")
_DTYPES = {torch.float32: 0, torch.float64: 1}


def acidity_terms(conc, K):
    """the electroneutrality residual's factors that do not depend on H,
    with the two weak diprotic acids, S(IV) and C(IV), stacked (2, n): the
    solve evaluates them once, not once an iteration"""
    return {
        "N_mIII": conc["N_mIII"],
        "K_NH3": K["K_NH3"],
        "nitric": conc["N_V"] * K["K_HNO3"],
        "K_HNO3": K["K_HNO3"],
        "diprotic": torch.stack([
            conc["S_IV"] * K["K_SO2"], conc["C_IV"] * K["K_CO2"]
        ]),
        "K1": torch.stack([K["K_SO2"], K["K_CO2"]]),
        "twice_K2": torch.stack([2 * K["K_HSO3"], 2 * K["K_HCO3"]]),
        "K1_K2": torch.stack([
            K["K_SO2"] * K["K_HSO3"], K["K_CO2"] * K["K_HCO3"]
        ]),
        "S_VI": conc["S_VI"],
        "twice_K_HSO4": 2 * K["K_HSO4"],
        "K_HSO4": K["K_HSO4"],
    }


def acidity_residual(H, t, K_H2O):
    """``acidity_minfun`` from ``acidity_terms``: the reference's
    operations in the reference's order, those that do not depend on H
    taken from ``t``"""
    ammonia = (t["N_mIII"] * H * t["K_NH3"]) / (K_H2O + t["K_NH3"] * H)
    nitric = t["nitric"] / (H + t["K_HNO3"])
    sulfous, carbonic = (
        t["diprotic"] * (H + t["twice_K2"]) / (H * H + H * t["K1"] + t["K1_K2"])
    )
    water = K_H2O / H
    sulfuric = t["S_VI"] * (H + t["twice_K_HSO4"]) / (H + t["K_HSO4"])
    return H + ammonia - (nitric + sulfous + water + sulfuric + carbonic)


def equilibrate_H_reference(*, conc, K_drop, K_H2O, H_min, H_max,
                            iters=PH_ITERATIONS):
    """plain twin: per-droplet hydrogen-ion concentration from
    electroneutrality. The residual increases with H, so a bisection in log
    H over the host floats [H_min, H_max], ``iters`` times, and the last
    bracket's midpoint"""
    terms = acidity_terms(conc, K_drop)
    lo = torch.full_like(conc["S_VI"], math.log(H_min))
    hi = torch.full_like(conc["S_VI"], math.log(H_max))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_lo = acidity_residual(torch.exp(mid), terms, K_H2O) > 0
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
    return torch.exp(0.5 * (lo + hi))


def equilibrate_H(*, conc, K_drop, K_H2O, H_min, H_max, iters=PH_ITERATIONS):
    """per-drop H from the concentrations ``conc`` (S_VI, S_IV, C_IV, N_V,
    N_mIII) and the equilibrium constants ``K_drop`` (K_NH3, K_HNO3, K_SO2,
    K_HSO3, K_CO2, K_HCO3, K_HSO4), float32 or float64 tensors; ``K_H2O``,
    ``H_min`` and ``H_max`` host floats. CPU tensors take the plain twin;
    CUDA tensors of one shape, dtype and device launch the Hopper kernel
    once; any other device or dtype raises"""
    rows = [conc[k] for k in CONC_ROWS] + [K_drop[k] for k in K_ROWS]
    for row in rows:
        if row.dtype not in _DTYPES:
            raise TypeError(
                f"equilibrate_H: float32 or float64 rows, not {row.dtype}"
            )
    devices = {row.device for row in rows}
    if all(d.type == "cpu" for d in devices):
        return equilibrate_H_reference(
            conc=conc, K_drop=K_drop, K_H2O=K_H2O, H_min=H_min, H_max=H_max,
            iters=iters,
        )
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"equilibrate_H: no kernel for devices {devices}")
    if len({row.dtype for row in rows}) != 1:
        raise TypeError("equilibrate_H kernel: rows of one dtype expected,"
                        f" got {sorted({str(r.dtype) for r in rows})}")
    if len({row.shape for row in rows}) != 1:
        raise ValueError("equilibrate_H kernel: rows of one shape expected,"
                         f" got {sorted({tuple(r.shape) for r in rows})}")
    return _launch(rows, K_H2O, H_min, H_max, iters)


# launches of the kernel
equilibrate_H.launches = 0
profiling.counters(equilibrate_H, "launches")


@functools.cache
def library():
    """the built library with its entry points' C signatures declared"""
    lib = _build.load("chemistry")
    vp, dbl = ctypes.c_void_p, ctypes.c_double
    lib.pysdm_equilibrate_H.argtypes = [
        vp, ctypes.c_int, ctypes.c_longlong, dbl, dbl, dbl, ctypes.c_int, vp,
        vp,
    ]
    lib.pysdm_equilibrate_H.restype = ctypes.c_int
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(rows, K_H2O, H_min, H_max, iters):
    rows = [row.contiguous() for row in rows]
    out = torch.empty_like(rows[0])
    n = out.numel()
    if n == 0:
        return out
    lib = library()
    pointers = (ctypes.c_void_p * len(rows))(*(row.data_ptr() for row in rows))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pysdm_equilibrate_H(
            pointers, _DTYPES[out.dtype], n, float(K_H2O),
            math.log(H_min), math.log(H_max), int(iters), out.data_ptr(),
            stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"pH solve launch failed: {msg} ({err})")
    equilibrate_H.launches += 1
    return out
