"""SDM coalescence substeps: the Hopper kernels ``csrc/collision_mirror.cu``
(K1, one cell) and ``csrc/collision_adjacent.cu`` (K2, many cells), their
wrappers and their plain PyTorch twins.

K1 replaces the TPU kernel ``fused_coalesce_mirror_blocks``
(``pysdm_tpu/ops/pallas/collision.py:582``, body ``_mk_mirror_block_kernel``
``:422``). One substep under the mirror croupier: slot o pairs with
po = (K - o) mod N; dead slots and fixed points are masked; j is the larger
multiplicity, ties go to the leader (po > o); with kn = kernel(o, po) *
scale, the kernel evaluated on the attribute rows it reads (``KERNEL_ROWS``,
in the order of their names, as the TPU kernel stacks them), and
u = ``_u01_hash(seed, min(o, po))``,
gamma = min(max(ceil(xi_j kn - u), 0) capped at 2^31 - 128, floor(xi_j/xi_k)),
then the Shima update with the equal split of an exhausted j, and the sums of
the collision rate, rate deficit and coalescence rate over pair leaders.

The port takes these semantics at every N. The JAX package does so only at
N % 32768 == 0; at other N it runs ``fused_coalesce_mirror``, which draws
u01 rows with ``jax.random.uniform``, so there the two packages consume
different random streams.

gamma is exact here (native int64 division). The TPU kernel walks an f32
quotient estimate +-5 steps, which misses the exact floor when
floor(xi_j/xi_k) is above ~2^26 and below the cap; see ROADMAP.md,
"large-quotient γ".

The kernel takes one thread per pair (``mirror_pairs`` is its map from a
pair's index to its slots), computes the pair once and writes both slots,
and sums the rates in the same launch (the last block to finish adds the
blocks' partials in a fixed order). Bound on the card: bytes, 32 + 4 n_attr
B per slot per substep with two float32 extensive rows (each input read
once, each output written once): 36 B with Golovin's one attribute row, 40 B
with the geometric kernels' two.

K2 replaces the TPU kernel ``fused_coalesce``
(``pysdm_tpu/ops/pallas/collision.py:721``, body ``_coalesce_kernel``
``:103-217``): the same update over the cell-sorted state of the sort
croupier, slot p pairing with p + 1 where ``is_first[p]``; kernel value
times normalization (``kernnorm``) and the gamma draw (``rand``) come as
rows, read at the pair's leader; the rates come back as per-slot rows for
the per-cell sums. gamma is exact here too. Bound on the card: bytes, ~57 B
per slot per substep with three float32 extensive rows.
"""

import ctypes
import functools

import torch

from . import _build

# collision kernels K1 and K5 (``ops/cuda/breakup.py``) evaluate in their
# bodies (``csrc/sdm_pair.cuh`` ``kernel_value``;
# ``dynamics/collisions/collision_kernels.py`` sets ``kernel_id``), and the
# attribute rows each reads, in the order of their names
GOLOVIN, CONSTANT_K, LINEAR, GEOMETRIC, SIMPLE_GEOMETRIC = 0, 1, 2, 3, 4
KERNEL_ROWS = {
    GOLOVIN: ("volume",),
    CONSTANT_K: ("volume",),
    LINEAR: ("volume",),
    GEOMETRIC: ("radius", "relative fall velocity"),
    SIMPLE_GEOMETRIC: ("area", "radius"),
}
MIRROR_KERNELS = tuple(KERNEL_ROWS)

_BIG = float(2**31 - 128)
_M32 = 0xFFFFFFFF
# (device index, stream, n) -> [scratch buffer, launches]: K1's ticket
# counter and per-block partial sums (``_build.scratch``)
_SCRATCH = {}
_SCRATCH_ENTRIES = 64


def mirror_pairs(n, K):
    """the map the mirror kernels (K1, K5) take from a pair's index to its
    slots, as ``csrc/sdm_pair.cuh`` ``mirror_pair`` and
    ``mirror_self_slot`` compute it: (leaders, partners, self-paired slots)
    as int64 tensors. Slot o pairs with (K - o) mod n; pair p has the p-th
    leader o < (K - o) mod n, the leaders in two runs, [0, (K + 1) // 2)
    with partner K - o and from K + 1 on, (n - K - 1) // 2 of them, with
    partner n + K - o. The slots K / 2 and (n + K) / 2, where they are
    integers, pair with themselves. Nothing on the main path calls it; the
    tests hold it against the croupier's definition."""
    first = (K + 1) // 2
    p = torch.arange(first + (n - K - 1) // 2, dtype=torch.int64)
    leaders = torch.where(p < first, p, K + 1 + (p - first))
    partners = torch.where(p < first, K - p, n + K - leaders)
    selves = torch.tensor(
        [twice // 2 for twice in (K, n + K) if twice % 2 == 0],
        dtype=torch.int64,
    )
    return leaders, partners, selves


def _mul_u32(h, c):
    """(h * c) mod 2^32 for int64 tensors h < 2^32 and a constant c < 2^32,
    through 16-bit limbs of c, so no int64 product overflows"""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u01_hash(seed, pair_id):
    """pair-keyed u01 draw, bit-exact with the JAX package's ``_u01_hash``
    (murmur3 fmix32 twice over seed ^ pair_id * 0x9E3779B9): uint32
    arithmetic carried in int64 with a mask after every multiply"""
    h = _mul_u32(pair_id.to(torch.int64), 0x9E3779B9) ^ (int(seed) & _M32)
    for _ in range(2):
        h = h ^ (h >> 16)
        h = _mul_u32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = _mul_u32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * 2.0**-24


def _u32_to_f32(x):
    """the TPU kernel's u32 -> f32 conversion: f32(x >> 1) * 2 + f32(x & 1)"""
    return (x >> 1).to(torch.float32) * 2.0 + (x & 1).to(torch.float32)


def _u64_to_f32(x):
    """the TPU kernel's u64 -> f32 conversion: f32(hi) * 2^32 + f32(lo);
    rounds differently from a direct cast once x > 2^24"""
    return _u32_to_f32(x >> 32) * 2.0**32 + _u32_to_f32(x & _M32)


def kernel_value(kernel_id, p0, p1, attrs, attrs_b):
    """collision kernel in float32 from the attribute rows of both slots
    (dicts by name, ``KERNEL_ROWS``), in the order the CUDA kernels round
    it (``csrc/sdm_pair.cuh`` ``kernel_value``)"""
    like = attrs[KERNEL_ROWS[kernel_id][0]]
    p0 = torch.tensor(p0, dtype=torch.float32, device=like.device)
    p1 = torch.tensor(p1, dtype=torch.float32, device=like.device)
    if kernel_id in (GEOMETRIC, SIMPLE_GEOMETRIC):
        diff = "relative fall velocity" if kernel_id == GEOMETRIC else "area"
        r_sum = attrs["radius"] + attrs_b["radius"]
        return p0 * (r_sum * r_sum) * torch.abs(attrs[diff] - attrs_b[diff])
    va, vb = attrs["volume"], attrs_b["volume"]
    if kernel_id == GOLOVIN:
        return p0 * (va + vb)
    if kernel_id == CONSTANT_K:
        return p0 + 0.0 * va
    return p0 + p1 * (va + vb)  # LINEAR


def coalesce_mirror_reference(
    mult, ext, attr, kernel_id, params, scale, K, seed
):
    """plain PyTorch twin of the CUDA kernel (same function, same f32
    rounding order). Returns (mult_new, ext_new, rate, deficit, coal) with
    the rates as 0-d float32 sums."""
    n = mult.shape[0]
    o = torch.arange(n, dtype=torch.int64, device=mult.device)
    po = torch.remainder(int(K) - o, n)
    a = mult
    b = mult[po]
    in_pair = (a != 0) & (b != 0) & (po != o)
    isf = in_pair & (po > o)
    a_is_j = torch.where(isf, a >= b, a > b)
    mj = torch.where(a_is_j, a, b)
    mk = torch.where(a_is_j, b, a)

    attrs = dict(zip(KERNEL_ROWS[kernel_id], attr))
    attrs_b = {name: row[po] for name, row in attrs.items()}
    kn = kernel_value(kernel_id, *params, attrs, attrs_b) * scale
    u = _u01_hash(seed, torch.minimum(o, po))
    gamma_f = torch.ceil(_u64_to_f32(mj) * kn - u).clamp_min(0.0)
    gamma_f = torch.where(in_pair, gamma_f, 0.0)
    cap = gamma_f.clamp_max(_BIG).to(torch.int64)
    g = torch.minimum(cap, mj // mk.clamp_min(1))
    g = torch.where(in_pair, g, 0)
    gf = _u32_to_f32(g)

    nn = mj - g * mk
    split = in_pair & (nn == 0) & (g > 0)
    half = mk // 2
    mj_new = torch.where(split, half, nn)
    mk_new = torch.where(split, mk - half, mk)
    i_am_j = in_pair & a_is_j
    mult_new = torch.where(in_pair, torch.where(i_am_j, mj_new, mk_new), a)

    e_other = ext[:, po]
    ej = torch.where(i_am_j, ext, e_other)
    ek = torch.where(i_am_j, e_other, ext)
    merged = ek + gf.to(ext.dtype) * ej
    e_new = torch.where(i_am_j, torch.where(split, merged, ej), merged)
    ext_new = torch.where(in_pair, e_new, ext)

    mk_f = _u64_to_f32(mk)
    rate = torch.where(isf, gf * mk_f, 0.0).sum()
    deficit = torch.where(isf, (gamma_f - gf) * mk_f, 0.0).sum()
    return mult_new, ext_new, rate, deficit, rate.clone()


def _check(mult, ext, attr, kernel_id, scale, K, seed):
    n = mult.shape[0]
    device = mult.device
    if mult.dtype != torch.int64 or mult.dim() != 1:
        raise TypeError("mult: int64 (n,) expected")
    if ext.dim() != 2 or ext.shape[1] != n or ext.dtype not in (
        torch.float32, torch.float64
    ):
        raise TypeError("ext: float32/float64 (n_ext, n) expected")
    if kernel_id not in MIRROR_KERNELS:
        raise ValueError(f"unknown collision kernel id {kernel_id}")
    n_attr = len(KERNEL_ROWS[kernel_id])
    if attr.dtype != torch.float32 or attr.shape != (n_attr, n):
        raise TypeError(
            f"attr: float32 ({n_attr}, n) expected, the rows"
            f" {KERNEL_ROWS[kernel_id]}"
        )
    if scale.dtype != torch.float32 or scale.shape != (1,):
        raise TypeError("scale: float32 (1,) expected")
    for name, t in (("ext", ext), ("attr", attr), ("scale", scale)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, mult on {device}")
    if not 0 <= int(K) < n:
        raise ValueError(f"K={K} outside [0, {n})")
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed={seed} is not a uint32")


def coalesce_mirror(mult, ext, attr, kernel_id, params, scale, K, seed):
    """one mirror-croupier coalescence substep. CPU tensors take the plain
    twin; CUDA tensors launch the Hopper kernel (or raise). Returns
    (mult_new, ext_new, rate, deficit, coal) with 0-d float32 rate sums.

    mult: int64 (n,); ext: (n_ext, n) float32/float64; kernel_id, params:
    the collision kernel (one of ``MIRROR_KERNELS``) and its two float
    parameters; attr: float32 (n_attr, n), the rows ``KERNEL_ROWS[kernel_id]``
    in that order; scale: float32 (1,), the
    normalization times the substep's probability scale; K in [0, n); seed:
    uint32."""
    _check(mult, ext, attr, kernel_id, scale, K, seed)
    if mult.device.type == "cpu":
        return coalesce_mirror_reference(
            mult, ext, attr, kernel_id, params, scale, K, seed
        )
    if mult.device.type != "cuda":
        raise ValueError(f"no kernel for device {mult.device}")
    return _launch(mult, ext, attr, kernel_id, params, scale, K, seed)


coalesce_mirror.launches = 0


@functools.cache
def library():
    """the built library with every entry point's C signature declared
    (each pointer and the stream as c_void_p)"""
    lib = _build.load("collision_mirror")
    vp = ctypes.c_void_p
    lib.pysdm_coalesce_mirror.argtypes = [
        vp, vp, ctypes.c_int, ctypes.c_int, vp, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, vp, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_uint, vp, vp, vp, vp, vp,
    ]
    lib.pysdm_coalesce_mirror.restype = ctypes.c_int
    lib.pysdm_coalesce_mirror_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.pysdm_coalesce_mirror_scratch_bytes.restype = ctypes.c_longlong
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(mult, ext, attr, kernel_id, params, scale, K, seed):
    lib = library()
    n = mult.shape[0]
    mult = mult.contiguous()
    ext = ext.contiguous()
    attr = attr.contiguous()
    mult_out = torch.empty_like(mult)
    ext_out = torch.empty_like(ext)
    sums = torch.empty(3, dtype=torch.float32, device=mult.device)
    with torch.cuda.device(mult.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _build.scratch(
            _SCRATCH, (mult.device.index, stream, n),
            lambda: lib.pysdm_coalesce_mirror_scratch_bytes(n), mult.device,
            _SCRATCH_ENTRIES,
        )[0]
        err = lib.pysdm_coalesce_mirror(
            mult.data_ptr(), ext.data_ptr(), int(ext.dtype == torch.float64),
            ext.shape[0], attr.data_ptr(), attr.shape[0], int(kernel_id),
            float(params[0]), float(params[1]), scale.data_ptr(), n, int(K),
            int(seed), mult_out.data_ptr(), ext_out.data_ptr(),
            scratch.data_ptr(), sums.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"collision_mirror launch failed: {msg} ({err})")
    coalesce_mirror.launches += 1
    return mult_out, ext_out, sums[0], sums[1], sums[2]


def coalesce_adjacent_reference(mult, ext, kernnorm, rand, is_first):
    """plain PyTorch twin of K2 (same function, same f32 rounding order).
    Returns (mult_new, ext_new, rate, deficit, coal) with per-slot float32
    rate rows, nonzero only at pair leaders (coal is rate)."""
    n = mult.shape[0]
    p = torch.arange(n, dtype=torch.int64, device=mult.device)
    isf = is_first
    isf_prev = torch.cat([isf.new_zeros(1), isf[:-1]])
    in_pair = isf | isf_prev
    partner = torch.where(isf, p + 1, p - 1).clamp(0, n - 1)
    lead = torch.where(isf, p, p - 1).clamp(0, n - 1)
    a = mult
    b = mult[partner]
    a_is_j = torch.where(isf, a >= b, a > b)
    mj = torch.where(a_is_j, a, b)
    mk = torch.where(a_is_j, b, a)

    kn = kernnorm.to(torch.float32)[lead]
    u = rand.to(torch.float32)[lead]
    gamma_f = torch.ceil(_u64_to_f32(mj) * kn - u).clamp_min(0.0)
    gamma_f = torch.where(in_pair, gamma_f, 0.0)
    cap = gamma_f.clamp_max(_BIG).to(torch.int64)
    g = torch.minimum(cap, mj // mk.clamp_min(1))
    g = torch.where(in_pair, g, 0)
    gf = _u32_to_f32(g)

    nn = mj - g * mk
    split = in_pair & (nn == 0) & (g > 0)
    half = mk // 2
    mj_new = torch.where(split, half, nn)
    mk_new = torch.where(split, mk - half, mk)
    i_am_j = in_pair & a_is_j
    mult_new = torch.where(in_pair, torch.where(i_am_j, mj_new, mk_new), a)

    e_other = ext[:, partner]
    ej = torch.where(i_am_j, ext, e_other)
    ek = torch.where(i_am_j, e_other, ext)
    merged = ek + gf.to(ext.dtype) * ej
    e_new = torch.where(i_am_j, torch.where(split, merged, ej), merged)
    ext_new = torch.where(in_pair, e_new, ext)

    mk_f = _u64_to_f32(mk)
    rate = torch.where(isf, gf * mk_f, 0.0)
    deficit = torch.where(isf, (gamma_f - gf) * mk_f, 0.0)
    return mult_new, ext_new, rate, deficit, rate


def _check_adjacent(mult, ext, kernnorm, rand, is_first):
    n = mult.shape[0]
    if mult.dtype != torch.int64 or mult.dim() != 1:
        raise TypeError("mult: int64 (n,) expected")
    if ext.dim() != 2 or ext.shape[1] != n or ext.dtype not in (
        torch.float32, torch.float64
    ):
        raise TypeError("ext: float32/float64 (n_ext, n) expected")
    if is_first.dtype != torch.bool or is_first.shape != (n,):
        raise TypeError("is_first: bool (n,) expected")
    for name, t in (("kernnorm", kernnorm), ("rand", rand)):
        if t.shape != (n,) or not t.dtype.is_floating_point:
            raise TypeError(f"{name}: float (n,) expected")
    for name, t in (
        ("ext", ext), ("kernnorm", kernnorm), ("rand", rand),
        ("is_first", is_first),
    ):
        if t.device != mult.device:
            raise ValueError(f"{name} is on {t.device}, mult on {mult.device}")


def coalesce_adjacent(mult, ext, kernnorm, rand, is_first):
    """one sort-croupier coalescence substep over the cell-sorted state.
    CPU tensors take the plain twin; CUDA tensors launch the Hopper kernel
    (or raise). Returns (mult_new, ext_new, rate, deficit, coal) with
    per-slot float32 rate rows (coal is rate).

    mult: int64 (n,); ext: (n_ext, n) float32/float64; kernnorm: kernel
    value times the cell's normalization and probability scale, valid at
    pair leaders; rand: the gamma u01 draws, read at pair leaders (both
    cast to float32); is_first: bool (n,), slot p leads the pair (p, p+1)."""
    _check_adjacent(mult, ext, kernnorm, rand, is_first)
    if mult.device.type == "cpu":
        return coalesce_adjacent_reference(mult, ext, kernnorm, rand, is_first)
    if mult.device.type != "cuda":
        raise ValueError(f"no kernel for device {mult.device}")
    return _launch_adjacent(mult, ext, kernnorm, rand, is_first)


coalesce_adjacent.launches = 0


@functools.cache
def library_adjacent():
    """K2's built library with its entry point's C signature declared"""
    lib = _build.load("collision_adjacent")
    vp = ctypes.c_void_p
    lib.pysdm_coalesce_adjacent.argtypes = [
        vp, vp, ctypes.c_int, ctypes.c_int, vp, vp, vp, ctypes.c_longlong,
        vp, vp, vp, vp, vp,
    ]
    lib.pysdm_coalesce_adjacent.restype = ctypes.c_int
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch_adjacent(mult, ext, kernnorm, rand, is_first):
    lib = library_adjacent()
    n = mult.shape[0]
    mult = mult.contiguous()
    ext = ext.contiguous()
    kernnorm = kernnorm.to(torch.float32).contiguous()
    rand = rand.to(torch.float32).contiguous()
    is_first = is_first.contiguous()
    mult_out = torch.empty_like(mult)
    ext_out = torch.empty_like(ext)
    rate = torch.empty(n, dtype=torch.float32, device=mult.device)
    deficit = torch.empty_like(rate)
    if n == 0:
        return mult_out, ext_out, rate, deficit, rate
    with torch.cuda.device(mult.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pysdm_coalesce_adjacent(
            mult.data_ptr(), ext.data_ptr(), int(ext.dtype == torch.float64),
            ext.shape[0], kernnorm.data_ptr(), rand.data_ptr(),
            is_first.data_ptr(), n, mult_out.data_ptr(), ext_out.data_ptr(),
            rate.data_ptr(), deficit.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"collision_adjacent launch failed: {msg} ({err})")
    coalesce_adjacent.launches += 1
    return mult_out, ext_out, rate, deficit, rate
