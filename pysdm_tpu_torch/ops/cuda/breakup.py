"""Collision with breakup under the mirror croupier: the Hopper kernel
``csrc/collision_breakup.cu`` (K5), its wrapper and its plain PyTorch twin.

K5 replaces the TPU kernel ``fused_breakup_mirror_blocks``
(``pysdm_tpu/ops/pallas/breakup.py:340``, body ``_mk_breakup_kernel``
``:133``). One substep of bounce, coalescence and breakup over every pair of
one cell: slot o pairs with po = (K - o) mod N (dead slots and fixed points
masked, j the larger multiplicity, ties to the leader po > o); three
pair-keyed draws u = ``_u01_hash(seed ^ mix, min(o, po))`` with the mixes 0
(gamma), 0xA5A5A5A5 (process) and 0x3C3C3C3C (fragment);
gamma = min(max(ceil(xi_j kn - u), 0) capped at 2^31 - 128, floor(xi_j/xi_k))
with kn = kernel * scale; the pair bounces if u_proc > Ec + (1 - Ec) Eb,
coalesces if u_proc < Ec (the Shima update, exact in int64), and else breaks
up: the de Jong/Mackay transfer in float32 log space with +-4 correction
walks (``transfer_closed_form_f32``), multiplicities rounded to integers with
a mass-conserving rescale of the extensive rows. Five float32 sums over the
pair leaders: collision rate, its deficit, coalescence rate, breakup rate
and breakup deficit.

The collision kernel, Ec, Eb and the fragment mass are evaluated in the
kernel's body from ids and float parameters (``PairFunctions``); the
functions of the JAX package's ``pallas_safe`` set have ids:
kernels ``Golovin``, ``ConstantK``, ``Linear``, ``Geometric``,
``SimpleGeometric`` (the body K1 evaluates too, ``csrc/sdm_pair.cuh``
``kernel_value``); Ec
``ConstEc``, ``Berry1967``; Eb ``ConstEb``; fragment mass ``AlwaysN``,
``ConstantMass``, ``Exponential`` (and its alias ``ExponFrag``).

Extensive rows pass through float32 on every substep, as in the TPU kernel
(``breakup.py:370``, ``:449``), at every slot and whatever the state's
dtype; the wrapper hands them back in the state's dtype. gamma is an exact
int64 division, where the TPU kernel walks an f32 quotient estimate +-5
steps (ROADMAP, "large-quotient γ"). The port takes these semantics at every N; the JAX
package takes K5 only at N % 32768 == 0.

The kernel takes one thread per pair (``collision.mirror_pairs``), computes
the pair once and writes both slots, evaluates Ec, Eb, the fragment mass
and the transfer only where gamma > 0 and sums the rates in the same launch
(the last block to finish adds the blocks' partials in a fixed order).

The twin follows the TPU kernel's float32 rounding order; its scalar
constants are float32 tensors, so every division is a true division on the
card too (torch turns ``tensor / python_scalar`` into a reciprocal multiply
on CUDA). Integer powers are repeated products, as XLA's ``integer_pow``.
"""

import collections
import ctypes
import functools

import torch

from ...utils import profiling
from . import _build
from .collision import (
    _BIG,
    _M32,
    _SCRATCH_ENTRIES,
    _const,
    berry_1967_linear_collection_efficiency,
    KERNEL_ROWS,
    MIRROR_KERNELS,
    SIMPLE_GEOMETRIC,
    _u01_hash,
    _u32_to_f32,
    _u64_to_f32,
    kernel_value,
)

# coalescence efficiencies, breakup efficiencies and fragmentation functions
# K5 evaluates in its body (``dynamics/collisions/*`` set ``kernel_id``)
EC_CONST, EC_BERRY1967 = 0, 1
EB_CONST = 0
FRAG_ALWAYS_N, FRAG_CONSTANT_MASS, FRAG_EXPONENTIAL = 0, 1, 2
BREAKUP_KERNELS = MIRROR_KERNELS

# the four functions of a breakup substep: ids and float parameters (a
# kernel's two; Ec's and Eb's value for the constant ones; a fragmentation
# function's: AlwaysN (n,), ConstantMass (c,), Exponential (scale, vmin,
# nfmax or -1 for none, rho_w))
class PairFunctions(
    collections.namedtuple(
        "PairFunctions",
        "kernel kernel_params ec ec_params eb eb_params frag frag_params",
    )
):
    @classmethod
    def of(cls, kernel, ec, eb, frag):
        """from the four function objects' ``kernel_id`` and
        ``cuda_params``"""
        return cls(*(
            value
            for function in (kernel, ec, eb, frag)
            for value in (function.kernel_id, tuple(function.cuda_params))
        ))


# Berry 1967's fit of the hydrodynamic collection efficiency
# (``pysdm_tpu/dynamics/collisions/coalescence_efficiencies.py:33``)
BERRY_1967_PARAMS = (1, 1, -27, 1.65, -58, 1.9, 15, 1.13, 16.7, 1, 0.004, 4, 8)

_SEED_PROCESS = 0xA5A5A5A5
_SEED_FRAGMENT = 0x3C3C3C3C
# (device index, stream, n) -> [scratch buffer, launches]: K5's ticket
# counter and per-block partial sums (``_build.scratch``)
_SCRATCH = {}


def berry_1967_efficiency(radius_a, radius_b):
    """Ec of ``Berry1967``: the fit at (max, min) radius, clipped to [0, 1]"""
    Y = berry_1967_linear_collection_efficiency(
        BERRY_1967_PARAMS,
        torch.maximum(radius_a, radius_b), torch.minimum(radius_a, radius_b),
    )
    return torch.clamp(Y, 0.0, 1.0)


def fragment_mass(frag_id, params, mass_a, mass_b, u01):
    """mass of one fragment for the pair (a, b) and the fragment draw u01
    (``breakup_fragmentations.py`` ``pairwise(...)[1]``)"""
    c = functools.partial(_const, like=mass_a)
    mass_sum = mass_a + mass_b
    if frag_id == FRAG_ALWAYS_N:
        return mass_sum / c(params[0])
    if frag_id == FRAG_CONSTANT_MASS:
        return torch.zeros_like(mass_sum) + c(params[0])
    if frag_id == FRAG_EXPONENTIAL:
        scale, vmin, nfmax, rho_w = params
        frag_volume = c(-scale) * torch.log(torch.maximum(c(1.0) - u01, c(1e-30)))
        frag_volume = torch.maximum(frag_volume, c(vmin))
        mass = frag_volume * c(rho_w)
        if nfmax > 0:
            # the JAX package's maximum(mass, 1e-300) is 0 in float32
            n_fragment = mass_sum / torch.maximum(mass, c(1e-300))
            n_fragment = torch.minimum(n_fragment, c(nfmax))
            mass = mass_sum / n_fragment
        return mass
    raise ValueError(f"unknown fragmentation function id {frag_id}")


def fragmentation_limiters_f32(frag_mass, mass_sum):
    """NaN or non-positive fragments take the whole pair's mass, a fragment
    is at most the pair's mass, a massless pair gets 1
    (``pysdm_tpu/ops/pallas/breakup.py:122-130``)"""
    one = _const(1.0, mass_sum)
    fm = torch.where(torch.isnan(frag_mass) | (frag_mass <= 0), mass_sum, frag_mass)
    fm = torch.minimum(fm, mass_sum)
    return torch.where(mass_sum <= 0, one, fm)


def transfer_closed_form_f32(gamma_f, mult_j, mult_k, mass_j, mass_k, fm, max_mult):
    """the de Jong/Mackay transfer of up to ``gamma_f`` breakup events in
    closed form, float32 (``pysdm_tpu/ops/pallas/breakup.py:69-119``): the
    largest g whose multiplicities fit (new xi_k <= max_mult, taken from j
    <= xi_j), found from log-space estimates and +-4 correction walks;
    inf or NaN in a candidate reads as invalid. Returns (take_from_j,
    new_mult_k, g)."""
    c = functools.partial(_const, like=mass_j)
    one, zero, tiny = c(1.0), c(0.0), c(1e-30)
    fm = torch.maximum(fm, tiny)
    alpha = (mass_j + mass_k) / fm
    beta = mass_j / fm
    beta_pos = beta > 0
    beta_safe = torch.where(beta_pos, beta, one)
    log1pb = torch.log1p(beta_safe)
    mk = mult_k
    alpha_safe = torch.maximum(alpha, tiny)

    def pair_values(g):
        p = torch.exp((g - one) * log1pb)
        nmk = mk * alpha * p
        tfj = torch.where(
            beta_pos,
            mk * (one + alpha * (p - one) / beta_safe),
            mk * (one + (g - one) * alpha),
        )
        return nmk, tfj

    def valid(g):
        nmk, tfj = pair_values(g)
        return (g >= one) & (g <= gamma_f) & (nmk <= max_mult) & (tfj <= mult_j)

    g1 = torch.floor(torch.log(max_mult / (mk * alpha_safe)) / log1pb) + one
    rhs2 = one + beta_safe * (mult_j / mk - one) / alpha_safe
    g2 = torch.where(
        beta_pos,
        torch.floor(torch.log(torch.maximum(rhs2, one)) / log1pb) + one,
        torch.floor((mult_j / mk - one) / alpha_safe) + one,
    )
    g = torch.minimum(torch.minimum(g1, g2), gamma_f)
    g = torch.minimum(torch.maximum(g, zero), gamma_f)
    g = torch.where(torch.isnan(g), zero, g)
    for _ in range(4):
        g = torch.where(valid(g + one), g + one, g)
    for _ in range(4):
        g = torch.where(valid(g) | (g <= 0), g, g - one)
    g = torch.maximum(g, zero)
    nmk_g, tfj_g = pair_values(torch.maximum(g, one))
    take_from_j = torch.where(g >= 1, tfj_g, zero)
    new_mult_k = torch.where(g >= 1, nmk_g, mk)
    return take_from_j, new_mult_k, g


def _efficiencies(functions, attrs, attrs_b):
    like = next(iter(attrs.values()))
    if functions.ec == EC_BERRY1967:
        ec = berry_1967_efficiency(attrs["radius"], attrs_b["radius"])
    elif functions.ec == EC_CONST:
        ec = _const(functions.ec_params[0], like)
    else:
        raise ValueError(f"unknown coalescence efficiency id {functions.ec}")
    if functions.eb != EB_CONST:
        raise ValueError(f"unknown breakup efficiency id {functions.eb}")
    return ec, _const(functions.eb_params[0], like)


def coalesce_breakup_mirror_reference(
    mult, ext, wm_index, attrs, functions, scale, K, seed, max_multiplicity,
    processes=None,
):
    """plain PyTorch twin of K5 (same function, same float32 rounding
    order). Returns (mult_new, ext_new, collision rate, rate deficit,
    coalescence rate, breakup rate, breakup deficit) with the rates as 0-d
    float32 sums. A dict ``processes`` receives the slots that coalesced
    and broke up (bool rows "coalescence", "breakup")."""
    n = mult.shape[0]
    device = mult.device
    c = functools.partial(_const, like=scale)
    zero = c(0.0)
    o = torch.arange(n, dtype=torch.int64, device=device)
    po = torch.remainder(int(K) - o, n)
    a = mult
    b = mult[po]
    in_pair = (a != 0) & (b != 0) & (po != o)
    isf = in_pair & (po > o)
    a_is_j = torch.where(isf, a >= b, a > b)
    mj = torch.where(a_is_j, a, b)
    mk = torch.where(a_is_j, b, a)

    attrs_b = {name: row[po] for name, row in attrs.items()}
    kn = kernel_value(
        functions.kernel, *functions.kernel_params, attrs, attrs_b
    ) * scale
    Ec, Eb = _efficiencies(functions, attrs, attrs_b)
    pair_id = torch.minimum(o, po)
    u_gamma = _u01_hash(seed, pair_id)
    u_proc = _u01_hash(int(seed) ^ _SEED_PROCESS, pair_id)
    u_frag = _u01_hash(int(seed) ^ _SEED_FRAGMENT, pair_id)

    mj_f = _u64_to_f32(mj)
    gamma_f = torch.maximum(torch.ceil(mj_f * kn - u_gamma), zero)
    gamma_f = torch.where(in_pair, gamma_f, zero)
    cap = gamma_f.clamp_max(_BIG).to(torch.int64)
    g = torch.minimum(cap, mj // mk.clamp_min(1))
    g = torch.where(in_pair, g, 0)
    gf = _u32_to_f32(g)
    mk_f = _u64_to_f32(mk)

    # process: bounce if u > Ec + (1 - Ec) Eb, coalesce if u < Ec, else
    # break up
    active = in_pair & (g > 0)
    bouncing = u_proc - (Ec + (c(1.0) - Ec) * Eb) > 0
    do_coal = active & ~bouncing & (u_proc - Ec < 0)
    do_break = active & ~bouncing & ~do_coal
    i_am_j = in_pair & a_is_j
    if processes is not None:
        processes.update(coalescence=do_coal, breakup=do_break)

    # coalescence: exact in int64, an exhausted j takes half of k
    nn = mj - g * mk
    split = do_coal & (nn == 0)
    half = mk // 2
    coal_mult = torch.where(
        i_am_j, torch.where(split, half, nn), torch.where(split, mk - half, mk)
    )

    # breakup, float32
    e_own = ext.to(torch.float32)
    e_oth = e_own[:, po]
    ej = torch.where(i_am_j, e_own, e_oth)
    ek = torch.where(i_am_j, e_oth, e_own)
    mass_j = ej[wm_index].abs()
    mass_k = ek[wm_index].abs()
    frag = fragment_mass(
        functions.frag, functions.frag_params, e_own[wm_index].abs(),
        e_oth[wm_index].abs(), u_frag,
    )
    fm = fragmentation_limiters_f32(frag, mass_j + mass_k)
    take, nmk, gjk = transfer_closed_form_f32(
        torch.where(do_break, gf, zero), mj_f, torch.maximum(mk_f, c(1.0)),
        mass_j, mass_k, fm, c(float(max_multiplicity)),
    )
    ek_mix = (ek * mk_f + take * ej) / torch.maximum(nmk, c(1e-30))
    deplete = take >= mj_f
    nj = torch.where(deplete, nmk * c(0.5), mj_f - take)
    nk = torch.where(deplete, nmk * c(0.5), nmk)
    ej_mix = torch.where(deplete, ek_mix, ej)
    bj = torch.maximum(torch.round(nj), c(1.0))
    bk = torch.maximum(torch.round(nk), c(1.0))
    brk_ext = torch.where(i_am_j, ej_mix * (nj / bj), ek_mix * (nk / bk))
    brk_mult = torch.where(i_am_j, bj, bk)
    brk_mult = torch.where(do_break, brk_mult, zero).to(torch.int64)

    mult_new = torch.where(do_break, brk_mult, torch.where(do_coal, coal_mult, a))
    merged = ek + gf * ej
    coal_ext = torch.where(i_am_j, torch.where(split, merged, ej), merged)
    ext_new = torch.where(
        do_break, brk_ext, torch.where(do_coal, coal_ext, e_own)
    ).to(ext.dtype)

    def leader_sum(mask, x):
        return torch.where(isf & mask, x, zero).sum()

    return (
        mult_new, ext_new,
        leader_sum(isf, gf * mk_f),
        leader_sum(isf, (gamma_f - gf) * mk_f),
        leader_sum(do_coal, gf * mk_f),
        leader_sum(do_break, gjk * mk_f),
        leader_sum(do_break, (gf - gjk) * mk_f),
    )


def required_rows(functions):
    """the float32 attribute rows the functions read"""
    rows = set(KERNEL_ROWS[functions.kernel])
    if functions.ec == EC_BERRY1967:
        rows.add("radius")
    return rows


def _check(mult, ext, wm_index, attrs, functions, scale, K, seed):
    n = mult.shape[0]
    device = mult.device
    if mult.dtype != torch.int64 or mult.dim() != 1:
        raise TypeError("mult: int64 (n,) expected")
    if ext.dim() != 2 or ext.shape[1] != n or ext.dtype not in (
        torch.float32, torch.float64
    ):
        raise TypeError("ext: float32/float64 (n_ext, n) expected")
    if not 0 <= wm_index < ext.shape[0]:
        raise ValueError(f"wm_index={wm_index} outside the {ext.shape[0]} rows")
    missing = required_rows(functions) - set(attrs)
    if missing:
        raise ValueError(f"attribute rows {sorted(missing)} missing")
    for name, row in attrs.items():
        if row.dtype != torch.float32 or row.shape != (n,):
            raise TypeError(f"{name}: float32 (n,) expected")
    if scale.dtype != torch.float32 or scale.shape != (1,):
        raise TypeError("scale: float32 (1,) expected")
    for name, t in (("ext", ext), ("scale", scale), *attrs.items()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, mult on {device}")
    if not 0 <= int(K) < n:
        raise ValueError(f"K={K} outside [0, {n})")
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed={seed} is not a uint32")


def coalesce_breakup_mirror(
    mult, ext, wm_index, attrs, functions, scale, K, seed, max_multiplicity
):
    """one mirror-croupier collision substep with breakup. CPU tensors take
    the plain twin; CUDA tensors launch the Hopper kernel (or raise).
    Returns (mult_new, ext_new, collision rate, rate deficit, coalescence
    rate, breakup rate, breakup deficit) with 0-d float32 rate sums.

    mult: int64 (n,); ext: (n_ext, n) float32/float64, row ``wm_index`` the
    signed water mass; attrs: float32 (n,) rows by name, those
    ``required_rows(functions)`` names; functions: ``PairFunctions``;
    scale: float32 (1,), the normalization times the substep's probability
    scale; K in [0, n); seed: uint32; max_multiplicity: the cap of a
    multiplicity after breakup."""
    _check(mult, ext, wm_index, attrs, functions, scale, K, seed)
    if mult.device.type == "cpu":
        return coalesce_breakup_mirror_reference(
            mult, ext, wm_index, attrs, functions, scale, K, seed,
            max_multiplicity,
        )
    if mult.device.type != "cuda":
        raise ValueError(f"no kernel for device {mult.device}")
    return _launch(
        mult, ext, wm_index, attrs, functions, scale, K, seed, max_multiplicity
    )


coalesce_breakup_mirror.launches = 0
profiling.counters(coalesce_breakup_mirror, "launches")


class _Functions(ctypes.Structure):
    """``struct PairFunctions`` of ``csrc/collision_breakup.cu``"""

    _fields_ = [
        ("kernel_id", ctypes.c_int), ("k0", ctypes.c_float),
        ("k1", ctypes.c_float), ("ec_id", ctypes.c_int),
        ("ec0", ctypes.c_float), ("eb_id", ctypes.c_int),
        ("eb0", ctypes.c_float), ("frag_id", ctypes.c_int),
        ("f0", ctypes.c_float), ("f1", ctypes.c_float),
        ("f2", ctypes.c_float), ("f3", ctypes.c_float),
    ]


def _c_functions(functions):
    if functions.kernel not in BREAKUP_KERNELS:
        raise ValueError(f"unknown collision kernel id {functions.kernel}")
    if functions.ec not in (EC_CONST, EC_BERRY1967):
        raise ValueError(f"unknown coalescence efficiency id {functions.ec}")
    if functions.eb != EB_CONST:
        raise ValueError(f"unknown breakup efficiency id {functions.eb}")
    if functions.frag not in (
        FRAG_ALWAYS_N, FRAG_CONSTANT_MASS, FRAG_EXPONENTIAL
    ):
        raise ValueError(f"unknown fragmentation function id {functions.frag}")
    frag = (tuple(functions.frag_params) + (0.0,) * 4)[:4]
    if functions.frag == FRAG_EXPONENTIAL:
        frag = (-frag[0],) + frag[1:]
    return _Functions(
        functions.kernel, *functions.kernel_params,
        functions.ec, (tuple(functions.ec_params) + (0.0,))[0],
        functions.eb, functions.eb_params[0],
        functions.frag, *frag,
    )


@functools.cache
def library():
    """K5's built library with its entry points' C signatures declared"""
    lib = _build.load("collision_breakup")
    vp = ctypes.c_void_p
    lib.pysdm_coalesce_breakup_mirror.argtypes = [
        vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, vp,
        ctypes.POINTER(_Functions), vp, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_uint, ctypes.c_float, vp, vp, vp, vp, vp,
    ]
    lib.pysdm_coalesce_breakup_mirror.restype = ctypes.c_int
    lib.pysdm_coalesce_breakup_mirror_scratch_bytes.argtypes = [
        ctypes.c_longlong
    ]
    lib.pysdm_coalesce_breakup_mirror_scratch_bytes.restype = ctypes.c_longlong
    lib.pysdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(mult, ext, wm_index, attrs, functions, scale, K, seed, max_multiplicity):
    c_functions = _c_functions(functions)
    lib = library()
    n = mult.shape[0]
    mult = mult.contiguous()
    ext = ext.contiguous()
    rows = {name: attrs[name].contiguous() for name in required_rows(functions)}
    # the row whose pair difference the geometric kernels take
    diff_row = (
        "area" if functions.kernel == SIMPLE_GEOMETRIC
        else "relative fall velocity"
    )

    def pointer(name):
        return rows[name].data_ptr() if name in rows else None

    mult_out = torch.empty_like(mult)
    ext_out = torch.empty_like(ext)
    sums = torch.empty(5, dtype=torch.float32, device=mult.device)
    with torch.cuda.device(mult.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _build.scratch(
            _SCRATCH, (mult.device.index, stream, n),
            lambda: lib.pysdm_coalesce_breakup_mirror_scratch_bytes(n),
            mult.device, _SCRATCH_ENTRIES,
        )[0]
        err = lib.pysdm_coalesce_breakup_mirror(
            mult.data_ptr(), ext.data_ptr(), int(ext.dtype == torch.float64),
            ext.shape[0], int(wm_index), pointer("volume"), pointer("radius"),
            pointer(diff_row), ctypes.byref(c_functions),
            scale.data_ptr(), n, int(K), int(seed), float(max_multiplicity),
            mult_out.data_ptr(), ext_out.data_ptr(), scratch.data_ptr(),
            sums.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.pysdm_cuda_error_string(err).decode()
        raise RuntimeError(f"collision_breakup launch failed: {msg} ({err})")
    coalesce_breakup_mirror.launches += 1
    return (mult_out, ext_out, *sums.unbind())
