"""Per-drop implicit condensation solve (K3): the Hopper kernel
``csrc/condensation.cu``, its wrapper ``masses_new`` and its plain PyTorch
twin ``masses_new_reference``.

Replaces the TPU kernel ``fused_masses_new``, built by
``make_fused_masses_new`` (``pysdm_tpu/ops/pallas/condensation.py:37``,
``:255``, ``pallas_call`` at ``:299``). Per drop: the thermodynamic state of
its cell, Koehler, Fuchs-Sutugin, Fk and Fd, the sign-directed bracket and
a bracketing root search (Chandrupatla's inverse quadratic interpolation
with a bisection safeguard), returning (mass_new, success). The per-cell
rows are read through the drop's cell id; the drop is active when its cell
is, its multiplicity is above zero and its water mass is positive: a drop
of ice (a negative signed mass, ``MixedPhaseSpheres``) keeps its mass, bit
for bit, and counts as solved, in the kernel and in the twin, and neither
takes a logarithm of its mass. Each
drop stops when its own bracket is within rtol_x |x_old| + 1e-30 or minfun
is exactly 0 at the point evaluated (the TPU kernel bisects and stops per
32768-drop block, the JAX XLA path when all drops have converged, and both
walk past an exact zero to the bracket's upper end).

The kernel evaluates every variant set that the JAX package's condensation
takes (``SUPPORTED``): the per-cell state switches on the saturation vapour
pressure, latent heat and diffusion thermics, the per-drop prologue on the
diffusion kinetics and the ventilation, and minfun is instantiated once per
surface-tension form. A particle shape without the volume and growth
formulae condensation needs (``PorousSpheroid``, ``ColumnarIce``) raises
``NotImplementedError``, as the JAX package cannot condense on it either;
nothing falls back to the twin. The Reynolds-number row is read only when
the ventilation is not ``Neglect``, the organic-fraction row only under a
film form of the surface tension.

On the card the kernel is bound by its arithmetic (a serial chain of minfun
evaluations per drop), not by its ~29 bytes per drop (33 or 37 with the
Reynolds number and the organic fraction); the source's note says what the
design does about the cost and the number of the evaluations.

Counts: ``masses_new.launches`` on the host. While a profiler records
(``utils/profiling.py``), one launch in ``COUNT_EVERY``, the first among
them, takes the kernel's counting instantiation, which adds the drops it
found active, those that needed a solve, its minfun evaluations and the
drops it swept (``COUNTS``) into int64 counts on the device. That
instantiation takes ~5% longer (``PERF.md``), so a traced K3 is, but for
the sample, the kernel a step nobody profiles runs. The wrapper asks for
the counts at every launch, so the first launch allocates them, and
passes a null pointer to every other launch: the kernel without the
counts runs.
"""

import ctypes
import functools
import math

import torch

from ...utils import profiling
from . import _build

# what the kernel counts, in the order of a slot, and its counts:
# COUNT_SLOTS slots of COUNT_WIDTH entries, over which the warps spread
# their atomic adds (``csrc/condensation.cu``); one launch in COUNT_EVERY
# counts while a profiler records (the warm rain's 60-step episode: 7 of
# its 420)
COUNTS = ("active", "need_solve", "evaluations", "swept")
COUNT_SLOTS, COUNT_WIDTH = 256, 4
COUNT_EVERY = 64

# formula variants the kernel evaluates, per family; the order of each
# tuple gives the variant's number in K3Params
SUPPORTED = {
    "diffusion_coordinate": ("WaterMass", "WaterMassLogarithm"),
    "hygroscopicity": ("KappaKoehler", "KappaKoehlerLeadingTerms"),
    "drop_growth": ("Fick", "Howell1949", "Mason1971"),
    "diffusion_kinetics": (
        "FuchsSutugin", "Neglect", "PruppacherKlett", "GrabowskiEtAl2011",
        "LoweEtAl2019",
    ),
    "saturation_vapour_pressure": (
        "FlatauWalkoCotton", "AugustRocheMagnus", "Bolton1980", "Lowe1977",
        "MurphyKoop2005", "Wexler1976",
    ),
    "latent_heat_vapourisation": (
        "Kirchhoff", "Constant", "SeinfeldPandis", "Lowe2019",
    ),
    "diffusion_thermics": (
        "Neglect", "TracyWelchPorter", "SeinfeldAndPandis2010",
        "LoweEtAl2019", "GrabowskiEtAl2011",
    ),
    "ventilation": ("Neglect", "Froessling1938", "PruppacherAndRasmussen1979"),
    "surface_tension": (
        "Constant", "CompressedFilmOvadnevaite", "SzyszkowskiLangmuir",
        "CompressedFilmRuehl",
    ),
    "state_variable_triplet": ("LibcloudphPlusPlus",),
    # for a positive mass, MixedPhaseSpheres' volume and radius are
    # LiquidSpheres' (``tests/unit/test_torch_ice_physics.py``); a drop of
    # ice (mass <= 0) is inactive and keeps its mass
    "particle_shape_and_density": ("LiquidSpheres", "MixedPhaseSpheres"),
}
# the film forms of the surface tension read the organic fraction
FILM_FORMS = SUPPORTED["surface_tension"][1:]
# particle shapes the JAX package's condensation cannot take either: what
# the variant lacks of the formulae minfun calls
_NO_CONDENSATION = {
    "PorousSpheroid": "mass_to_volume",
    "ColumnarIce": "dm_dt",
}


def _number(formulae, family):
    return SUPPORTED[family].index(getattr(formulae, family).variant)


def check_variants(formulae, families=tuple(SUPPORTED)):
    """raises ``NotImplementedError`` naming the first variant, among
    ``families``, that K3 does not evaluate"""
    for family in families:
        names = SUPPORTED[family]
        variant = getattr(formulae, family).variant
        if variant in names:
            continue
        if variant in _NO_CONDENSATION:
            raise NotImplementedError(
                f"K3 has no {family} variant {variant!r}: it has no"
                f" {_NO_CONDENSATION[variant]}, so the JAX package cannot"
                " condense on it either"
            )
        raise NotImplementedError(
            f"K3 has no {family} variant {variant!r}; it evaluates"
            f" {', '.join(names)}"
        )


class K3Params(ctypes.Structure):
    """``K3Params`` of ``csrc/condensation.cu``, field for field"""

    _fields_ = [
        *((name, ctypes.c_float) for name in (
            "T0", "p1000", "Rd", "Rv", "eps", "T_exponent",
            "l_tri", "c_pv_minus_c_pw", "T_tri", "l_l19_a", "l_l19_b",
        )),
        ("svp", ctypes.c_float * 13),
        *((name, ctypes.c_float) for name in (
            "D0", "K0", "D_exp", "p_STP", "d_l19_a", "d_l19_b", "k_l19_a",
            "k_l19_b", "k_l19_c",
        )),
        ("D_G11", ctypes.c_float * 3),
        ("K_G11", ctypes.c_float * 4),
        *((name, ctypes.c_float) for name in (
            "rho_w", "pi_4_3", "one_third", "koehler_A", "two_over_Rv",
            "lambdaK_coef", "two_Rd", "two_Rv", "mac_a", "mac_b", "hac_a",
            "hac_b", "pk_dv", "pk_two_sqrt_pi", "MAC",
        )),
        ("vent", ctypes.c_float * 8),
        *((name, ctypes.c_float) for name in (
            "rho_w_Rv", "four_pi_rho_w", "four_pi", "x_max", "RH_rtol",
            "rtol_x", "per_mass", "sgm_w", "inv_rho_w", "sgm_org",
            "delta_min", "water_molar_volume", "nu_org", "N_A", "A0",
            "A0_squared", "C0", "m_sigma", "sgm_min", "sl_coef",
        )),
        ("ruehl_c", ctypes.c_double),
        *((name, ctypes.c_int) for name in (
            "max_iters", "bisect_cap", "coordinate", "hygroscopicity",
            "drop_growth", "kinetics", "svp_variant", "lv_variant",
            "thermics", "ventilation", "surface_tension",
        )),
    ]


def _svp_coefficients(formulae):
    """the saturation vapour pressure variant's coefficients, in the order
    ``svp_water`` of ``csrc/condensation.cu`` reads them"""
    c = formulae.constants
    names = {
        "FlatauWalkoCotton": [f"FWC_C{k}" for k in range(9)],
        "AugustRocheMagnus": ["ARM_C1", "ARM_C2", "ARM_C3"],
        "Bolton1980": ["B80W_G0", "B80W_G1", "B80W_G2"],
        "Lowe1977": [f"L77W_A{k}" for k in range(7)],
        "MurphyKoop2005": [f"MK05_LIQ_C{k}" for k in range(1, 14)],
        "Wexler1976": [f"W76W_G{k}" for k in range(9)],
    }[formulae.saturation_vapour_pressure.variant]
    values = [getattr(c, name) for name in names]
    return (ctypes.c_float * 13)(*values, *([0.0] * (13 - len(values))))


@functools.lru_cache(maxsize=16)
def kernel_params(formulae, settings):
    """the kernel's constants from ``formulae.constants``: each folded in
    double as the formula bodies fold their Python-float products, then
    rounded to float32 by ctypes (Ruehl's m_sigma N_A / (2 R), above
    FLT_MAX, stays a double)"""
    c = formulae.constants
    rtol_x, RH_rtol, max_iters, bisect_iters = settings
    kinetics = formulae.diffusion_kinetics.variant
    return K3Params(
        T0=c.T0, p1000=c.p1000, Rd=c.Rd, Rv=c.Rv, eps=c.eps,
        T_exponent=c.Rd_over_c_pd / (1 - c.Rd_over_c_pd),
        l_tri=c.l_tri, c_pv_minus_c_pw=c.c_pv - c.c_pw, T_tri=c.T_tri,
        l_l19_a=c.l_l19_a, l_l19_b=c.l_l19_b,
        svp=_svp_coefficients(formulae),
        D0=c.D0, K0=c.K0, D_exp=c.D_exp, p_STP=c.p_STP, d_l19_a=c.d_l19_a,
        d_l19_b=c.d_l19_b, k_l19_a=c.k_l19_a, k_l19_b=c.k_l19_b,
        k_l19_c=c.k_l19_c,
        D_G11=(ctypes.c_float * 3)(*(
            getattr(c, f"diffusion_thermics_D_G11_{k}") for k in "ABC"
        )),
        K_G11=(ctypes.c_float * 4)(*(
            getattr(c, f"diffusion_thermics_K_G11_{k}") for k in "ABCD"
        )),
        rho_w=c.rho_w, pi_4_3=c.PI_4_3,
        one_third=c.ONE_THIRD, koehler_A=2 * c.sgm_w / c.Rv,
        two_over_Rv=2 / c.Rv,
        lambdaK_coef=(4.0 / 5) * c.K0, two_Rd=2 * c.Rd, two_Rv=2 * c.Rv,
        mac_a=4.0 / 3 / c.MAC + 0.377, mac_b=4.0 / 3 / c.MAC,
        hac_a=4.0 / 3 / c.HAC + 0.377, hac_b=4.0 / 3 / c.HAC,
        pk_dv=c.dv_pk05, pk_two_sqrt_pi=2 * math.sqrt(c.PI), MAC=c.MAC,
        vent=(ctypes.c_float * 8)(
            c.FROESSLING_1938_A, c.FROESSLING_1938_B,
            *(getattr(c, f"PRUPPACHER_RASMUSSEN_1979_{k}") for k in (
                "XTHRES", "CONSTSMALL", "COEFFSMALL", "POWSMALL", "CONSTBIG",
                "COEFFBIG",
            )),
        ),
        rho_w_Rv=c.rho_w * c.Rv, four_pi_rho_w=4 * c.PI * c.rho_w,
        four_pi=4 * c.PI,
        x_max=formulae.diffusion_coordinate.x_max(),
        RH_rtol=RH_rtol, rtol_x=rtol_x,
        per_mass=1 / (c.rho_w * c.PI_4_3),
        sgm_w=c.sgm_w, inv_rho_w=1 / c.rho_w, sgm_org=c.sgm_org,
        delta_min=c.delta_min, water_molar_volume=c.water_molar_volume,
        nu_org=c.RUEHL_nu_org, N_A=c.N_A, A0=c.RUEHL_A0,
        A0_squared=c.RUEHL_A0**2, C0=c.RUEHL_C0, m_sigma=c.RUEHL_m_sigma,
        sgm_min=c.RUEHL_sgm_min, sl_coef=c.R_str / (c.RUEHL_A0 * c.N_A),
        ruehl_c=(c.RUEHL_m_sigma * c.N_A) / (2 * c.R_str),
        max_iters=max_iters, bisect_cap=min(bisect_iters, 40),
        coordinate=_number(formulae, "diffusion_coordinate"),
        hygroscopicity=_number(formulae, "hygroscopicity"),
        drop_growth=_number(formulae, "drop_growth"),
        # GrabowskiEtAl2011 and LoweEtAl2019 are PruppacherKlett's D and K
        kinetics=min(SUPPORTED["diffusion_kinetics"].index(kinetics), 2),
        svp_variant=_number(formulae, "saturation_vapour_pressure"),
        # Lowe2019 is SeinfeldPandis
        lv_variant=min(_number(formulae, "latent_heat_vapourisation"), 2),
        thermics=_number(formulae, "diffusion_thermics"),
        ventilation=_number(formulae, "ventilation"),
        surface_tension=_number(formulae, "surface_tension"),
    )


def masses_new_reference(
    formulae, settings, water_mass, vdry, kappa, multiplicity, cell_id,
    thd, qv, rhod, dt_sub, active, rho_air, mu_air, *, f_org=None,
    reynolds=None, stats=None,
):
    """plain PyTorch twin of the kernel (same function, same signature,
    the per-drop stopping rule); computes in the dtype of ``water_mass``.
    ``stats``: see ``drop_solve``"""
    from ..condensation import drop_solve, thermo

    _check_rows(formulae, water_mass, f_org, reynolds)
    cell = cell_id.long().clamp(0, thd.shape[0] - 1)
    T, p, RH, lv, pvs, DTp, KTp, Sc = thermo(
        formulae, thd[cell], qv[cell], rhod[cell], rho_air[cell], mu_air[cell]
    )
    zeros = torch.zeros_like(water_mass)
    return drop_solve(
        formulae, settings, water_mass=water_mass, vdry=vdry, kappa=kappa,
        f_org=zeros if f_org is None else f_org,
        reynolds=zeros if reynolds is None else reynolds,
        active_drop=active[cell] & (multiplicity > 0), dt_sub=dt_sub[cell],
        T=T, p=p, RH=RH, lv=lv, pvs=pvs, DTp=DTp, KTp=KTp, Sc=Sc,
        per_drop=True, stats=stats,
    )


def _check_rows(formulae, water_mass, f_org, reynolds):
    """the optional per-drop rows: each (n,) float on ``water_mass``'s
    device, and given where the variant set reads it"""
    n = water_mass.shape[0]
    for name, t, needed in (
        ("f_org", f_org,
         formulae.surface_tension.variant in FILM_FORMS),
        ("reynolds", reynolds, formulae.ventilation.variant != "Neglect"),
    ):
        if t is None:
            if needed:
                raise TypeError(
                    f"{name}: the variant set reads it, and it was not given"
                )
            continue
        if t.dim() != 1 or t.shape[0] != n or not t.is_floating_point():
            raise TypeError(f"{name}: float (n,) expected")
        if t.device != water_mass.device:
            raise ValueError(
                f"{name} is on {t.device}, water_mass on {water_mass.device}"
            )


def _check(water_mass, vdry, kappa, multiplicity, cell_id, cells):
    n = water_mass.shape[0]
    device = water_mass.device
    for name, t in (("water_mass", water_mass), ("vdry", vdry), ("kappa", kappa)):
        if t.dim() != 1 or t.shape[0] != n or not t.is_floating_point():
            raise TypeError(f"{name}: float (n,) expected")
    if multiplicity.dtype != torch.int64 or multiplicity.shape != (n,):
        raise TypeError("multiplicity: int64 (n,) expected")
    if cell_id.dtype != torch.int32 or cell_id.shape != (n,):
        raise TypeError("cell_id: int32 (n,) expected")
    n_cell = cells[0].shape[0]
    for k, t in enumerate(cells):
        if t.dim() != 1 or t.shape[0] != n_cell:
            raise TypeError(f"cell row {k}: (n_cell,) expected")
    if cells[4].dtype != torch.bool:
        raise TypeError("active: bool (n_cell,) expected")
    for t in (vdry, kappa, multiplicity, cell_id, *cells):
        if t.device != device:
            raise ValueError(f"a row is on {t.device}, water_mass on {device}")


def masses_new(
    formulae, settings, water_mass, vdry, kappa, multiplicity, cell_id,
    thd, qv, rhod, dt_sub, active, rho_air, mu_air, *, f_org=None,
    reynolds=None,
):
    """per-drop implicit condensation solve: returns (mass_new, success),
    mass_new in the dtype of ``water_mass`` and success bool, both (n,).

    Per drop (n,): water_mass, vdry, kappa (float), multiplicity (int64),
    cell_id (int32); f_org (the dry volume's organic fraction, under a film
    form of the surface tension) and reynolds (the Reynolds number, under
    ventilation other than Neglect), float, where the variant set reads
    them. Per cell (n_cell,): thd, qv, rhod, dt_sub, rho_air, mu_air
    (float) and active (bool). ``settings``: (rtol_x, RH_rtol, max_iters,
    bisect_iters). CPU tensors take the plain twin; CUDA tensors launch the
    Hopper kernel (float32 only) or raise."""
    cells = (thd, qv, rhod, dt_sub, active, rho_air, mu_air)
    _check(water_mass, vdry, kappa, multiplicity, cell_id, cells)
    if water_mass.device.type == "cpu":
        return masses_new_reference(
            formulae, settings, water_mass, vdry, kappa, multiplicity,
            cell_id, *cells, f_org=f_org, reynolds=reynolds,
        )
    if water_mass.device.type != "cuda":
        raise ValueError(f"no kernel for device {water_mass.device}")
    check_variants(formulae)
    _check_rows(formulae, water_mass, f_org, reynolds)
    return _launch(
        kernel_params(formulae, settings), water_mass, vdry, kappa,
        multiplicity, cell_id, cells, f_org, reynolds,
    )


masses_new.launches = 0
profiling.counters(masses_new, "launches")


def declare(lib):
    """declares the C signatures of ``csrc/condensation.cu``'s entry points
    on ``lib``, a library built from it; returns ``lib``"""
    vp = ctypes.c_void_p
    # 14 rows, n, n_cell, the parameters, mass, success, counts, stream
    lib.pysdm_condensation_masses_new.argtypes = [
        *([vp] * 14), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(K3Params), vp, vp, vp, vp,
    ]
    lib.pysdm_condensation_masses_new.restype = ctypes.c_int
    lib.pysdm_condensation_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_condensation_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library():
    """the built library with its entry points' C signatures declared"""
    return declare(_build.load("condensation"))


def _launch(params, water_mass, vdry, kappa, multiplicity, cell_id, cells,
            f_org, reynolds):
    # a row the variant set does not read is not read: water_mass stands in
    optional = tuple(water_mass if t is None else t for t in (reynolds, f_org))
    floats = (water_mass, vdry, kappa) + cells[:4] + cells[5:] + optional
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("the CUDA kernel takes float32 rows")
    lib = library()
    n = water_mass.shape[0]
    ins = [
        t.contiguous()
        for t in (water_mass, vdry, kappa, multiplicity, cell_id, *cells,
                  *optional)
    ]
    mass_out = torch.empty_like(water_mass)
    success = torch.empty(n, dtype=torch.bool, device=water_mass.device)
    counts = profiling.device_counts(
        "masses_new", COUNTS, water_mass.device, COUNT_SLOTS, COUNT_WIDTH
    )
    with torch.cuda.device(water_mass.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pysdm_condensation_masses_new(
            *(t.data_ptr() for t in ins), n, cells[0].shape[0],
            ctypes.byref(params), mass_out.data_ptr(), success.data_ptr(),
            counts.data_ptr()
            if profiling.sample("masses_new", COUNT_EVERY) else None,
            stream,
        )
    if err != 0:
        msg = lib.pysdm_condensation_error_string(err).decode()
        raise RuntimeError(f"condensation launch failed: {msg} ({err})")
    masses_new.launches += 1
    return mass_out, success
