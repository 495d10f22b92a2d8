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

The kernel evaluates one variant set: the parcel slice's formula variants
with ventilation ``Neglect`` (``SUPPORTED``). On a CUDA tensor any other set
raises ``NotImplementedError``; nothing falls back to the twin.

On the card the kernel is bound by its arithmetic (a serial chain of minfun
evaluations per drop), not by its ~29 bytes per drop; the source's note says
what the design does about the cost and the number of the evaluations.
"""

import ctypes
import functools

import torch

from . import _build

# formula variants the kernel evaluates, per family
SUPPORTED = {
    "diffusion_coordinate": ("WaterMass", "WaterMassLogarithm"),
    "hygroscopicity": ("KappaKoehler", "KappaKoehlerLeadingTerms"),
    "drop_growth": ("Fick", "Howell1949", "Mason1971"),
    "diffusion_kinetics": ("FuchsSutugin", "Neglect"),
    "saturation_vapour_pressure": ("FlatauWalkoCotton",),
    "latent_heat_vapourisation": ("Kirchhoff",),
    "diffusion_thermics": ("Neglect",),
    "ventilation": ("Neglect",),
    "surface_tension": ("Constant",),
    "state_variable_triplet": ("LibcloudphPlusPlus",),
    # for a positive mass, MixedPhaseSpheres' volume and radius are
    # LiquidSpheres' (``tests/unit/test_torch_ice_physics.py``); a drop of
    # ice (mass <= 0) is inactive and keeps its mass
    "particle_shape_and_density": ("LiquidSpheres", "MixedPhaseSpheres"),
}


def check_variants(formulae, families=tuple(SUPPORTED)):
    """raises ``NotImplementedError`` naming the first variant, among
    ``families``, that K3 does not evaluate"""
    for family in families:
        names = SUPPORTED[family]
        variant = getattr(formulae, family).variant
        if variant not in names:
            raise NotImplementedError(
                f"K3 has no {family} variant {variant!r}; it evaluates"
                f" {', '.join(names)}"
            )


class K3Params(ctypes.Structure):
    """``K3Params`` of ``csrc/condensation.cu``, field for field"""

    _fields_ = [
        *((name, ctypes.c_float) for name in (
            "T0", "p1000", "Rd", "Rv", "eps", "T_exponent",
            "l_tri", "c_pv_minus_c_pw", "T_tri",
        )),
        ("fwc", ctypes.c_float * 9),
        *((name, ctypes.c_float) for name in (
            "D0", "K0", "rho_w", "pi_4_3", "one_third", "koehler_A",
            "lambdaK_coef", "two_Rd", "two_Rv", "mac_a", "mac_b", "hac_a",
            "hac_b", "rho_w_Rv", "four_pi_rho_w", "x_max", "RH_rtol",
            "rtol_x", "per_mass",
        )),
        *((name, ctypes.c_int) for name in (
            "max_iters", "bisect_cap", "coordinate", "hygroscopicity",
            "drop_growth", "kinetics",
        )),
    ]


@functools.lru_cache(maxsize=16)
def kernel_params(formulae, settings):
    """the kernel's constants from ``formulae.constants``: each folded in
    double as the formula bodies fold their Python-float products, then
    rounded to float32 by ctypes"""
    c = formulae.constants
    rtol_x, RH_rtol, max_iters, bisect_iters = settings
    return K3Params(
        T0=c.T0, p1000=c.p1000, Rd=c.Rd, Rv=c.Rv, eps=c.eps,
        T_exponent=c.Rd_over_c_pd / (1 - c.Rd_over_c_pd),
        l_tri=c.l_tri, c_pv_minus_c_pw=c.c_pv - c.c_pw, T_tri=c.T_tri,
        fwc=(ctypes.c_float * 9)(*(getattr(c, f"FWC_C{k}") for k in range(9))),
        D0=c.D0, K0=c.K0, rho_w=c.rho_w, pi_4_3=c.PI_4_3,
        one_third=c.ONE_THIRD, koehler_A=2 * c.sgm_w / c.Rv,
        lambdaK_coef=(4.0 / 5) * c.K0, two_Rd=2 * c.Rd, two_Rv=2 * c.Rv,
        mac_a=4.0 / 3 / c.MAC + 0.377, mac_b=4.0 / 3 / c.MAC,
        hac_a=4.0 / 3 / c.HAC + 0.377, hac_b=4.0 / 3 / c.HAC,
        rho_w_Rv=c.rho_w * c.Rv, four_pi_rho_w=4 * c.PI * c.rho_w,
        x_max=formulae.diffusion_coordinate.x_max(),
        RH_rtol=RH_rtol, rtol_x=rtol_x,
        per_mass=1 / (c.rho_w * c.PI_4_3),
        max_iters=max_iters, bisect_cap=min(bisect_iters, 40),
        coordinate=SUPPORTED["diffusion_coordinate"].index(
            formulae.diffusion_coordinate.variant
        ),
        hygroscopicity=SUPPORTED["hygroscopicity"].index(
            formulae.hygroscopicity.variant
        ),
        drop_growth=SUPPORTED["drop_growth"].index(formulae.drop_growth.variant),
        kinetics=SUPPORTED["diffusion_kinetics"].index(
            formulae.diffusion_kinetics.variant
        ),
    )


def masses_new_reference(
    formulae, settings, water_mass, vdry, kappa, multiplicity, cell_id,
    thd, qv, rhod, dt_sub, active, rho_air, mu_air, stats=None,
):
    """plain PyTorch twin of the kernel (same function, same signature,
    the per-drop stopping rule); computes in the dtype of ``water_mass``.
    ``stats``: see ``drop_solve``"""
    from ..condensation import drop_solve, thermo

    cell = cell_id.long().clamp(0, thd.shape[0] - 1)
    T, p, RH, lv, pvs, DTp, KTp, Sc = thermo(
        formulae, thd[cell], qv[cell], rhod[cell], rho_air[cell], mu_air[cell]
    )
    zeros = torch.zeros_like(water_mass)
    return drop_solve(
        formulae, settings, water_mass=water_mass, vdry=vdry, kappa=kappa,
        f_org=zeros, reynolds=zeros,
        active_drop=active[cell] & (multiplicity > 0), dt_sub=dt_sub[cell],
        T=T, p=p, RH=RH, lv=lv, pvs=pvs, DTp=DTp, KTp=KTp, Sc=Sc,
        per_drop=True, stats=stats,
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
    thd, qv, rhod, dt_sub, active, rho_air, mu_air,
):
    """per-drop implicit condensation solve: returns (mass_new, success),
    mass_new in the dtype of ``water_mass`` and success bool, both (n,).

    Per drop (n,): water_mass, vdry, kappa (float), multiplicity (int64),
    cell_id (int32). Per cell (n_cell,): thd, qv, rhod, dt_sub, rho_air,
    mu_air (float) and active (bool). ``settings``: (rtol_x, RH_rtol,
    max_iters, bisect_iters). CPU tensors take the plain twin; CUDA tensors
    launch the Hopper kernel (float32 only) or raise."""
    cells = (thd, qv, rhod, dt_sub, active, rho_air, mu_air)
    _check(water_mass, vdry, kappa, multiplicity, cell_id, cells)
    if water_mass.device.type == "cpu":
        return masses_new_reference(
            formulae, settings, water_mass, vdry, kappa, multiplicity,
            cell_id, *cells,
        )
    if water_mass.device.type != "cuda":
        raise ValueError(f"no kernel for device {water_mass.device}")
    check_variants(formulae)
    return _launch(
        kernel_params(formulae, settings), water_mass, vdry, kappa,
        multiplicity, cell_id, cells,
    )


masses_new.launches = 0


@functools.cache
def library():
    """the built library with its entry points' C signatures declared"""
    lib = _build.load("condensation")
    vp = ctypes.c_void_p
    lib.pysdm_condensation_masses_new.argtypes = [
        *([vp] * 12), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(K3Params), vp, vp, vp,
    ]
    lib.pysdm_condensation_masses_new.restype = ctypes.c_int
    lib.pysdm_condensation_error_string.argtypes = [ctypes.c_int]
    lib.pysdm_condensation_error_string.restype = ctypes.c_char_p
    return lib


def _launch(params, water_mass, vdry, kappa, multiplicity, cell_id, cells):
    floats = (water_mass, vdry, kappa) + cells[:4] + cells[5:]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("the CUDA kernel takes float32 rows")
    lib = library()
    n = water_mass.shape[0]
    ins = [
        t.contiguous()
        for t in (water_mass, vdry, kappa, multiplicity, cell_id, *cells)
    ]
    mass_out = torch.empty_like(water_mass)
    success = torch.empty(n, dtype=torch.bool, device=water_mass.device)
    with torch.cuda.device(water_mass.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pysdm_condensation_masses_new(
            *(t.data_ptr() for t in ins), n, cells[0].shape[0],
            ctypes.byref(params), mass_out.data_ptr(), success.data_ptr(),
            stream,
        )
    if err != 0:
        msg = lib.pysdm_condensation_error_string(err).decode()
        raise RuntimeError(f"condensation launch failed: {msg} ({err})")
    masses_new.launches += 1
    return mass_out, success
