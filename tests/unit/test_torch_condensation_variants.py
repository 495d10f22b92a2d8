"""K3 over every variant set of ``chip_smoke.py`` phase 34, on the CPU.

1. K3's plain twin (``masses_new_reference``, float32) against the TPU
   kernel ``fused_masses_new`` run in interpret mode with the same variants,
   on 2048 drops of ``chip_smoke.k3_variant_rows`` (growing drops, haze
   settled at its float32 equilibrium, an inactive cell, dead and zero-mass
   drops, a non-finite root; an organic fraction under the film forms, a
   Reynolds number under ventilation), with the bounds of
   ``test_torch_condensation_kernel.py::test_twin_matches_pallas_kernel``:
   ``success`` equal drop for drop, and
   - rtol_x = 1e-2: the log-mass within 2 rtol_x |x_old| (the twin stops
     each drop on its own bracket, the TPU kernel a block at once);
   - rtol_x = 0 (both bisect to their caps; the cases ``<set>-rtol_x_0``):
     the twin's mass within rtol 1e-5 of the float64 root (the twin run on
     the rows made float64) on every drop, and the two kernels within 2e-5 of each other
     wherever the TPU kernel, too, lies within 1e-5 of that root, as it
     does on at least 90% of the drops (where it does not, it rounds its
     film volume as a difference, or its bisection took an exact zero of
     minfun for "root above", ``test_exact_zero_of_minfun_is_the_root``).
     Lowe's sets (c, d) are held to the root at 2e-5: their kinetics
     leave D and K uncorrected, the growing drops gain 3-15 times their
     mass in the step, and the float32 root lies up to 1.05e-5 from the
     float64 one under the Constant sigma too.
   The cell whose root lies beyond x_max is left out: there the two report
   different outcomes on purpose (``test_a_root_beyond_x_max_fails_
   where_the_pallas_kernel_reports_success``).

   Set e (``CompressedFilmRuehl``) has no TPU kernel to compare with: the
   JAX formula bisects in float64 whatever its inputs, and the kernel
   cannot store the float64 sigma that comes out into its float32 output
   (``test_pallas_kernel_cannot_take_ruehl``); in float32 it would form
   c = m_sigma N_A / (2 R T) as inf (m_sigma N_A = 1.8e40), and sigma would
   come out sigma_w for every 0 < f_org < 1, where K3 folds c in double
   (``test_ruehl_c_overflows_in_float32_and_not_in_k3``). Its twin is held
   to the same solve on the rows made float64 instead, at the same bounds.

   The film forms' sigma as the twin evaluates it (the port's formula on
   float32 inputs) is held to the JAX package's float64 formula
   (``test_film_sigma_in_float32_matches_jax_float64``): Ovadnevaite and
   Ruehl at rtol 2e-6 (seen: 7.7e-7 and 4.5e-7 over three seeds),
   Szyszkowski-Langmuir at 2e-5 (seen: 1.22e-5 on one drop of 512, where
   b^2 + 4a cancels in its closed-form root).

2. The port's CPU float64 solver (the JAX package's XLA formulation) against
   the JAX package on a 64-drop parcel through both packages' entry
   points, 20 steps per set: the environment at rtol 1e-12 and the water
   masses at 1e-9, as ``tests/smoke/test_torch_parcel.py`` holds them.
   The parcel runs non-adaptive (one substep a step): the variant sets
   differ in the per-drop solve and the thermodynamics, not in the
   adaptation, and the JAX package compiles its step anew for each set,
   the adaptive one at greater length.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.environments
from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.initialisation.sampling import spectral_sampling as jax_sampling
from pysdm_tpu.ops.pallas.condensation import make_fused_masses_new

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402
import pysdm_tpu_torch  # noqa: E402
from pysdm_tpu_torch.backends import CPU  # noqa: E402
from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation  # noqa: E402
from pysdm_tpu_torch.environments import Parcel  # noqa: E402
from pysdm_tpu_torch.initialisation import spectra  # noqa: E402
from pysdm_tpu_torch.initialisation.sampling import spectral_sampling  # noqa: E402
from pysdm_tpu_torch.ops.condensation import DropSolveSettings  # noqa: E402
from pysdm_tpu_torch.ops.cuda import condensation as k3  # noqa: E402

SETS = tuple(chip_smoke.K3_VARIANT_SETS)
RH_RTOL, MAX_ITERS, BISECT_ITERS = 1e-7, 16, 64
N = 2048
# the twin's bound to the float64 root at rtol_x = 0, by set (module doc)
ROOT_RTOL = {"c_lowe_film": 2e-5, "d_lowe_constant": 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the families the sets choose variants of
FAMILIES = (
    "saturation_vapour_pressure", "latent_heat_vapourisation",
    "diffusion_kinetics", "diffusion_thermics", "surface_tension",
    "ventilation",
)


def _formulae_pair(name, **constants):
    """(port Formulae, JAX package Formulae) of phase 34's set ``name``,
    with the variants and constants the port's ``k3_variant_formulae``
    picks; ``constants`` override"""
    port = chip_smoke.k3_variant_formulae(name)
    variants = {family: getattr(port, family).variant for family in FAMILIES}
    const = {
        k: getattr(port.constants, k)
        for k in (
            "MAC", "HAC", "sgm_org", "delta_min", "c_pd", "g_std", "Md", "Mv",
            "RUEHL_nu_org", "RUEHL_A0", "RUEHL_C0", "RUEHL_m_sigma",
            "RUEHL_sgm_min",
        )
    } | constants
    return (
        pysdm_tpu_torch.Formulae(seed=44, constants=const, **variants),
        pysdm_tpu.Formulae(seed=44, constants=const, **variants),
    )


@functools.cache
def _rows(name):
    port, _ = _formulae_pair(name)
    return chip_smoke.settle_haze(
        port, chip_smoke.k3_variant_rows(name, N, seed=11), "cpu"
    )


def _pallas(formulae, rows, rtol_x):
    """the TPU kernel in interpret mode on the rows, their cell rows
    expanded to drops; numpy (mass_new, success)"""
    fused = make_fused_masses_new(
        formulae, RH_rtol=RH_RTOL, max_iters=MAX_ITERS,
        bisect_iters=BISECT_ITERS, rtol_x=rtol_x,
    )
    cell = rows["cell_id"]
    act_d = np.where(rows["multiplicity"] > 0, rows["active"][cell], False)
    zeros = np.zeros_like(rows["water_mass"])
    mass, success = fused(
        *(jnp.asarray(a, jnp.float32) for a in (
            rows["water_mass"], rows["vdry"], rows["kappa"],
            rows.get("f_org", zeros), rows.get("reynolds", zeros),
            rows["thd"][cell], rows["qv"][cell], rows["rhod"][cell],
            rows["dt_sub"][cell], act_d, rows["rho_air"][cell],
            rows["mu_air"][cell],
        )),
        interpret=True,
    )
    return np.asarray(mass), np.asarray(success)


def _float64(rows):
    return {
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in rows.items()
    }


def _twin(name, rows, rtol_x):
    port, _ = _formulae_pair(name)
    settings = DropSolveSettings(rtol_x, RH_RTOL, MAX_ITERS, BISECT_ITERS)
    return chip_smoke.k3_call(
        k3.masses_new_reference, port, settings, rows, "cpu"
    )


@functools.cache
def _both(name, rtol_x):
    """(twin, TPU kernel) on the set's rows; for set e the twin on the rows
    made float64 stands in for the TPU kernel"""
    rows = _rows(name)
    twin = _twin(name, rows, rtol_x)
    if name == "e_ruehl":
        return twin, _twin(name, _float64(rows), rtol_x)
    return twin, _pallas(_formulae_pair(name)[1], rows, rtol_x)


@pytest.mark.parametrize("name, rtol_x", [
    *(pytest.param(name, 1e-2, id=name) for name in SETS),
    *(pytest.param(name, 0.0, id=f"{name}-rtol_x_0") for name in SETS),
])
def test_twin_matches_pallas_kernel(name, rtol_x):
    rows = _rows(name)
    (mass_t, succ_t), (mass_j, succ_j) = _both(name, rtol_x)
    sel = rows["cell_id"] != 4
    np.testing.assert_array_equal(succ_t[sel], succ_j[sel])
    old = rows["water_mass"][sel]
    mass_t, mass_j = mass_t[sel], mass_j[sel]
    if rtol_x == 0:
        root = _twin(name, _float64(rows), 0.0)[0][sel]
        np.testing.assert_allclose(
            mass_t, root, rtol=ROOT_RTOL.get(name, 1e-5)
        )
        on_root = np.isclose(mass_j, root, rtol=1e-5, atol=0)
        assert on_root.mean() > 0.9
        np.testing.assert_allclose(mass_t[on_root], mass_j[on_root], rtol=2e-5)
    else:
        x_old = np.abs(np.log(np.where(old > 0, old, 1e-18).astype(np.float64)))
        moved = (mass_t > 0) & (mass_j > 0)
        dx = np.abs(
            np.log(mass_t[moved].astype(np.float64))
            - np.log(mass_j[moved].astype(np.float64))
        )
        assert (dx <= 2 * rtol_x * x_old[moved]).all(), dx.max()
        np.testing.assert_array_equal(mass_t[~moved], mass_j[~moved])
    # the regimes: growing drops grow, settled haze stays, inert drops keep
    # their mass
    cell = rows["cell_id"][sel]
    growing = (cell == 0) & (old > 0)
    assert (mass_t[growing] > old[growing]).all() and succ_t[sel][growing].all()
    haze = (cell == 1) & (old > 0)
    assert succ_t[sel][haze].all()
    if rtol_x == 0:
        np.testing.assert_allclose(mass_t[haze], old[haze], rtol=1e-4)
    inert = (cell == 2) | (rows["multiplicity"][sel] == 0) | (old == 0)
    np.testing.assert_array_equal(mass_t[inert], old[inert])


def test_pallas_kernel_cannot_take_ruehl():
    _, jax_formulae = _formulae_pair("e_ruehl")
    with pytest.raises(ValueError, match="float64"):
        _pallas(jax_formulae, _rows("e_ruehl"), 1e-2)


def _film_inputs(seed=12, n=512):
    """float32 (T, v_wet, v_dry, f_org) over the drops of phase 34's rows:
    T 250-310 K, wet radii 30 nm - 30 um over dry radii 10-100 nm, f_org
    uniform on [0, 1] with 0 and 1 included"""
    rng = np.random.default_rng(seed)
    r_dry = np.exp(rng.uniform(np.log(1e-8), np.log(1e-7), n))
    r_wet = np.maximum(
        np.exp(rng.uniform(np.log(3e-8), np.log(3e-5), n)), 1.2 * r_dry
    )
    f_org = rng.uniform(0, 1, n)
    f_org[::16], f_org[::17] = 0, 1
    return tuple(a.astype(np.float32) for a in (
        rng.uniform(250, 310, n), 4 / 3 * np.pi * r_wet**3,
        4 / 3 * np.pi * r_dry**3, f_org,
    ))


@pytest.mark.parametrize("name, rtol", (
    ("c_lowe_film", 2e-6), ("f_szyszkowski_langmuir", 2e-5), ("e_ruehl", 2e-6),
))
def test_film_sigma_in_float32_matches_jax_float64(name, rtol):
    """sigma as K3's twin evaluates it (the port's formula on float32
    tensors, Ruehl's bisection in float64) against the JAX package's
    formula in float64 on the same values, at the module doc's bounds"""
    port, jax_formulae = _formulae_pair(name)
    inputs = _film_inputs()
    exact = np.asarray(jax_formulae.surface_tension.sigma(
        *(jnp.asarray(a, jnp.float64) for a in inputs)
    ))
    assert np.ptp(exact) > 1e-3  # the organic lowers sigma on some drops
    got = port.surface_tension.sigma(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), exact, rtol=rtol
    )


def test_ruehl_c_overflows_in_float32_and_not_in_k3():
    """with Singer and Ward's m_sigma = 0.3e17 J/m^2 the JAX formula in
    float32 (what the TPU kernel evaluates) gives sigma_w wherever
    0 < f_org < 1, since m_sigma N_A rounds to inf in float32; the port's
    formula on float32 inputs (what K3's twin evaluates; K3 folds c in
    double) stays within 1e-5 of the float64 formula"""
    port, jax_formulae = _formulae_pair("e_ruehl")
    T = 285.0
    r = np.asarray([6e-8, 8e-8, 1.5e-7, 3e-7, 5e-7, 2e-6])
    mass = 4 / 3 * np.pi * r**3 * 1000
    v_dry = np.full_like(r, 4 / 3 * np.pi * (2.5e-8) ** 3)
    f_org = np.full_like(r, 0.8)
    exact = np.asarray(jax_formulae.surface_tension.sigma(
        T, mass / 1000, v_dry, f_org
    ))
    assert (exact < port.constants.sgm_w - 1e-3).any()
    on_tpu = np.asarray(jax_formulae.surface_tension.sigma(
        jnp.float32(T), *(jnp.asarray(a, jnp.float32) for a in (
            mass / 1000, v_dry, f_org,
        ))
    ))
    np.testing.assert_allclose(on_tpu, port.constants.sgm_w, rtol=1e-6)
    got = port.surface_tension.sigma(
        torch.tensor(T, dtype=torch.float32),
        *(torch.tensor(v, dtype=torch.float32) for v in (
            mass / 1000, v_dry, f_org,
        )),
    )
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5)


def _parcel(package, name, n_sd=64):
    """a 64-drop parcel with the set's variants through either package's
    entry points on its CPU backend, starting 1% below saturation at 290 K
    (cloud base after ~10 s at 2 m/s); the film sets carry an organic
    fraction (0.6 of every drop's dry volume, 0 for every fourth)"""
    port, jax_formulae = _formulae_pair(name)
    if package == "jax":
        pkg, formulae, backend = pysdm_tpu, jax_formulae, pysdm_tpu.backends.CPU
        dyn, envs = pysdm_tpu.dynamics, pysdm_tpu.environments
        sampling, spectra_ = jax_sampling, jax_spectra
    else:
        pkg, formulae, backend = pysdm_tpu_torch, port, CPU
        dyn = sampling = spectra_ = envs = None
    T0, p0 = 290.0, 950e2
    pvs = float(port.saturation_vapour_pressure.pvs_water(T0))
    qv0 = port.constants.eps / (p0 / (0.99 * pvs) - 1)
    env = (envs.Parcel if envs else Parcel)(
        dt=1.0, mass_of_dry_air=1e3, p0=p0,
        initial_water_vapour_mixing_ratio=qv0, T0=T0, w=2.0,
    )
    builder = pkg.Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic(
        (dyn.AmbientThermodynamics if dyn else AmbientThermodynamics)()
    )
    builder.add_dynamic(
        (dyn.Condensation if dyn else Condensation)(adaptive=False)
    )
    spectrum = (spectra_ or spectra).Lognormal(
        norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5
    )
    r_dry, n_in_dv = (
        sampling or spectral_sampling
    ).ConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    if port.surface_tension.variant != "Constant":
        f_org = np.where(np.arange(n_sd) % 4 == 0, 0.0, 0.6)
        attributes["dry volume organic"] = f_org * attributes["dry volume"]
    return builder.build(attributes)


@pytest.mark.parametrize("name", SETS)
def test_float64_parcel_matches_jax_package(name):
    jp, tp = _parcel("jax", name), _parcel("torch", name)
    for _ in range(20):
        jp.run(1)
        tp.run(1)
        for key in ("thd", "qv", "rhod", "T", "p", "RH"):
            np.testing.assert_allclose(
                tp.get_env(key), np.asarray(jp.get_env(key)), rtol=1e-12,
                err_msg=key,
            )
        np.testing.assert_allclose(
            tp.attributes["water mass"], np.asarray(jp.attributes["water mass"]),
            rtol=1e-9,
        )
    np.testing.assert_array_equal(
        tp.get_counter("condensation_n_substeps"),
        jp.get_counter("condensation_n_substeps"),
    )
    assert tp.get_counter("condensation_success").all()
