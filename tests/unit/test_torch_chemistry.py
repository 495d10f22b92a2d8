"""The port's aqueous chemistry against the JAX package, in float64 on the
CPU: the chemistry trivia, the Henry, equilibrium and kinetic constants,
the ops of ``ops/chemistry.py`` on random drops over the ranges the
Kreidenweis et al. 2003 parcel reaches (haze to cloud drops, several
cells), the ``AqueousChemistry`` dynamic on a box step by step, and the
JAX package's ``tests/unit/test_chemistry.py`` replayed on the port.

Tolerance: rtol 1e-12. Both packages evaluate the same expressions in the
same order; XLA's and torch's exp, log and pow may differ by an ulp. The
pH solve bisects log H 48 times: where the electroneutrality residual at a
midpoint is within its rounding of zero the two may step apart, by at most
that iteration's bracket, so ``equilibrate_H`` is held at rtol 1e-12 on H
and the count of drops further apart is asserted to be zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysdm_tpu
from pysdm_tpu.backends import CPU as JaxCPU
from pysdm_tpu.dynamics import AqueousChemistry as JaxAqueousChemistry
from pysdm_tpu.dynamics.impl import chemistry_utils as jax_chem
from pysdm_tpu.environments import Box as JaxBox
from pysdm_tpu.ops import chemistry as jax_ops

from pysdm_tpu_torch import Builder, Formulae
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import AqueousChemistry
from pysdm_tpu_torch.dynamics.impl import chemistry_utils as chem
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.ops import chemistry as ops
from pysdm_tpu_torch.physics import si

RTOL = 1e-12
N_DROPS, N_CELL = 256, 4
PPB = 1e-9
MOLE_FRACTIONS = {
    "SO2": 0.2 * PPB,
    "O3": 50 * PPB,
    "H2O2": 0.5 * PPB,
    "CO2": 360e-6,
    "NH3": 0.1 * PPB,
    "HNO3": 0.1 * PPB,
}
TEMPERATURES = np.asarray([263.15, 273.15, 285.2, 298.15, 303.0])
_rng = np.random.default_rng(20261017)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _log_uniform(lo, hi, n=N_DROPS):
    return np.exp(_rng.uniform(np.log(lo), np.log(hi), n))


# aqueous concentrations [mol/m3] over what the Kreidenweis parcel's drops
# hold, from haze (~10 M ammonium bisulfate) to cloud drops
CONC_RANGES = {
    "S_VI": (1e-3, 1e4),
    "N_mIII": (1e-3, 1e4),
    "S_IV": (1e-9, 1e-1),
    "C_IV": (1e-6, 1e-2),
    "N_V": (1e-9, 1e-1),
    "O3": (1e-9, 1e-3),
    "H2O2": (1e-7, 1e-1),
}
CONC = {k: _log_uniform(*r) for k, r in CONC_RANGES.items()}
CELL = _rng.integers(0, N_CELL, N_DROPS)
T_CELL = _rng.uniform(270.0, 290.0, N_CELL)
P_CELL = _rng.uniform(7e4, 9.5e4, N_CELL)
RHOD_CELL = _rng.uniform(0.9, 1.2, N_CELL)
H_DROP = _log_uniform(1e-8, 1e2)
VOLUME = 4 / 3 * np.pi * _log_uniform(3e-8, 2e-5) ** 3
MULT = np.floor(_log_uniform(1e6, 1e10))


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _eq_drop(formulae):
    """the equilibrium constants at each drop's cell temperature, as the
    dynamic gathers them, for each package"""
    T = T_CELL[CELL]
    jax_eq = {k: jnp.asarray(v.at(jnp.asarray(T)))
              for k, v in jax_chem.equilibrium_consts(formulae[0]).items()}
    eq = {k: v.at(torch.from_numpy(T))
          for k, v in chem.equilibrium_consts(formulae[1]).items()}
    jax_eq["K_H2O"] = eq["K_H2O"] = formulae[1].constants.K_H2O
    return jax_eq, eq


FORMULAE = (pysdm_tpu.Formulae(), Formulae())


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0)


TRIVIA = (
    ("H2pH", (_log_uniform(1e-11, 1e4),)),
    ("pH2H", (_rng.uniform(-1.0, 14.0, N_DROPS),)),
    ("tdep2enthalpy", (_rng.uniform(-5000.0, 9000.0, N_DROPS),)),
    ("mole_fraction_2_mixing_ratio", (_log_uniform(1e-12, 1e-3), 1.52)),
    ("mixing_ratio_2_mole_fraction", (_log_uniform(1e-12, 1e-3), 0.59)),
    ("mixing_ratio_to_specific_content", (_log_uniform(1e-6, 3e-2),)),
    ("dn_dlogr", (_log_uniform(1e-8, 1e-4), _log_uniform(1e10, 1e20))),
    ("arrhenius", (3.5e5, 4.6e4, _rng.uniform(250.0, 310.0, N_DROPS))),
)


@pytest.mark.parametrize("name, args", TRIVIA, ids=[t[0] for t in TRIVIA])
def test_trivia_matches_jax_package(name, args):
    want = getattr(FORMULAE[0].trivia, name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    )
    got = getattr(FORMULAE[1].trivia, name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args)
    )
    assert got.dtype == torch.float64
    _close(got, want)


def test_vant_hoff_matches_jax_package():
    T = _rng.uniform(250.0, 310.0, N_DROPS)
    want = FORMULAE[0].trivia.vant_hoff(15.4, -7.2e4, jnp.asarray(T), T_0=298.15)
    got = FORMULAE[1].trivia.vant_hoff(15.4, -7.2e4, torch.from_numpy(T),
                                       T_0=298.15)
    _close(got, want)


CONSTANT_TABLES = (
    ("henry_consts", "HNO3"), ("henry_consts", "H2O2"),
    ("henry_consts", "NH3"), ("henry_consts", "SO2"),
    ("henry_consts", "CO2"), ("henry_consts", "O3"),
    ("equilibrium_consts", "K_HNO3"), ("equilibrium_consts", "K_SO2"),
    ("equilibrium_consts", "K_NH3"), ("equilibrium_consts", "K_CO2"),
    ("equilibrium_consts", "K_HSO3"), ("equilibrium_consts", "K_HCO3"),
    ("equilibrium_consts", "K_HSO4"),
    ("kinetic_consts", "k0"), ("kinetic_consts", "k1"),
    ("kinetic_consts", "k2"), ("kinetic_consts", "k3"),
)


@pytest.mark.parametrize(
    "table, key", CONSTANT_TABLES, ids=[f"{t}.{k}" for t, k in CONSTANT_TABLES]
)
def test_constants_match_jax_package(table, key):
    """``EqConst``/``KinConst`` at several temperatures, on a tensor and on
    Python floats; ``KinConst``'s pre-factor is a host float64 in both"""
    want = getattr(jax_chem, table)(FORMULAE[0])[key]
    got = getattr(chem, table)(FORMULAE[1])[key]
    if table == "kinetic_consts":
        assert isinstance(got.A, float) and got.A == float(want.A)
    _close(got.at(torch.from_numpy(TEMPERATURES)),
            want.at(jnp.asarray(TEMPERATURES)))
    for T in TEMPERATURES:
        _close(np.asarray(got.at(float(T))), want.at(float(T)))


def test_tables_and_specific_gravities_match_jax_package():
    assert chem.AQUEOUS_COMPOUNDS == jax_chem.AQUEOUS_COMPOUNDS
    assert chem.GASEOUS_COMPOUNDS == jax_chem.GASEOUS_COMPOUNDS
    assert chem.DIFFUSION_CONST == jax_chem.DIFFUSION_CONST
    assert (chem.MASS_ACCOMMODATION_COEFFICIENTS
            == jax_chem.MASS_ACCOMMODATION_COEFFICIENTS)
    assert chem._MOLAR_MASS_G_MOL == jax_chem._MOLAR_MASS_G_MOL
    sg = chem.SpecificGravities(FORMULAE[1].constants)
    jax_sg = jax_chem.SpecificGravities(FORMULAE[0].constants)
    for compound in chem._MOLAR_MASS_G_MOL:
        assert sg[compound] == jax_sg[compound]


@pytest.mark.parametrize("compound", ("CO2", "SO2", "NH3", "HNO3", "O3", "H2O2"))
def test_dissociation_factor_matches_jax_package(compound):
    jax_eq, eq = _eq_drop(FORMULAE)
    want = jax_ops.dissociation_factor(compound, jnp.asarray(H_DROP), jax_eq)
    got = ops.dissociation_factor(compound, torch.from_numpy(H_DROP), eq)
    assert got.shape == (N_DROPS,)
    _close(got, want)


def test_acidity_minfun_and_ionic_strength_match_jax_package():
    jax_eq, eq = _eq_drop(FORMULAE)
    K_H2O = FORMULAE[1].constants.K_H2O
    H = torch.from_numpy(H_DROP)
    _close(
        ops.acidity_minfun(H, _torch(CONC), eq, K_H2O),
        jax_ops.acidity_minfun(jnp.asarray(H_DROP), _jnp(CONC), jax_eq, K_H2O),
    )
    _close(
        ops.calc_ionic_strength(H, _torch(CONC), eq, K_H2O),
        jax_ops.calc_ionic_strength(
            jnp.asarray(H_DROP), _jnp(CONC), jax_eq, K_H2O
        ),
    )


def test_equilibrate_H_matches_jax_package():
    jax_eq, eq = _eq_drop(FORMULAE)
    f = FORMULAE[1]
    bounds = {"H_min": float(f.trivia.pH2H(14.0)),
              "H_max": float(f.trivia.pH2H(-1.0))}
    want = np.asarray(jax_ops.equilibrate_H(
        conc=_jnp(CONC), K_drop=jax_eq, K_H2O=f.constants.K_H2O, **bounds
    ))
    got = ops.equilibrate_H(
        conc=_torch(CONC), K_drop=eq, K_H2O=f.constants.K_H2O, **bounds
    ).numpy()
    assert not (np.abs(got / want - 1) > RTOL).any()
    # the root: the residual changes sign across the last bracket
    residual = ops.acidity_minfun(torch.from_numpy(got), _torch(CONC), eq,
                                  f.constants.K_H2O)
    assert (want > bounds["H_min"]).all() and (want < bounds["H_max"]).all()
    assert torch.isfinite(residual).all()


def _dissolution_args(compound, system_type, env_mixing_ratio, alive):
    f = FORMULAE[1]
    const = f.constants
    henry = chem.henry_consts(f)[compound].at(torch.from_numpy(T_CELL))
    jax_henry = jax_chem.henry_consts(FORMULAE[0])[compound].at(
        jnp.asarray(T_CELL)
    )
    jax_eq, eq = _eq_drop(FORMULAE)
    key = {v: k for k, v in chem.GASEOUS_COMPOUNDS.items()}[compound]
    # a gas the drops do not hold yet, in cells of a litre, is taken up
    # beyond what the cells hold
    fresh = env_mixing_ratio.max() < 1e-15
    moles = CONC[key] * VOLUME * (not fresh)
    common = dict(
        compound=compound, dt=0.2, dv=1e-3 if fresh else 1e3,
        system_type=system_type,
        specific_gravity=chem.SpecificGravities(const)[compound],
        const=const, n_cell=N_CELL,
    )
    args = dict(
        moles=moles, multiplicity_f=MULT, droplet_volume=VOLUME, alive=alive,
        env_mixing_ratio_cell=env_mixing_ratio, T_cell=T_CELL, p_cell=P_CELL,
        rhod_cell=RHOD_CELL, cell_of_drop=CELL,
    )
    jax_kwargs = {
        **common, **{k: jnp.asarray(v) for k, v in args.items()},
        "compound_key": key, "henry_const_cell": jax_henry,
        "dissoc_factor_drop": jax_ops.dissociation_factor(
            compound, jnp.asarray(H_DROP), jax_eq),
        "radius_fn": FORMULAE[0].trivia.radius,
    }
    kwargs = {
        **common, **{k: torch.from_numpy(np.asarray(v))
                     for k, v in args.items()},
        "henry_const_cell": henry,
        "dissoc_factor_drop": ops.dissociation_factor(
            compound, torch.from_numpy(H_DROP), eq),
        "radius_fn": f.trivia.radius,
    }
    kwargs["cell_of_drop"] = kwargs["cell_of_drop"].long()
    return jax_kwargs, kwargs


DISSOLUTION_CASES = (
    # (compound, system, env mixing ratio per cell): the Kreidenweis
    # gases; in the last closed cases drops without the gas meet so little
    # of it that the cells' uptake overdraws it, so the reservoir scaling
    # runs
    ("SO2", "open", 4.4e-10),
    ("NH3", "open", 5.9e-11),
    ("O3", "closed", 8.3e-8),
    ("H2O2", "closed", 5.9e-10),
    ("CO2", "closed", 5.5e-4),
    ("HNO3", "closed", 2.2e-10),
    ("SO2", "closed", 1e-16),
    ("NH3", "closed", 1e-17),
)


@pytest.mark.parametrize(
    "compound, system_type, mixing_ratio", DISSOLUTION_CASES,
    ids=[f"{c}-{s}-{m:g}" for c, s, m in DISSOLUTION_CASES],
)
def test_dissolution_step_matches_jax_package(compound, system_type,
                                              mixing_ratio):
    alive = _rng.uniform(0, 1, N_DROPS) > 0.1
    env = np.full(N_CELL, mixing_ratio) * _rng.uniform(0.5, 1.5, N_CELL)
    jax_kwargs, kwargs = _dissolution_args(compound, system_type, env, alive)
    want_moles, want_env = jax_ops.dissolution_step(**jax_kwargs)
    got_moles, got_env = ops.dissolution_step(**kwargs)
    _close(got_moles, want_moles)
    moles0 = kwargs["moles"].numpy()
    assert (got_moles.numpy()[~alive] == moles0[~alive]).all()
    if mixing_ratio < 1e-15:
        # the uptake overdrew every cell's reservoir, which it emptied to
        # within the rounding of env - delta * (env / delta): its sign
        # follows the last bit of the per-cell sum, which the two packages
        # add in different orders
        for result in (got_env.numpy(), want_env):
            np.testing.assert_allclose(result, 0.0, atol=4e-16 * env.max())
        assert (got_moles.numpy()[alive] > 0).all()
    else:
        _close(got_env, want_env)


@pytest.mark.parametrize("rejected", (False, True), ids=("accepted", "rejected"))
def test_oxidation_step_matches_jax_package(rejected):
    """one dt of 0.2 s moves S(IV) to S(VI) in most drops; at dt = 1e6 s
    the update would take S(IV) below zero in most drops, and the ``ok``
    mask keeps their amounts"""
    f = FORMULAE[1]
    jax_eq, eq = _eq_drop(FORMULAE)
    T = torch.from_numpy(T_CELL[CELL])
    kin = {k: v.at(T) for k, v in chem.kinetic_consts(f).items()}
    jax_kin = {k: v.at(jnp.asarray(T_CELL[CELL]))
               for k, v in jax_chem.kinetic_consts(FORMULAE[0]).items()}
    alive = _rng.uniform(0, 1, N_DROPS) > 0.1
    moles = {k: CONC[k] * VOLUME for k in ("O3", "H2O2", "S_IV", "S_VI")}
    dt = 1e6 if rejected else 0.2
    common = dict(k4=13.0 / f.constants.M, dt=dt)
    want = jax_ops.oxidation_step(
        **{f"moles_{k}": jnp.asarray(v) for k, v in moles.items()},
        H_drop=jnp.asarray(H_DROP), droplet_volume=jnp.asarray(VOLUME),
        alive=jnp.asarray(alive), **jax_kin,
        K_SO2=jax_eq["K_SO2"], K_HSO3=jax_eq["K_HSO3"],
        dissoc_factor_SO2=jax_ops.dissociation_factor(
            "SO2", jnp.asarray(H_DROP), jax_eq),
        **common,
    )
    got = ops.oxidation_step(
        **{f"moles_{k}": torch.from_numpy(v) for k, v in moles.items()},
        H_drop=torch.from_numpy(H_DROP), droplet_volume=torch.from_numpy(VOLUME),
        alive=torch.from_numpy(alive), **kin,
        K_SO2=eq["K_SO2"], K_HSO3=eq["K_HSO3"],
        dissoc_factor_SO2=ops.dissociation_factor(
            "SO2", torch.from_numpy(H_DROP), eq),
        **common,
    )
    for g, w in zip(got, want):
        _close(g, w)
    kept = got[2].numpy() == moles["S_IV"]
    assert kept[~alive].all()
    if rejected:
        assert kept[alive].mean() > 0.5
    else:
        assert (got[3].numpy() > moles["S_VI"])[alive].mean() > 0.5
        _close(got[2] + got[3], moles["S_IV"] + moles["S_VI"], rtol=1e-15)


# -- the dynamic ---------------------------------------------------------


def _chem_box(package, system_type, n_sd=16, n_substep=3, dt=5.0, seed=8):
    """a box of drops from haze to cloud sizes with ammonium bisulfate and
    the Kreidenweis gases, in either package"""
    if package == "jax":
        formulae = pysdm_tpu.Formulae(seed=seed)
        env = JaxBox(dt=dt, dv=1.0)
        builder = pysdm_tpu.Builder(n_sd=n_sd, backend=JaxCPU(formulae),
                                    environment=env)
        dynamic = JaxAqueousChemistry
    else:
        formulae = Formulae(seed=seed)
        env = Box(dt=dt, dv=1.0)
        builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
        dynamic = AqueousChemistry
    env["T"] = np.asarray([285.2])
    env["p"] = np.asarray([950e2])
    env["RH"] = np.asarray([0.95])
    env["rhod"] = np.asarray([1.0])
    builder.add_dynamic(dynamic(
        environment_mole_fractions=dict(MOLE_FRACTIONS),
        system_type=system_type, n_substep=n_substep,
        dry_rho=1800.0, dry_molar_mass=0.11511,
    ))
    rng = np.random.default_rng(5)
    r_dry = np.exp(rng.uniform(np.log(2e-8), np.log(2e-7), n_sd))
    dry_moles = 4 / 3 * np.pi * r_dry**3 * 1800.0 / 0.11511
    attributes = {
        "multiplicity": np.floor(np.exp(rng.uniform(np.log(1e6), np.log(1e8), n_sd))),
        "volume": 4 / 3 * np.pi * (r_dry * np.exp(rng.uniform(0.5, 5.0, n_sd))) ** 3,
        "moles_N_mIII": dry_moles,
        "moles_S_VI": dry_moles,
    }
    return builder.build(attributes)


@pytest.mark.parametrize("system_type", ("closed", "open"))
def test_dynamic_matches_jax_package_step_by_step(system_type):
    """every moles_* row and every chem_* env row after each of 6 steps of
    3 substeps; the dry volume follows the S(VI) amount"""
    jax_p = _chem_box("jax", system_type)
    p = _chem_box("torch", system_type)
    keys = [f"moles_{k}" for k in chem.AQUEOUS_COMPOUNDS] + ["dry volume"]
    gases = [f"chem_{c}" for c in chem.GASEOUS_COMPOUNDS.values()]
    initial = {name: p.get_env(name) for name in gases}
    initial["moles_S_VI"] = p.attributes["moles_S_VI"]
    for step in range(7):
        if step:
            jax_p.run(1)
            p.run(1)
        for key in keys:
            _close(p.attributes[key], jax_p.attributes[key])
        for gas in gases:
            _close(p.get_env(gas), jax_p.get_env(gas))
    assert (p.attributes["moles_S_VI"] > initial["moles_S_VI"]).any()
    for gas in gases:
        if system_type == "open":
            np.testing.assert_array_equal(p.get_env(gas), initial[gas])
        else:
            assert p.get_env(gas) != initial[gas]


def test_dynamic_reads_nothing_from_the_device():
    """a step takes no ``.item()``, ``bool()`` or copy of a tensor to the
    host: the dynamic's step runs with those raising"""
    p = _chem_box("torch", "closed")
    (step,) = [fn for name, fn in p._named_step_fns
               if name == "AqueousChemistry"]

    def refuse(*args, **kwargs):
        raise AssertionError("the step read the device")

    names = ("item", "__bool__", "tolist", "numpy", "cpu", "__float__",
             "__int__")
    saved = {name: getattr(torch.Tensor, name) for name in names}
    try:
        for name in names:
            setattr(torch.Tensor, name, refuse)
        p.sim_state = step(p.sim_state)
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert np.isfinite(p.attributes["moles_S_VI"]).all()


def test_pH_and_conc_attributes_match_jax_package():
    jax_p = _chem_box("jax", "closed")
    p = _chem_box("torch", "closed")
    jax_p.run(3)
    p.run(3)
    for name in ("pH", "conc_H", "conc_S_VI", "conc_S_IV", "conc_O3",
                 "conc_N_mIII"):
        _close(p.attributes[name], jax_p.attributes[name])
    assert (p.attributes["pH"] > 0).all() and (p.attributes["pH"] < 8).all()


def test_add_env_field_takes_the_env_dtype_and_device():
    p = _chem_box("torch", "closed")
    for compound in chem.GASEOUS_COMPOUNDS.values():
        row = p.sim_state["env"][f"chem_{compound}"]
        assert row.dtype == torch.float64 and row.device.type == "cpu"
        assert row.shape == (1,)


# -- tests/unit/test_chemistry.py on the port --------------------------------


def _pH_of(conc_S_VI):
    formulae = Formulae()
    const = formulae.constants
    K = {k: torch.tensor([float(v.at(298.15))], dtype=torch.float64)
         for k, v in chem.equilibrium_consts(formulae).items()}
    conc = {k: torch.zeros(1, dtype=torch.float64)
            for k in chem.AQUEOUS_COMPOUNDS}
    conc["S_VI"] = torch.tensor([conc_S_VI], dtype=torch.float64)
    H = ops.equilibrate_H(
        conc=conc, K_drop=K, K_H2O=const.K_H2O,
        H_min=float(formulae.trivia.pH2H(14.0)),
        H_max=float(formulae.trivia.pH2H(-1.0)),
    )
    return float(formulae.trivia.H2pH(H)[0])


def test_pure_water_pH_is_7():
    np.testing.assert_allclose(_pH_of(0.0), 7.0, atol=1e-4)


def test_strong_acid_lowers_pH():
    assert 2.5 < _pH_of(1e-3 * Formulae().constants.M) < 3.1


def _test_chemistry_box(n_substep, dt):
    """``tests/unit/test_chemistry.py``'s ``make_chem_box`` on the port"""
    formulae = Formulae(seed=8)
    env = Box(dt=dt * si.s, dv=1 * si.m**3)
    builder = Builder(n_sd=8, backend=CPU(formulae), environment=env)
    env["T"] = np.asarray([285.2])
    env["p"] = np.asarray([950e2])
    env["RH"] = np.asarray([0.95])
    env["rhod"] = np.asarray([1.0])
    builder.add_dynamic(AqueousChemistry(
        environment_mole_fractions=dict(MOLE_FRACTIONS),
        system_type="closed", n_substep=n_substep,
        dry_rho=1800.0, dry_molar_mass=0.132,
    ))
    attributes = {
        "multiplicity": np.full(8, 1e8),
        "volume": np.full(8, (1.0 * si.um) ** 3 * 4.19),
    }
    return formulae, builder.build(attributes)


def test_dissolution_approaches_henry_equilibrium():
    formulae, particulator = _test_chemistry_box(n_substep=10, dt=10.0)
    particulator.run(50)
    const = formulae.constants
    T = 285.2
    henry_O3 = float(chem.henry_consts(formulae)["O3"].at(T))
    mr = float(particulator.get_env("chem_O3")[0])
    Mc = chem.SpecificGravities(const)["O3"] * const.Md
    cinf = 950e2 / T / (const.Rd / mr + const.R_str / Mc) / Mc
    A_eq = henry_O3 * const.R_str * T * cinf
    np.testing.assert_allclose(particulator.attributes["conc_O3"], A_eq,
                               rtol=2e-2)
    assert mr > 0


def test_oxidation_conserves_sulfur():
    formulae, particulator = _test_chemistry_box(n_substep=5, dt=10.0)
    mult = particulator.attributes["multiplicity"].astype(float)
    const = formulae.constants

    def total_S():
        s4 = particulator.attributes["moles_S_IV"]
        s6 = particulator.attributes["moles_S_VI"]
        gas = float(particulator.get_env("chem_SO2")[0])
        sg = chem.SpecificGravities(const)["SO2"]
        return float(np.sum(mult * (s4 + s6))) + gas / (sg * const.Md)

    s0 = total_S()
    particulator.run(30)
    np.testing.assert_allclose(total_S(), s0, rtol=1e-10)
    assert particulator.attributes["moles_S_VI"].sum() > 0

