"""Moist-air thermodynamics shared by environments (port of
``pysdm_tpu/environments/impl/moist.py``; reference
``PySDM/environments/impl/moist.py``).

The reference's current/predicted double buffer is a pair of key groups in
the env-state dict (``thd`` vs ``pred_thd`` ...); the swap is a commit
function the builder runs after every dynamic.
"""

import torch


def recalc_thermo(formulae, thd, qv, rhod):
    """T, p, RH (+ air density and dynamic viscosity) from the state triplet
    (reference ``Moist._recalculate_temperature_pressure_relative_humidity``)"""
    f = formulae
    T = f.state_variable_triplet.T(rhod, thd)
    p = f.state_variable_triplet.p(rhod, T, qv)
    RH = f.state_variable_triplet.pv(p, qv) / f.saturation_vapour_pressure.pvs_water(T)
    air_density = f.state_variable_triplet.rho_of_rhod_and_water_vapour_mixing_ratio(
        rhod, qv
    )
    air_viscosity = f.air_dynamic_viscosity.eta_air(T)
    return T, p, RH, air_density, air_viscosity


def moist_commit(env):
    """predicted -> current swap (reference ``Moist.notify``), tracking the
    liquid-water delta the parcel hydrostatics needs"""
    out = dict(env)
    out["delta_qv_cond"] = env["qv"] - env["pred_qv"]
    out["thd"] = env["pred_thd"]
    out["qv"] = env["pred_qv"]
    out["rhod"] = env["pred_rhod"]
    return out


def moist_env_state(formulae, thd, qv, rhod, dv, **courants):
    """the env-state dict of a kinematic (MPDATA-advected) environment from
    its initial thd, qv and rhod tensors: the current, predicted and
    advected key groups, the thermodynamics, the courant fields given and
    the clock"""
    T, p, RH, air_density, air_viscosity = recalc_thermo(formulae, thd, qv, rhod)
    return {
        "thd": thd, "qv": qv, "rhod": rhod,
        "pred_thd": thd, "pred_qv": qv, "pred_rhod": rhod,
        "mpdata_thd": thd, "mpdata_qv": qv,
        "T": T, "p": p, "RH": RH,
        "air_density": air_density, "air_viscosity": air_viscosity,
        "m_d": rhod * dv,
        "delta_qv_cond": torch.zeros_like(qv),
        **courants,
        "t": torch.zeros((), dtype=thd.dtype, device=thd.device),
    }


def moist_sync(formulae, env):
    """advected -> predicted state, with the thermodynamics recomputed from
    it (a kinematic environment's sync step, after MPDATA)"""
    out = dict(env)
    out["pred_qv"] = env["mpdata_qv"]
    out["pred_thd"] = env["mpdata_thd"]
    out["pred_rhod"] = env["rhod"]
    (out["T"], out["p"], out["RH"], out["air_density"],
     out["air_viscosity"]) = recalc_thermo(
        formulae, out["pred_thd"], out["pred_qv"], out["pred_rhod"]
    )
    return out
