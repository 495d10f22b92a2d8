"""Moist-air thermodynamics shared by environments (port of
``pysdm_tpu/environments/impl/moist.py``; reference
``PySDM/environments/impl/moist.py``).

The reference's current/predicted double buffer is a pair of key groups in
the env-state dict (``thd`` vs ``pred_thd`` ...); the swap is a commit
function the builder runs after every dynamic.
"""


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
