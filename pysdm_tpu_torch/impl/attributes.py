"""Derived-attribute computation (port of ``pysdm_tpu/impl/attributes.py``)
for the names the liquid-phase slices read: multiplicity, cell id, cell
origin, position in cell, signed water mass, water mass, volume, radius,
sqrt radius, area, dry radius, kappa, dry volume organic fraction,
Reynolds number, critical volume (also "... neglecting temperature
variations"), wet to critical volume ratio (likewise), critical
saturation, the terminal (relative fall) velocity of the chosen variant,
or momentum / mass where the state keeps a "relative fall momentum" row,
and the cooling rate. Stored extensive and max-merged rows resolve by name
("immersed surface area", "freezing temperature", "temperature of last
freezing", "cooling rate prev T"). Derived attributes of the chemistry and
isotope slices raise ``KeyError``.

Names that depend on the ambient state (critical volume and what reads it)
read the cell's env row at each drop by a gather, ``env_row[cell_id]`` (the
JAX package rides a one-hot matmul there because TPU gathers are slow).
"""

import torch

# attribute names stored as extensive rows (conserved sums under coalescence)
EXTENSIVE_NAMES = (
    "signed water mass",
    "water mass",  # alias: stored signed
    "dry volume",
    "dry volume organic",
    "kappa times dry volume",
    "immersed surface area",
    "heat",
    "moles_1H",
    "moles_2H",
    "moles_3H",
    "moles_16O",
    "moles_17O",
    "moles_18O",
    "relative fall momentum",
    "moles_N_mIII",
    "moles_N_V",
    "moles_S_IV",
    "moles_S_VI",
    "moles_C_IV",
    "moles_O3",
    "moles_H2O2",
)

# max-merged attributes (the freezing records): the singular freezing
# temperature; the ambient T at a drop's last freezing, NaN while it is
# unfrozen; the ambient T of the previous step, behind "cooling rate"
MAXIMUM_NAMES = (
    "freezing temperature",
    "temperature of last freezing",
    "cooling rate prev T",
)


def canonical_ext_name(name):
    return "signed water mass" if name == "water mass" else name


def _env_at_drops(env_row, cell_id):
    """a per-cell env row at each drop"""
    return env_row[cell_id.long()]


class AttributeResolver:
    """computes a requested attribute from a ParticleState + Formulae"""

    def __init__(self, formulae):
        self.formulae = formulae
        self.dt = None  # set by Builder.build (the cooling rate needs it)

    def get(self, state, name, env=None):
        f = self.formulae
        if name in ("multiplicity", "n"):
            return state.multiplicity
        if name == "cell id":
            return state.cell_id
        if name == "cell origin":
            return state.cell_origin
        if name == "position in cell":
            return state.position_in_cell
        if name == "water mass":
            return state.ext("signed water mass").abs()
        if state.has_ext(name):
            return state.ext(name)
        if state.has_max(name):
            return state.max_attr(name)
        if name == "volume":
            return f.particle_shape_and_density.mass_to_volume(
                state.ext("signed water mass")
            )
        if name == "radius":
            return f.trivia.radius(self.get(state, "volume"))
        if name == "sqrt radius":
            return torch.sqrt(self.get(state, "radius"))
        if name == "area":
            return f.trivia.area(self.get(state, "radius"))
        if name == "dry radius":
            return f.trivia.radius(state.ext("dry volume"))
        if name == "kappa":
            return state.ext("kappa times dry volume") / state.ext("dry volume")
        if name == "dry volume organic fraction":
            if state.has_ext("dry volume organic"):
                return state.ext("dry volume organic") / state.ext("dry volume")
            return torch.zeros_like(state.ext("signed water mass"))
        if name == "Reynolds number":
            # Re = 2 r rho_air |v_rel| / eta_air, from the relative fall
            # velocity and the cell's air density and viscosity (JAX
            # ``impl/attributes.py:119-141``); zeros under ventilation
            # Neglect (the coefficient is then 1 whatever Re is), as the
            # reference registers, and where the env has no air density
            if (
                f.ventilation.variant == "Neglect"
                or env is None
                or "air_density" not in env
            ):
                return torch.zeros_like(state.ext("signed water mass"))
            return f.particle_shape_and_density.reynolds_number(
                radius=self.get(state, "radius"),
                velocity_wrt_air=self.get(state, "relative fall velocity"),
                dynamic_viscosity=_env_at_drops(
                    env["air_viscosity"], state.cell_id
                ),
                density=_env_at_drops(env["air_density"], state.cell_id),
            )
        if name in (
            "critical volume",
            "critical volume neglecting temperature variations",
        ):
            # kappa-Koehler critical wet volume at the ambient cell
            # temperature (reference ``attributes/physics/critical_volume.py``)
            if env is None:
                raise KeyError("critical volume requires the env (cell T)")
            T = _env_at_drops(env["T"], state.cell_id)
            v_dry = state.ext("dry volume")
            sgm = f.surface_tension.sigma(
                T,
                self.get(state, "volume"),
                v_dry,
                self.get(state, "dry volume organic fraction"),
            )
            r_cr = f.hygroscopicity.r_cr(
                self.get(state, "kappa"), v_dry / f.constants.PI_4_3, T, sgm
            )
            return f.trivia.volume(r_cr)
        if name in (
            "wet to critical volume ratio",
            "wet to critical volume ratio neglecting temperature variations",
        ):
            return self.get(state, "volume") / self.get(
                state, "critical volume", env
            )
        if name == "critical saturation":
            # saturation at the critical radius (reference
            # ``attributes/physics/critical_supersaturation.py``)
            if env is None:
                raise KeyError("critical saturation requires the env (cell T)")
            T = _env_at_drops(env["T"], state.cell_id)
            v_dry = state.ext("dry volume")
            rd3 = v_dry / f.constants.PI_4_3
            sgm = f.surface_tension.sigma(
                T, self.get(state, "critical volume", env), v_dry,
                self.get(state, "dry volume organic fraction"),
            )
            kappa = self.get(state, "kappa")
            r_cr = f.hygroscopicity.r_cr(kappa, rd3, T, sgm)
            return f.hygroscopicity.RH_eq(r_cr, T, kappa, rd3, sgm)
        if name == "cooling rate":
            # (T_prev - T_now) / dt, positive while cooling; NaN before the
            # first step has recorded T_prev (reference
            # ``attributes/ice/cooling_rate.py``)
            if env is None:
                raise KeyError("cooling rate requires the env (cell T)")
            prev_T = state.max_attr("cooling rate prev T")
            return (prev_T - _env_at_drops(env["T"], state.cell_id)) / self.dt
        if name in ("terminal velocity", "relative fall velocity"):
            # relative fall velocity equals terminal velocity unless the
            # state keeps a momentum row
            if state.has_ext("relative fall momentum"):
                return state.ext("relative fall momentum") / self.get(
                    state, "water mass"
                )
            return self.terminal_velocity(state)
        raise KeyError(f"attribute {name!r} is not resolved by the port yet")

    def terminal_velocity(self, state):
        """the terminal velocity of the Formulae's variant
        (``pysdm_tpu/impl/attributes.py:290-303``)"""
        from ..dynamics import terminal_velocity

        radius = self.get(state, "radius")
        f = self.formulae
        variant = f.terminal_velocity.variant
        if variant == "GunnKinzer1949":
            return terminal_velocity.gunn_kinzer_v_term(radius)
        if variant == "PowerSeries":
            return terminal_velocity.PowerSeries()(radius)
        return f.terminal_velocity.v_term(radius)
