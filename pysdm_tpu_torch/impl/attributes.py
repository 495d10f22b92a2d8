"""Derived-attribute computation (port of ``pysdm_tpu/impl/attributes.py``)
for the names the liquid-phase slices read: multiplicity, cell id, cell
origin, position in cell, signed water mass, water mass, volume, radius,
area, dry radius, kappa, dry volume organic fraction, Reynolds number,
critical volume (also "... neglecting temperature variations"), wet to
critical volume ratio (likewise), critical saturation and the terminal
(relative fall) velocity of the chosen variant. Stored extensive rows
resolve by name. Derived attributes of the ice, chemistry and isotope
slices raise ``KeyError``.

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

# max-merged attributes of the JAX package (freezing records); they come with
# ice, chemistry and isotopes (other dynamics)
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
        if name == "volume":
            return f.particle_shape_and_density.mass_to_volume(
                state.ext("signed water mass")
            )
        if name == "radius":
            return f.trivia.radius(self.get(state, "volume"))
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
            # the reference registers zeros when ventilation is Neglect (the
            # coefficient is then 1 whatever Re is); Formulae admits no other
            # ventilation variant yet
            if f.ventilation.variant != "Neglect":
                raise NotImplementedError(
                    "the Reynolds number of ventilation variants other than"
                    " Neglect come with the rest of physics/ (ROADMAP)"
                )
            return torch.zeros_like(state.ext("signed water mass"))
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
