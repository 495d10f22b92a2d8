"""Derived-attribute computation (port of ``pysdm_tpu/impl/attributes.py``)
for the names the liquid-phase slices read: multiplicity, cell id, cell
origin, position in cell, signed water mass, water mass, volume, radius,
sqrt radius, area, dry radius, kappa, dry volume organic fraction,
Reynolds number, critical volume (also "... neglecting temperature
variations"), wet to critical volume ratio (likewise), critical
saturation, the terminal (relative fall) velocity of the chosen variant,
or momentum / mass where the state keeps a "relative fall momentum" row,
the cooling rate, the chemistry attributes ("pH", "conc_H" and the aqueous
concentrations "conc_<compound>") and the isotope attributes ("delta_<heavy
isotope>", "moles light water"). Stored extensive and max-merged rows
resolve by name ("immersed surface area", "freezing temperature",
"temperature of last freezing", "cooling rate prev T", "moles_<...>"). Any
other name raises ``KeyError``, as in the JAX package.

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
        if name.startswith("delta_"):
            # heavy-to-light isotopic ratio against the VSMOW reference
            heavy = name[len("delta_"):]
            light = "1H" if heavy.endswith("H") else "16O"
            ratio = state.ext(f"moles_{heavy}") / state.ext(f"moles_{light}")
            return f.trivia.isotopic_ratio_2_delta(
                ratio, getattr(f.constants, f"VSMOW_R_{heavy}")
            )
        if name.startswith("conc_") and name != "conc_H":
            # aqueous concentration: mole amount over the drop's volume
            return state.ext("moles_" + name[len("conc_"):]) / self.get(
                state, "volume"
            )
        if name == "moles light water":
            # moles of the light isotopologue (1H2 16O) from the water mass
            # less the heavy isotopologues' masses (reference
            # ``attributes/isotopes/moles.py`` MolesLightWater)
            const = f.constants
            mass = self.get(state, "water mass")
            for heavy, M_heavy in (
                ("2H", const.M_1H + const.M_2H + const.M_16O),
                ("3H", const.M_1H + const.M_3H + const.M_16O),
                ("17O", 2 * const.M_1H + const.M_17O),
                ("18O", 2 * const.M_1H + const.M_18O),
            ):
                if state.has_ext(f"moles_{heavy}"):
                    mass = mass - state.ext(f"moles_{heavy}") * M_heavy
            return mass / (2 * const.M_1H + const.M_16O)
        if name == "pH":
            # the equilibrium hydrogen-ion concentration from
            # electroneutrality, by the AqueousChemistry dynamic's bisection
            # (reference ``attributes/chemistry/acidity.py``); an empty slot
            # takes the volume 1 (the ``Acidity`` product takes 1e-30)
            from ..dynamics.impl import chemistry_utils as chem
            from ..ops import chemistry as chem_ops

            if env is None:
                raise KeyError("pH requires the env (cell T)")
            volume = self.get(state, "volume")
            safe_vol = torch.where(state.alive, volume, torch.ones_like(volume))
            conc = {
                key: state.ext(f"moles_{key}") / safe_vol
                for key in chem.AQUEOUS_COMPOUNDS
                if len(chem.AQUEOUS_COMPOUNDS[key]) > 1
            }
            K = {
                k: _env_at_drops(v.at(env["T"]), state.cell_id)
                for k, v in chem.equilibrium_consts(f).items()
            }
            H = chem_ops.equilibrate_H(
                conc=conc,
                K_drop=K,
                K_H2O=f.constants.K_H2O,
                H_min=float(f.trivia.pH2H(14.0)),
                H_max=float(f.trivia.pH2H(-1.0)),
            )
            return f.trivia.H2pH(H)
        if name == "conc_H":
            # hydrogen-ion concentration from the pH (reference
            # ``attributes/chemistry/hydrogen_ion_concentration.py``)
            return f.trivia.pH2H(self.get(state, "pH", env))
        if name in ("terminal velocity", "relative fall velocity"):
            # relative fall velocity equals terminal velocity unless the
            # state keeps a momentum row
            if state.has_ext("relative fall momentum"):
                return state.ext("relative fall momentum") / self.get(
                    state, "water mass"
                )
            return self.terminal_velocity(state)
        raise KeyError(f"unknown attribute: {name}")

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
