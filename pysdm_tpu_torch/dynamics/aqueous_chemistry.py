"""AqueousChemistry dynamic (port of ``pysdm_tpu/dynamics/aqueous_chemistry.py``;
reference ``PySDM/dynamics/aqueous_chemistry.py``): Hoppel-gap-resolving
aqueous-phase chemistry, Henry-law dissolution of trace gases with kinetic
uptake and S(IV) -> S(VI) oxidation by O3 and H2O2, with per-droplet pH
from electroneutrality. The gas-phase mixing ratios are env rows
(``chem_<compound>``, ``Builder.add_env_field``), closed- or open-system.

A step runs ``n_substep`` substeps in a Python loop (the JAX package's
``fori_loop``); each solves the pH twice (``ops/chemistry.py``
``equilibrate_H``), dissolves the six gases and oxidizes once. The dry
volume then follows the S(VI) amount. Nothing of a step is read back to
the host.
"""

from collections import namedtuple

import torch

from .impl import chemistry_utils as chem
from ..ops import chemistry as chem_ops

DEFAULTS = namedtuple(
    "_", ("pH_min", "pH_max", "pH_rtol", "ionic_strength_threshold")
)(pH_min=-1.0, pH_max=14.0, pH_rtol=1e-6, ionic_strength_threshold=0.02)


class AqueousChemistry:
    def __init__(
        self,
        *,
        environment_mole_fractions,
        system_type,
        n_substep,
        dry_rho=None,
        dry_molar_mass=None,
        ionic_strength_threshold=None,
        pH_H_min=None,
        pH_H_max=None,
        pH_rtol=DEFAULTS.pH_rtol,
    ):
        assert system_type in ("open", "closed")
        assert isinstance(n_substep, int) and n_substep > 0
        self.environment_mole_fractions = environment_mole_fractions
        self.system_type = system_type
        self.n_substep = n_substep
        self.dry_rho = dry_rho
        self.dry_molar_mass = dry_molar_mass
        self.ionic_strength_threshold = ionic_strength_threshold
        self.pH_H_min = pH_H_min
        self.pH_H_max = pH_H_max
        self.pH_rtol = pH_rtol
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        formulae = builder.formulae
        const = formulae.constants
        self.specific_gravities = chem.SpecificGravities(const)
        if self.ionic_strength_threshold is None:
            self.ionic_strength_threshold = (
                DEFAULTS.ionic_strength_threshold * const.M
            )
        if self.pH_H_max is None:
            self.pH_H_max = float(formulae.trivia.pH2H(DEFAULTS.pH_min))
        if self.pH_H_min is None:
            self.pH_H_min = float(formulae.trivia.pH2H(DEFAULTS.pH_max))
        for key in chem.AQUEOUS_COMPOUNDS:
            builder.request_attribute(f"moles_{key}")
        n_cell = self.particulator.mesh.n_cell
        for compound in chem.GASEOUS_COMPOUNDS.values():
            mixing_ratio = float(
                formulae.trivia.mole_fraction_2_mixing_ratio(
                    self.environment_mole_fractions[compound],
                    self.specific_gravities[compound],
                )
            )
            builder.add_env_field(
                f"chem_{compound}", [mixing_ratio] * n_cell
            )
        self.environment_mole_fractions = None

    def make_step(self, particulator):
        formulae = particulator.formulae
        const = formulae.constants
        dt_sub = particulator.dt / self.n_substep
        n_substep = self.n_substep
        n_cell = particulator.mesh.n_cell
        dv = particulator.mesh.dv
        system_type = self.system_type
        sg = self.specific_gravities
        H_min, H_max = self.pH_H_min, self.pH_H_max
        ionic_threshold = self.ionic_strength_threshold
        henry = chem.henry_consts(formulae)
        eq = chem.equilibrium_consts(formulae)
        kin = chem.kinetic_consts(formulae)
        k4 = 13.0 / const.M
        K_H2O = const.K_H2O

        def step(sim):
            particles = sim["particles"]
            env = dict(sim["env"])
            mult_f = particles.multiplicity.to(env["T"].dtype)
            alive = particles.multiplicity > 0
            cell = particles.cell_id.long()
            T_c = env["T"]

            kin_c = {k: v.at(T_c) for k, v in kin.items()}
            henry_c = {k: v.at(T_c) for k, v in henry.items()}
            eq_drop = {k: v.at(T_c)[cell] for k, v in eq.items()}
            eq_drop["K_H2O"] = K_H2O
            moles = {
                key: particles.ext(f"moles_{key}")
                for key in chem.AQUEOUS_COMPOUNDS
            }
            # the water mass does not change across the substeps
            volume = formulae.particle_shape_and_density.mass_to_volume(
                particles.ext("signed water mass").abs()
            )
            safe_vol = torch.where(alive, volume, 1e-30)

            def pH_solve():
                conc = {k: v / safe_vol for k, v in moles.items()}
                H = chem_ops.equilibrate_H(
                    conc=conc, K_drop=eq_drop, K_H2O=K_H2O,
                    H_min=H_min, H_max=H_max,
                )
                return conc, H

            for _ in range(n_substep):
                conc, H = pH_solve()
                ionic = chem_ops.calc_ionic_strength(H, conc, eq_drop, K_H2O)
                do_chem = alive & (ionic <= ionic_threshold)
                for key, compound in chem.GASEOUS_COMPOUNDS.items():
                    gas = f"chem_{compound}"
                    moles[key], env[gas] = chem_ops.dissolution_step(
                        compound=compound,
                        moles=moles[key],
                        multiplicity_f=mult_f,
                        droplet_volume=volume,
                        alive=do_chem,
                        env_mixing_ratio_cell=env[gas],
                        henry_const_cell=henry_c[compound],
                        dissoc_factor_drop=chem_ops.dissociation_factor(
                            compound, H, eq_drop
                        ),
                        T_cell=T_c,
                        p_cell=env["p"],
                        rhod_cell=env["rhod"],
                        cell_of_drop=cell,
                        dt=dt_sub,
                        dv=dv,
                        system_type=system_type,
                        specific_gravity=sg[compound],
                        const=const,
                        n_cell=n_cell,
                        radius_fn=formulae.trivia.radius,
                    )

                # re-equilibrate pH, then oxidize
                _, H = pH_solve()
                (
                    moles["O3"],
                    moles["H2O2"],
                    moles["S_IV"],
                    moles["S_VI"],
                ) = chem_ops.oxidation_step(
                    moles_O3=moles["O3"],
                    moles_H2O2=moles["H2O2"],
                    moles_S_IV=moles["S_IV"],
                    moles_S_VI=moles["S_VI"],
                    H_drop=H,
                    droplet_volume=volume,
                    alive=do_chem,
                    k0=kin_c["k0"][cell],
                    k1=kin_c["k1"][cell],
                    k2=kin_c["k2"][cell],
                    k3=kin_c["k3"][cell],
                    k4=k4,
                    K_SO2=eq_drop["K_SO2"],
                    K_HSO3=eq_drop["K_HSO3"],
                    dissoc_factor_SO2=chem_ops.dissociation_factor(
                        "SO2", H, eq_drop
                    ),
                    dt=dt_sub,
                )

            extensive = particles.extensive.clone()
            for key, value in moles.items():
                extensive[particles.ext_names.index(f"moles_{key}")] = value
            # the dry volume grows with oxidation (reference
            # ``attributes/physics/dry_volume.py`` DryVolumeDynamic)
            if self.dry_rho is not None and particles.has_ext("dry volume"):
                extensive[particles.ext_names.index("dry volume")] = (
                    moles["S_VI"] * (self.dry_molar_mass / self.dry_rho)
                )
            return {
                **sim,
                "particles": particles.replace(extensive=extensive),
                "env": env,
            }

        return step
