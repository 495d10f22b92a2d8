"""Dry-aerosol mixture composition helper (port of
``pysdm_tpu/initialisation/aerosol_composition.py``; reference
``PySDM/initialisation/aerosol_composition/dry_aerosol.py``): a
multi-compound aerosol (density, molar mass, solubility and ionic
dissociation phi per compound) with its kappa under each surface-tension
model's assumption. Plain Python on the host."""

SURFACE_TENSION_VARIANTS = (
    "Constant",
    "CompressedFilmOvadnevaite",
    "CompressedFilmRuehl",
    "SzyszkowskiLangmuir",
)


class DryAerosolMixture:
    def __init__(
        self,
        *,
        compounds,
        densities,
        molar_masses,
        is_soluble,
        ionic_dissociation_phi,
    ):
        self._modes = None
        self.compounds = tuple(compounds)
        self.densities = dict(densities)
        self.molar_masses = dict(molar_masses)
        self.is_soluble = dict(is_soluble)
        self.ionic_dissociation_phi = dict(ionic_dissociation_phi)

    @property
    def modes(self):
        return self._modes

    @modes.setter
    def modes(self, value):
        self._modes = value

    def volume_fractions(self, mass_fractions):
        denom = sum(
            mass_fractions[i] / self.densities[i] for i in self.compounds
        )
        return {
            k: (mass_fractions[k] / self.densities[k]) / denom
            for k in self.compounds
        }

    def f_soluble_volume(self, mass_fractions):
        volfrac = self.volume_fractions(mass_fractions)
        return sum(self.is_soluble[k] * volfrac[k] for k in self.compounds)

    def volfrac_just_soluble(self, volfrac, soluble=True):
        if soluble:
            masked = {k: self.is_soluble[k] * volfrac[k] for k in self.compounds}
        else:
            masked = {
                k: (not self.is_soluble[k]) * volfrac[k] for k in self.compounds
            }
        denom = sum(masked.values())
        if denom == 0.0:
            return {k: 0.0 for k in self.compounds}
        return {k: masked[k] / denom for k in self.compounds}

    def kappa(self, mass_fractions, water_molar_volume):
        """kappa under each surface-tension model's solubility assumption:
        Constant counts all compounds as dissolved; the film models count
        only the soluble (non-organic) fraction"""
        volfrac = self.volume_fractions(mass_fractions)
        molar_volumes = {
            i: self.molar_masses[i] / self.densities[i] for i in self.compounds
        }
        volfrac_soluble = self.volfrac_just_soluble(volfrac, soluble=True)
        all_soluble_ns = sum(
            self.ionic_dissociation_phi[i] * volfrac[i] / molar_volumes[i]
            for i in self.compounds
        )
        part_soluble_ns = self.f_soluble_volume(mass_fractions) * sum(
            self.ionic_dissociation_phi[i]
            * volfrac_soluble[i]
            / molar_volumes[i]
            for i in self.compounds
        )
        result = {}
        for st in SURFACE_TENSION_VARIANTS:
            if st == "Constant":
                result[st] = all_soluble_ns * water_molar_volume
            else:
                result[st] = part_soluble_ns * water_molar_volume
        return result

    def nu_org(self, mass_fractions):
        """molar volume of the organic (insoluble) fraction"""
        volfrac = self.volume_fractions(mass_fractions)
        molar_volumes = {
            i: self.molar_masses[i] / self.densities[i] for i in self.compounds
        }
        volfrac_org = self.volfrac_just_soluble(volfrac, soluble=False)
        return sum(
            volfrac_org[i] * molar_volumes[i] for i in self.compounds
        )
