"""Aqueous-chemistry products (port of ``pysdm_tpu/products/chemistry.py``;
reference ``PySDM/products/aqueous_chemistry/``): the per-cell mean pH, the
aqueous and gaseous mole fractions, the total dry mass mixing ratio and
the dry-radius-binned aqueous mass spectra.

The per-cell sums are the port's moment sums, in float64 in a fixed order
(``ops/moments.py``), on the state's device; ``get()`` returns NumPy.
"""

import numpy as np
import torch

from .impl import MomentProduct, Product
from ..dynamics.impl import chemistry_utils as chem
from ..ops import chemistry as chem_ops
from ..ops.moments import cell_sums
from ..physics.si import si


class Acidity(MomentProduct):
    """volume- (or number-) weighted mean pH per cell over the drops within
    ``radius_range`` (reference ``acidity.py``); NaN in a cell without such
    drops. An empty slot takes the volume 1e-30 in the pH solve"""

    def __init__(self, *, radius_range=(0, np.inf), weighting="volume",
                 name=None, unit="dimensionless"):
        super().__init__(name=name or "pH", unit=unit)
        self.radius_range = radius_range
        self.weighting_rank = {"volume": 1, "number": 0}[weighting]

    def _impl(self, **kwargs):
        p = self.particulator
        formulae = p.formulae
        particles = p.particles
        resolver = p._resolver
        volume = resolver.get(particles, "volume")
        alive = particles.alive
        safe_vol = torch.where(alive, volume, 1e-30)
        conc = {
            key: particles.ext(f"moles_{key}") / safe_vol
            for key in chem.AQUEOUS_COMPOUNDS
        }
        cell = particles.cell_id.long()
        T = p.sim_state["env"]["T"]
        K = {
            k: v.at(T)[cell]
            for k, v in chem.equilibrium_consts(formulae).items()
        }
        H = chem_ops.equilibrate_H(
            conc=conc,
            K_drop=K,
            K_H2O=formulae.constants.K_H2O,
            H_min=float(formulae.trivia.pH2H(14.0)),
            H_max=float(formulae.trivia.pH2H(-1.0)),
        )
        pH = formulae.trivia.H2pH(H).to(torch.float64)
        radius = resolver.get(particles, "radius")
        weight = particles.multiplicity.to(torch.float64)
        if self.weighting_rank:
            weight = weight * volume.to(torch.float64)
        mask = (
            alive
            & (radius >= self.radius_range[0])
            & (radius < self.radius_range[1])
        )
        n_cell = p.mesh.n_cell
        num = cell_sums(torch.where(mask, weight * pH, 0.0), cell, n_cell)
        den = cell_sums(torch.where(mask, weight, 0.0), cell, n_cell)
        mean = torch.where(
            den > 0, num / den.clamp(min=1e-300), torch.nan
        )
        return mean.cpu().numpy()


class AqueousMoleFraction(MomentProduct):
    """total aqueous moles of a compound per mole of dry air"""

    def __init__(self, key, name=None, unit="dimensionless"):
        super().__init__(name=name or f"aq_{key}", unit=unit)
        self.key = key

    def _impl(self, **kwargs):
        p = self.particulator
        _, moles = self._download_moment(
            attr=f"moles_{self.key}", rank=1, skip_division_by_m0=True
        )
        dry_air_moles = p.get_env("rhod") * p.mesh.dv / p.formulae.constants.Md
        return moles / dry_air_moles


class GaseousMoleFraction(Product):
    """trace-gas mole fraction from the env mixing ratio"""

    def __init__(self, key, name=None, unit="dimensionless"):
        super().__init__(name=name or f"gas_{key}", unit=unit)
        self.key = key
        self.specific_gravity = None

    def register(self, builder):
        super().register(builder)
        self.specific_gravity = chem.SpecificGravities(
            builder.formulae.constants
        )[chem.GASEOUS_COMPOUNDS[self.key]]

    def _impl(self, **kwargs):
        compound = chem.GASEOUS_COMPOUNDS[self.key]
        mixing_ratio = self.particulator.get_env(f"chem_{compound}")
        return mixing_ratio / self.specific_gravity / (1 + mixing_ratio)


class TotalDryMassMixingRatio(MomentProduct):
    """total dry-aerosol mass per mass of dry air (reference
    ``total_dry_mass_mixing_ratio.py``): density x total dry volume / dv /
    rhod"""

    def __init__(self, density, name=None, unit="kg/kg"):
        super().__init__(name=name or "total dry mass mixing ratio", unit=unit)
        self.density = density

    def _impl(self, **kwargs):
        _, total_dry_volume = self._download_moment(
            attr="dry volume", rank=1, skip_division_by_m0=True
        )
        p = self.particulator
        return self.density * total_dry_volume / p.mesh.dv / p.get_env("rhod")


class AqueousMassSpectrum(Product):
    """dry-radius-binned aqueous compound mass concentration per
    d(log10 diameter) (reference ``aqueous_mass_spectrum.py``)"""

    def __init__(self, *, key, dry_radius_bins_edges, specific=False,
                 name=None, unit="kg/m^3"):
        super().__init__(name=name or f"aqueous {key} mass spectrum", unit=unit)
        self.key = key
        self.dry_radius_bins_edges = np.asarray(dry_radius_bins_edges)
        self.molar_mass = (
            chem._MOLAR_MASS_G_MOL[chem.AQUEOUS_COMPOUNDS[key][0]]
            * si.g / si.mole
        )
        self.specific = specific
        self.dry_volume_bins_edges = None

    def register(self, builder):
        super().register(builder)
        self.dry_volume_bins_edges = np.asarray(
            builder.formulae.trivia.volume(self.dry_radius_bins_edges)
        )
        self.shape = (
            *self.particulator.mesh.grid,
            len(self.dry_volume_bins_edges) - 1,
        )

    def _impl(self, **kwargs):
        m0, m1 = self.particulator.spectrum_moments(
            attr_name=f"moles_{self.key}",
            rank=1,
            attr_bins=self.dry_volume_bins_edges,
            filter_attr="dry volume",
        )
        vals = (m1 * m0).T  # total moles per bin per cell
        d_log10_d = np.diff(np.log10(2 * self.dry_radius_bins_edges))
        vals = vals * self.molar_mass / d_log10_d / self.particulator.mesh.dv
        if self.specific:
            rhod = self.particulator.get_env("rhod").reshape(-1, 1)
            vals = vals / rhod
        return vals

    def shape_for_output(self, result):
        return self.shape


class SpecificAqueousMassSpectrum(AqueousMassSpectrum):
    def __init__(self, key, dry_radius_bins_edges, name=None,
                 unit="dimensionless"):
        super().__init__(
            key=key,
            dry_radius_bins_edges=dry_radius_bins_edges,
            specific=True,
            name=name or f"specific aqueous {key} mass spectrum",
            unit=unit,
        )
