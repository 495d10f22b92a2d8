"""initialisation helpers (NumPy, host side)"""

from . import spectra
from .discretise_multiplicities import discretise_multiplicities
from .equilibrate_wet_radii import equilibrate_wet_radii
from .init_fall_momenta import init_fall_momenta
from .aerosol_composition import DryAerosolMixture
