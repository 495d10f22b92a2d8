"""dynamics (process operators): coalescence (box slice), ambient
thermodynamics and condensation (parcel slice), Eulerian advection and
displacement (2D warm-rain slice; the 1D column's MPDATA_1D coupling),
collision with breakup (breakup box slice), freezing and vapour deposition
on ice (ice slice), seeding and relaxed velocity, aqueous chemistry and
the isotopic fractionation stub"""
from .ambient_thermodynamics import AmbientThermodynamics
from .aqueous_chemistry import AqueousChemistry
from .collisions.collision import Breakup, Collision, Coalescence
from .condensation import Condensation
from .displacement import Displacement
from .eulerian_advection import EulerianAdvection
from .freezing import Freezing
from .isotopic_fractionation import IsotopicFractionation
from .relaxed_velocity import RelaxedVelocity
from .seeding import Seeding
from .vapour_deposition_on_ice import VapourDepositionOnIce
