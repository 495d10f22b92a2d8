"""dynamics (process operators): coalescence (box slice), ambient
thermodynamics and condensation (parcel slice), Eulerian advection and
displacement (2D warm-rain slice), collision with breakup (breakup box
slice)"""
from .ambient_thermodynamics import AmbientThermodynamics
from .collisions.collision import Breakup, Collision, Coalescence
from .condensation import Condensation
from .displacement import Displacement
from .eulerian_advection import EulerianAdvection
