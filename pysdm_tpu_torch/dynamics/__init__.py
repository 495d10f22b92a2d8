"""dynamics (process operators): coalescence (box slice), ambient
thermodynamics and condensation (parcel slice)"""
from .ambient_thermodynamics import AmbientThermodynamics
from .collisions.collision import Collision, Coalescence
from .condensation import Condensation
