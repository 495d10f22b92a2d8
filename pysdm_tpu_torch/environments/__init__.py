"""environments (parity: reference PySDM/environments/): ``Box``,
``Parcel``, ``Kinematic1D`` and ``Kinematic2D``"""
from .box import Box
from .kinematic_1d import Kinematic1D
from .kinematic_2d import Kinematic2D
from .parcel import Parcel
