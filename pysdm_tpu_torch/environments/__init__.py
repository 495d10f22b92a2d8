"""environments (parity: reference PySDM/environments/): ``Box``,
``Parcel`` and ``Kinematic2D``; the 1D column comes with the 1D column
(config #4) in ROADMAP"""
from .box import Box
from .kinematic_2d import Kinematic2D
from .parcel import Parcel
