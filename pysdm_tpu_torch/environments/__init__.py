"""environments (parity: reference PySDM/environments/): ``Box`` (slice 1),
``Parcel`` (slice 2) and ``Kinematic2D`` (slice 3); the 1D column comes
with config #4"""
from .box import Box
from .kinematic_2d import Kinematic2D
from .parcel import Parcel
