"""environments (parity: reference PySDM/environments/): ``Box`` (slice 1)
and ``Parcel`` (slice 2); the kinematic grids come with slice 3"""
from .box import Box
from .parcel import Parcel
