"""Physics layer: unit helpers, constants catalogue and the Formulae
binding engine (the families the box and parcel slices read)."""

from .si import si, in_unit, convert_to
from .constants import make_constants, DEFAULTS as constant_defaults
from .formulae import Formulae

from .si import (  # noqa: F401
    PI,
    PI_4_3,
    T0,
    PPM,
    PPB,
    PPT,
    PER_CENT,
    PER_MILLE,
    PER_MEG,
)
