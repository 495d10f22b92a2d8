"""Products (diagnostics), port of ``pysdm_tpu/products/``: the ones the
de Jong/Mackay 2023 breakup box reads. The others are ROADMAP queue 1,
'Still to port' item 3."""

from .impl import Product
from .collision import (
    BreakupRateDeficitPerGridbox,
    BreakupRatePerGridbox,
    CoalescenceRatePerGridbox,
    CollisionRateDeficitPerGridbox,
    CollisionRatePerGridbox,
)
from .size_spectral import (
    NumberSizeSpectrum,
    ParticleVolumeVersusRadiusLogarithmSpectrum,
)
