"""Products (diagnostics), port of ``pysdm_tpu/products/``: the ones the
de Jong/Mackay 2023 breakup box reads. The others come with the rest
of the products (ROADMAP)."""

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
