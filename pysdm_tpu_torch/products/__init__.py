"""Products (diagnostics), port of ``pysdm_tpu/products/``: the ones the
de Jong/Mackay 2023 breakup box and the Shipway and Hill 2012 column
read. The others come with the rest of the products (ROADMAP)."""

from .impl import MomentProduct, Product
from .ambient_thermodynamics import AmbientRelativeHumidity, AmbientTemperature
from .collision import (
    BreakupRateDeficitPerGridbox,
    BreakupRatePerGridbox,
    CoalescenceRatePerGridbox,
    CollisionRateDeficitPerGridbox,
    CollisionRatePerGridbox,
)
from .condensation import (
    ActivatingRate,
    DeactivatingRate,
    PeakSaturation,
    PeakSupersaturation,
    RipeningRate,
)
from .displacement import SurfacePrecipitation
from .housekeeping import SuperDropletCountPerGridbox
from .size_spectral import (
    CloudWaterContent,
    EffectiveRadius,
    NumberSizeSpectrum,
    ParticleVolumeVersusRadiusLogarithmSpectrum,
    WaterMixingRatio,
)
