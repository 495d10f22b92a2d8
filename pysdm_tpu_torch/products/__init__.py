"""Products (diagnostics), port of ``pysdm_tpu/products/``: every
liquid-phase product, the ice (``freezing``) products, the optical products
and the aqueous-chemistry products."""

from .impl import MomentProduct, Product
from .size_spectral import (
    ActivatedEffectiveRadius,
    ActivatedMeanRadius,
    ActivatedParticleConcentration,
    ActivatedParticleSpecificConcentration,
    AreaStandardDeviation,
    CloudWaterContent,
    EffectiveRadius,
    LiquidWaterContent,
    MeanRadius,
    MeanVolumeRadius,
    NumberSizeSpectrum,
    ParticleConcentration,
    ParticleSizeSpectrumPerMassOfDryAir,
    ParticleSizeSpectrumPerVolume,
    ParticleSpecificConcentration,
    ParticleVolumeVersusRadiusLogarithmSpectrum,
    RadiusBinnedNumberAveragedTerminalVelocity,
    RadiusFirstMoment,
    RadiusSixthMoment,
    RadiusStandardDeviation,
    SpecificCloudWaterContent,
    SpecificLiquidWaterContent,
    TotalParticleConcentration,
    TotalParticleSpecificConcentration,
    VolumeFirstMoment,
    VolumeSecondMoment,
    VolumeStandardDeviation,
    WaterMixingRatio,
    ZerothMoment,
    make_arbitrary_moment_product,
)
from .housekeeping import (
    CPUTime,
    DynamicWallTime,
    SuperDropletCountPerGridbox,
    Time,
    WallTime,
)
from .collision import (
    BreakupRateDeficitPerGridbox,
    BreakupRatePerGridbox,
    CoalescenceRatePerGridbox,
    CollisionRateDeficitPerGridbox,
    CollisionRatePerGridbox,
    CollisionTimestepMean,
    CollisionTimestepMin,
)
from .ambient_thermodynamics import (
    AmbientDryAirDensity,
    AmbientDryAirPotentialTemperature,
    AmbientPressure,
    AmbientRelativeHumidity,
    AmbientRelativeHumidityWrtIce,
    AmbientTemperature,
    AmbientWaterVapourMixingRatio,
)
from .displacement import (
    AveragedTerminalVelocity,
    FlowVelocityComponent,
    MaxCourantNumber,
    SurfacePrecipitation,
)
from .condensation import (
    ActivableFraction,
    ActivatingRate,
    CondensationTimestepMax,
    CondensationTimestepMin,
    DeactivatingRate,
    PeakSaturation,
    PeakSupersaturation,
    RipeningRate,
)
from .parcel import ParcelDisplacement, ParcelLiquidWaterPath
from .freezing import (
    CoolingRate,
    FreezableSpecificConcentration,
    FrozenFraction,
    FrozenParticleConcentration,
    FrozenParticleSpecificConcentration,
    IceNucleiConcentration,
    IceWaterContent,
    SpecificIceNucleiConcentration,
    SpecificIceWaterContent,
    TotalUnfrozenImmersedSurfaceArea,
)
from .optical import CloudAlbedo, CloudOpticalDepth
from .chemistry import (
    Acidity,
    AqueousMassSpectrum,
    AqueousMoleFraction,
    GaseousMoleFraction,
    SpecificAqueousMassSpectrum,
    TotalDryMassMixingRatio,
)
