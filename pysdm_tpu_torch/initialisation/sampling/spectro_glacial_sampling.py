"""2D constant-multiplicity sampling in the (freezing temperature, immersed
insoluble surface) phase space for singular immersion freezing (port of
``pysdm_tpu/initialisation/sampling/spectro_glacial_sampling.py``;
reference ``PySDM/initialisation/sampling/spectro_glacial_sampling.py``).
NumPy on the host, as every sampling."""

import numpy as np

default_cdf_range = (0.00001, 0.99999)


class SpectroGlacialSampling:
    def __init__(self, *, freezing_temperature_spectrum, insoluble_surface_spectrum,
                 seed=44):
        self.insoluble_surface_spectrum = insoluble_surface_spectrum
        self.freezing_temperature_spectrum = freezing_temperature_spectrum
        self.seed = seed
        self.insoluble_surface_range = insoluble_surface_spectrum.percentiles(
            default_cdf_range
        )
        median = insoluble_surface_spectrum.median
        median = median() if callable(median) else median
        self.temperature_range = np.asarray(
            freezing_temperature_spectrum.invcdf(
                np.asarray(default_cdf_range), median
            )
        )

    def sample(self, *, n_sd, backend=None, seed=None):
        """(freezing temperatures, insoluble surfaces, multiplicities) of
        ``n_sd`` super-particles"""
        rng = np.random.default_rng(seed if seed is not None else self.seed)
        u01 = rng.uniform(0, 1, (n_sd, 2))
        surface = self.insoluble_surface_spectrum.percentiles(u01[:, 0])
        temperature = np.asarray(
            self.freezing_temperature_spectrum.invcdf(u01[:, 1], surface)
        )
        multiplicity = np.full(
            (n_sd,), self.insoluble_surface_spectrum.norm_factor / n_sd
        )
        return temperature, surface, multiplicity
