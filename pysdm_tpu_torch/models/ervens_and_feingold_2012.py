"""Ervens & Feingold 2012 (GRL 39) — CCN size spectrum used by the
immersion-freezing sensitivity studies (port of
``pysdm_tpu/models/ervens_and_feingold_2012.py``; reference
``examples/PySDM_examples/Ervens_and_Feingold_2012/settings.py``):
lognormal (N = 100/cm^3, r_mode = 0.04/2 um... the paper samples diameter),
logarithmically discretised."""

from ..initialisation.sampling.spectral_sampling import Logarithmic
from ..initialisation.spectra import Lognormal
from ..physics import si


def sampled_ccn_diameter_number_concentration_spectrum(
    n_sd: int = 11, size_range: tuple = (0.02 * si.um, 2 * si.um)
):
    """returns (diameters, number concentrations) — reference
    ``Ervens_and_Feingold_2012/settings.py:6-12``"""
    return Logarithmic(
        spectrum=Lognormal(
            s_geom=1.4, m_mode=0.04 * si.um, norm_factor=100 / si.cm**3
        ),
        size_range=size_range,
    ).sample(n_sd)
