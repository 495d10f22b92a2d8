"""``tests/unit/test_initialisation.py``'s guards and spatial sampling
replayed on the port (``pysdm_tpu_torch/initialisation/``), each beside the
JAX package's function on the same numpy inputs:

- ``TestDiscretiseMultiplicities`` (NaN flags zero, the zero-multiplicity
  and the 1% total-number guards): the same integers, the same refusals;
- ``test_spectral_sampling_error_guard_raises``: a truncated size range
  refused by ``Linear`` in both packages;
- ``TestSpatialSampling`` (bounds, uniform mean, ``z_part`` confinement):
  the JAX test's bounds, and the positions equal to the JAX package's
  from the same seed;
- ``tests/smoke/test_mg2007_rogers_ervens.py``'s
  ``TestErvensAndFeingold2012`` on the port's
  ``models/ervens_and_feingold_2012.py`` (no port test named that module
  before: ``test_torch_completeness.py``), its spectrum equal to the JAX
  package's at rtol 1e-12.
"""

import numpy as np
import pytest

from pysdm_tpu.initialisation import spectra as jax_spectra
from pysdm_tpu.models import (
    ervens_and_feingold_2012 as jax_ervens_and_feingold_2012,
)
from pysdm_tpu.initialisation.discretise_multiplicities import (
    discretise_multiplicities as jax_discretise_multiplicities,
)
from pysdm_tpu.initialisation.sampling import (
    spectral_sampling as jax_spectral_sampling,
)
from pysdm_tpu.initialisation.sampling.spatial_sampling import (
    Pseudorandom as JaxPseudorandom,
)
from pysdm_tpu_torch.initialisation import spectra
from pysdm_tpu_torch.initialisation.discretise_multiplicities import (
    discretise_multiplicities,
)
from pysdm_tpu_torch.initialisation.sampling import spectral_sampling
from pysdm_tpu_torch.initialisation.sampling.spatial_sampling import (
    Pseudorandom,
)
from pysdm_tpu_torch.models import ervens_and_feingold_2012
from pysdm_tpu_torch.physics import si

M_MODE = 0.5e-5
S_GEOM = 1.5


class TestDiscretiseMultiplicities:
    @staticmethod
    def test_nan_flags_zero():
        vals = np.asarray([np.nan, 1e6, np.nan])
        out = discretise_multiplicities(vals)
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, [0, 10**6, 0])
        np.testing.assert_array_equal(out, jax_discretise_multiplicities(vals))

    @staticmethod
    @pytest.mark.parametrize("fn", (
        discretise_multiplicities, jax_discretise_multiplicities,
    ), ids=("port", "jax"))
    def test_zero_multiplicity_raises(fn):
        with pytest.raises(ValueError, match="multiplicity of zero"):
            fn(np.asarray([0.4, 1e6]))

    @staticmethod
    @pytest.mark.parametrize("fn", (
        discretise_multiplicities, jax_discretise_multiplicities,
    ), ids=("port", "jax"))
    def test_total_number_error_guard(fn):
        # each 0.6 rounds to 1 (+67% each) -> guard trips
        with pytest.raises(ValueError, match="error in total real-droplet"):
            fn(np.full(10, 0.6))

    @staticmethod
    def test_integers_match_jax_package():
        values = np.random.default_rng(12).uniform(1.0, 1e9, 1000)
        values[::7] = np.nan
        np.testing.assert_array_equal(
            discretise_multiplicities(values),
            jax_discretise_multiplicities(values),
        )


@pytest.mark.parametrize("package", ("port", "jax"))
def test_spectral_sampling_error_guard_raises(package):
    """an aggressively truncated size range loses >1% of the number: the
    deterministic samplings raise (reference ``spectral_sampling.py:48-60``)"""
    spec, sampling = {
        "port": (spectra, spectral_sampling),
        "jax": (jax_spectra, jax_spectral_sampling),
    }[package]
    spectrum = spec.Lognormal(norm_factor=1.0, m_mode=M_MODE, s_geom=S_GEOM)
    linear = sampling.Linear(spectrum, size_range=(M_MODE, 2 * M_MODE))
    with pytest.raises(ValueError, match="error in total real-droplet number"):
        linear.sample(64)


class TestSpatialSampling:
    @staticmethod
    def test_pseudorandom_in_bounds():
        grid = (25, 40)
        pos = Pseudorandom.sample(grid=grid, n_sd=10_000, seed=44)
        assert pos.shape == (2, 10_000)
        for d in range(2):
            assert (pos[d] >= 0).all() and (pos[d] < grid[d]).all()
            # roughly uniform: mean near the middle of the range
            np.testing.assert_allclose(pos[d].mean(), grid[d] / 2, rtol=0.05)
        np.testing.assert_array_equal(
            pos, JaxPseudorandom.sample(grid=grid, n_sd=10_000, seed=44)
        )

    @staticmethod
    def test_z_part_confinement():
        grid = (10, 64)
        z_part = (0.25, 0.75)
        pos = Pseudorandom.sample(grid=grid, n_sd=1000, z_part=z_part, seed=44)
        assert (pos[1] >= z_part[0] * grid[1]).all()
        assert (pos[1] <= z_part[1] * grid[1]).all()
        np.testing.assert_array_equal(
            pos,
            JaxPseudorandom.sample(grid=grid, n_sd=1000, z_part=z_part, seed=44),
        )


class TestErvensAndFeingold2012:
    @staticmethod
    def test_spectrum():
        # Niedermeier-2014 window: captures >99% of the lognormal
        window = dict(size_range=(10 * si.nm, 353 * si.nm))
        diameters, concentrations = (
            ervens_and_feingold_2012
            .sampled_ccn_diameter_number_concentration_spectrum(**window)
        )
        assert len(diameters) == len(concentrations) == 11
        assert (np.diff(diameters) > 0).all()
        total = concentrations.sum() * si.cm**3
        assert 99 < total < 101
        want = (
            jax_ervens_and_feingold_2012
            .sampled_ccn_diameter_number_concentration_spectrum(**window)
        )
        np.testing.assert_allclose(diameters, want[0], rtol=1e-12)
        np.testing.assert_allclose(concentrations, want[1], rtol=1e-12)

    @staticmethod
    def test_default_window_trips_number_error_guard():
        # the (0.02, 2) um default window cuts ~2% of the distribution:
        # the deterministic-sampling 1%-error guard fires
        with pytest.raises(ValueError, match="error in total real-droplet"):
            (
                ervens_and_feingold_2012
                .sampled_ccn_diameter_number_concentration_spectrum()
            )
