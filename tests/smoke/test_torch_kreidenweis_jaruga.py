"""The aqueous-chemistry models on the port's CPU backend (float64) against
the JAX package, at the JAX tests' settings (``TestKreidenweis2003``,
``TestJarugaPawlowska2018`` of ``tests/smoke/test_models.py``): each runs
through its entry point in both packages, and every output series agrees.

Tolerances: rtol 1e-8 on every series, the products' tolerance of
``test_torch_activation_parcels.py`` (the per-drop condensation solves stop
at rtol_x, so an ulp in an input moves a root by an ulp of its bracket,
and the chemistry then sees that water mass); the height and time series
exactly. Then each JAX test's bounds on the port; the chemistry products
(the spectra and the number-weighted pH among them) and the "pH" and
"conc_*" attributes on the JAX run's last state carried into the port, at
rtol 1e-12; and the card as the entry points' default backend.
"""

import jax
import numpy as np
import pytest
import torch

from pysdm_tpu.models import jaruga_and_pawlowska_2018 as jax_jp
from pysdm_tpu.models import kreidenweis_et_al_2003 as jax_kw
from pysdm_tpu.products import chemistry as jax_products

from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.impl.state import sim_state_from_numpy
from pysdm_tpu_torch.models import jaruga_and_pawlowska_2018 as jp
from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw
from pysdm_tpu_torch.products import chemistry as products
from pysdm_tpu_torch.physics import si

RTOL_SERIES, RTOL_CARRIED = 1e-8, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores (seen: a 68 s file took 850 s beside another torch file)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kreidenweis_settings(model):
    settings = model.Settings(dt=10.0, n_sd=16, n_substep=5)
    settings.t_max = 400.0
    return settings


@pytest.fixture(scope="module", name="kreidenweis")
def _kreidenweis():
    jax_sim = jax_kw.Simulation(_kreidenweis_settings(jax_kw))
    sim = kw.Simulation(_kreidenweis_settings(kw), backend_class=CPU)
    return jax_sim, jax_sim.run(), sim, sim.run()


def test_kreidenweis_series_match_jax_package(kreidenweis):
    _, want, _, got = kreidenweis
    assert got.keys() == want.keys()
    for name in got:
        rtol = 0.0 if name in ("t", "z") else RTOL_SERIES
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   err_msg=name)


def test_kreidenweis_bounds_on_the_port(kreidenweis):
    """``TestKreidenweis2003::test_in_cloud_pH_and_SO2_depletion``"""
    out = kreidenweis[3]
    assert 3.0 < out["pH"][-1] < 6.0
    assert out["gas_S_IV"][-1] < out["gas_S_IV"][0]
    assert out["liquid water mixing ratio"][-1] > 1e-5
    assert out["aq_S_VI"][-1] > out["aq_S_VI"][0]


def test_chemistry_products_and_attributes_on_a_carried_state(kreidenweis):
    """the JAX run's last state in a port particulator: every chemistry
    product and the "pH" and "conc_*" attributes"""
    jax_sim, _, sim, _ = kreidenweis
    jax_p, p = jax_sim.particulator, sim.particulator
    p.sim_state = sim_state_from_numpy(jax.device_get(jax_p.sim_state), p)
    edges = jax_sim.settings.dry_radius_bins_edges

    def make(module):
        return (
            module.Acidity(radius_range=(0.5e-6, 25e-6), weighting="number",
                           name="pH number"),
            module.Acidity(name="pH all"),
            module.AqueousMassSpectrum(key="S_VI", dry_radius_bins_edges=edges),
            module.SpecificAqueousMassSpectrum("S_VI", edges),
            module.AqueousMoleFraction("N_mIII"),
            module.GaseousMoleFraction("N_mIII"),
        )

    for jax_product, product in zip(make(jax_products), make(products)):
        jax_product.register(_Registrar(jax_p))
        product.register(_Registrar(p))
        got, want = product.get(), jax_product.get()
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, want, rtol=RTOL_CARRIED,
                                   err_msg=product.name)
    for name, product in p.products.items():
        np.testing.assert_allclose(product.get(), jax_p.products[name].get(),
                                   rtol=RTOL_CARRIED, err_msg=name)
    for name in ("pH", "conc_H", "conc_S_VI", "conc_S_IV", "conc_H2O2"):
        np.testing.assert_allclose(p.attributes[name], jax_p.attributes[name],
                                   rtol=RTOL_CARRIED, err_msg=name)


class _Registrar:
    """what a product's ``register`` reads of a builder"""

    def __init__(self, particulator):
        self.particulator = particulator
        self.formulae = particulator.formulae


def test_jaruga_convergence_point_matches_jax_package():
    """``TestJarugaPawlowska2018::test_fig2_convergence_point`` in both
    packages: the four numbers to rtol 1e-8, and the JAX test's bounds on
    the port"""
    kwargs = dict(dt=2 * si.s, n_substep=1, output_interval=50 * si.s)
    want = jax_jp.run_convergence_point(16, **kwargs)
    got = jp.run_convergence_point(16, backend_class=CPU, **kwargs)
    np.testing.assert_allclose(got, want, rtol=RTOL_SERIES)
    s_max, n_c, ph, sulfate_ppt = got
    assert 0.1 < s_max < 1.0
    assert 4.0 < ph < 6.0
    assert sulfate_ppt > 0.0
    assert n_c > 0.0


def _refuses_without_cuda(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_kreidenweis_simulation_defaults_to_the_card(monkeypatch):
    settings = kw.Settings(dt=10.0, n_sd=4, n_substep=1)
    _refuses_without_cuda(monkeypatch, lambda: kw.Simulation(settings))


def test_jaruga_convergence_point_defaults_to_the_card(monkeypatch):
    _refuses_without_cuda(
        monkeypatch, lambda: jp.run_convergence_point(4, n_substep=1)
    )
