"""The pH solve's dispatch and twin (``pysdm_tpu_torch/ops/cuda/chemistry.py``)
on the CPU, in float64 against the JAX package.

- ``ops.chemistry.equilibrate_H`` on CPU tensors is the eager twin
  ``equilibrate_H_reference`` bit for bit, in float64 and float32, and
  launches nothing;
- the twin equals the JAX package's body written in torch bit for bit;
- the twin equals the JAX package's ``equilibrate_H`` at rtol 1e-12 on
  seeded drops from acid to alkaline (pH -1 to 14, the bracket's ends
  included), pure-water drops, dead drops (amounts over the 1e-30 m3 the
  dynamic puts in place of their volume) and drops lacking one compound,
  over the iteration counts 0, 1, 20 and 48. Both bisect the same residual
  in the same order; where XLA's and torch's exp round a midpoint apart,
  the two may step apart near the root, by at most that step's bracket;
  after 48 steps that is (log H_max - log H_min) / 2^48 = 1.2e-13 in log
  H, below the tolerance;
- the wrapper refuses what the kernel does not take: integer rows, rows on
  the meta device, CPU and meta rows mixed.

The kernel against the twin on the card: ``test_torch_cuda_chemistry.py``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.ops import chemistry as jax_ops

from pysdm_tpu_torch.ops import chemistry as ops
from pysdm_tpu_torch.ops.cuda import chemistry as ph

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))

import chip_smoke  # noqa: E402

RTOL = 1e-12
N_DROPS = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """one torch thread while this module runs: the tests run in several
    processes at once, and torch's own threads on top of them oversubscribe
    the cores"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(name="inputs", scope="module")
def _inputs():
    return chip_smoke.ph_solve_inputs(N_DROPS, seed=17)


def _torch(d, dtype=torch.float64):
    return {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_cpu_tensors_take_the_twin_bit_for_bit(inputs, dtype):
    conc, K, host = inputs
    launches = ph.equilibrate_H.launches
    got = ops.equilibrate_H(conc=_torch(conc, dtype), K_drop=_torch(K, dtype),
                            **host)
    want = ph.equilibrate_H_reference(conc=_torch(conc, dtype),
                                      K_drop=_torch(K, dtype), **host)
    assert got.dtype == dtype and got.shape == (N_DROPS,)
    assert torch.equal(got, want)
    assert ph.equilibrate_H.launches == launches


@pytest.mark.parametrize("iters", (0, 1, 20, 48))
def test_twin_matches_jax_package(inputs, iters):
    conc, K, host = inputs
    want = np.asarray(jax_ops.equilibrate_H(
        conc={k: jnp.asarray(v) for k, v in conc.items()},
        K_drop={k: jnp.asarray(v) for k, v in K.items()}, iters=iters, **host,
    ))
    got = ph.equilibrate_H_reference(conc=_torch(conc), K_drop=_torch(K),
                                     iters=iters, **host).numpy()
    assert np.isfinite(got).all()
    assert not (np.abs(got / want - 1) > RTOL).any()
    if iters == ph.PH_ITERATIONS:
        pH = -np.log10(got * 1e-3)
        # the drops span the bracket, and pure water sits at pH 7
        assert pH.min() < 0.0 and pH.max() > 13.0
        np.testing.assert_allclose(pH[0::8], 7.0, atol=1e-6)


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_twin_equals_the_jax_body_in_torch(inputs, dtype):
    """forming the residual's H-free factors once a solve changes no bit:
    the twin equals the JAX package's body written in torch
    (``chip_smoke.equilibrate_H_verbatim``), which forms them anew at each
    iteration"""
    conc, K, host = inputs
    got = ph.equilibrate_H_reference(conc=_torch(conc, dtype),
                                     K_drop=_torch(K, dtype), **host)
    want = chip_smoke.equilibrate_H_verbatim(
        conc=_torch(conc, dtype), K_drop=_torch(K, dtype), **host
    )
    assert torch.equal(got, want)


def test_twin_is_the_residual_bisected(inputs):
    """the twin's H is the root of ``acidity_minfun`` wherever the root
    lies inside [H_min, H_max]: the residual is below zero at 1e-10 below
    log H and above zero at 1e-10 above (~800 last brackets, far past the
    residual's rounding)"""
    conc, K, host = inputs
    c, k = _torch(conc), _torch(K)
    H = ph.equilibrate_H_reference(conc=c, K_drop=k, **host)
    below = ops.acidity_minfun(H * np.exp(-1e-10), c, k, host["K_H2O"])
    above = ops.acidity_minfun(H * np.exp(1e-10), c, k, host["K_H2O"])
    inside = (H > host["H_min"] * 1.001) & (H < host["H_max"] / 1.001)
    assert inside.sum() > N_DROPS // 2
    assert (below[inside] < 0).all() and (above[inside] > 0).all()


@pytest.mark.parametrize("case", ("integer", "meta", "cpu and meta"))
def test_rows_the_kernel_does_not_take_raise(inputs, case):
    conc, K, host = inputs
    c, k = _torch(conc), _torch(K)
    if case == "integer":
        c["S_VI"] = c["S_VI"].to(torch.int64)
        error = TypeError
    elif case == "meta":
        c = {name: v.to("meta") for name, v in c.items()}
        k = {name: v.to("meta") for name, v in k.items()}
        error = ValueError
    else:
        k["K_HSO4"] = k["K_HSO4"].to("meta")
        error = ValueError
    with pytest.raises(error):
        ops.equilibrate_H(conc=c, K_drop=k, **host)
