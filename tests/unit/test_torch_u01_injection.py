"""``tests/unit/test_u01_injection.py``'s three refusals replayed on the
port, each beside the JAX package's on the same build (``TestU01Injection``
``test_injection_requires_enable``, ``test_unknown_purpose_rejected``,
``test_adaptive_incompatible``): the same exception type and message in
both packages. The port's adaptive refusal is raised where the collision
registers (``dynamics/collisions/collision.py``), as the JAX package's."""

import numpy as np
import pytest

import pysdm_tpu
import pysdm_tpu.backends
import pysdm_tpu.dynamics
import pysdm_tpu.dynamics.collisions.collision_kernels
import pysdm_tpu.environments
import pysdm_tpu_torch
import pysdm_tpu_torch.backends
import pysdm_tpu_torch.dynamics
import pysdm_tpu_torch.dynamics.collisions.collision_kernels
import pysdm_tpu_torch.environments

PACKAGES = {"port": pysdm_tpu_torch, "jax": pysdm_tpu}
ATTRIBUTES = {
    "multiplicity": np.asarray([16.0, 8.0, 4.0, 2.0, 1.0, 1.0, 1.0, 1.0]),
    "volume": np.full(8, 1e-12),
}


def _builder(package, inject=True, adaptive=False):
    """the JAX test's ``build``: 8 SDs, ConstantK(a=1), dv = 1"""
    pkg = PACKAGES[package]
    builder = pkg.Builder(
        n_sd=8, backend=pkg.backends.CPU(pkg.Formulae(seed=44)),
        environment=pkg.environments.Box(dt=1.0, dv=1.0),
    )
    if inject:
        builder.enable_u01_injection()
    builder.add_dynamic(pkg.dynamics.Coalescence(
        collision_kernel=pkg.dynamics.collisions.collision_kernels.ConstantK(
            a=1.0
        ),
        adaptive=adaptive,
    ))
    return builder


@pytest.mark.parametrize("package", PACKAGES)
def test_injection_requires_enable(package):
    p = _builder(package, inject=False).build(dict(ATTRIBUTES))
    with pytest.raises(RuntimeError, match="not enabled"):
        p.inject_u01({"collision_gamma": np.zeros(8)})


@pytest.mark.parametrize("package", PACKAGES)
def test_unknown_purpose_rejected(package):
    p = _builder(package).build(dict(ATTRIBUTES))
    with pytest.raises(KeyError, match="unknown u01 purpose"):
        p.inject_u01({"nope": np.zeros(8)})


@pytest.mark.parametrize("package", PACKAGES)
def test_adaptive_incompatible(package):
    builder = _builder(package, adaptive=True)
    with pytest.raises(ValueError, match="u01 injection requires"):
        builder.build(
            {"multiplicity": np.ones(8), "volume": np.full(8, 1e-12)}
        )
