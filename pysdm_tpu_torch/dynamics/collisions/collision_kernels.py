"""Collision kernels (parity: reference
``PySDM/dynamics/collisions/collision_kernels/``), the volume-based ones of
``pysdm_tpu/dynamics/collisions/collision_kernels.py``.

Each kernel has ``pairwise(formulae, attrs_a, attrs_b)`` over tensors. On
the multi-cell path its values feed K2 as a row; on the single-cell path
the adaptive substep choice reads them, and the kernel is evaluated again
in the body of K1 or K5 (``csrc/sdm_pair.cuh`` ``kernel_value``) from its
``kernel_id``, two float parameters, ``cuda_params``, and the attribute
rows ``ops/cuda/collision.py`` ``KERNEL_ROWS`` names.
"""

import numpy as np
import torch
from scipy import special

from ...ops.cuda.breakup import (  # noqa: F401 (the reference's name here)
    berry_1967_linear_collection_efficiency,
)
from ...ops.cuda.collision import (
    CONSTANT_K,
    GEOMETRIC,
    GOLOVIN,
    LINEAR,
    SIMPLE_GEOMETRIC,
)


class Golovin:
    """sum-of-volumes kernel with analytic solution (Golovin 1963)"""

    required_attributes = ("volume",)
    kernel_id = GOLOVIN

    def __init__(self, b):
        self.b = b
        self.particulator = None

    @property
    def cuda_params(self):
        return (self.b, 0.0)

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.b * (attrs_a["volume"] + attrs_b["volume"])

    def analytic_solution(self, x, t, x_0, N_0):
        """mass-density solution of the Smoluchowski equation for K = b(x+x')
        (same closed form as reference ``collision_kernels/golovin.py:24-45``)"""
        tau = 1 - np.exp(-N_0 * self.b * x_0 * t)
        sqrt_tau = np.sqrt(tau)
        return (
            (1 - tau)
            / (x * sqrt_tau)
            * special.ive(1, 2 * x / x_0 * sqrt_tau)
            * np.exp(-(1 + tau - 2 * sqrt_tau) * x / x_0)
        )


class ConstantK:
    required_attributes = ("volume",)
    kernel_id = CONSTANT_K

    def __init__(self, a):
        self.a = a

    @property
    def cuda_params(self):
        return (self.a, 0.0)

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.a + 0.0 * attrs_a["volume"]


class Linear:
    """K = a + b * (v + v') (reference ``collision_kernels/linear.py``)"""

    required_attributes = ("volume",)
    kernel_id = LINEAR

    def __init__(self, a, b):
        self.a = a
        self.b = b

    @property
    def cuda_params(self):
        return (self.a, self.b)

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.a + self.b * (attrs_a["volume"] + attrs_b["volume"])


class Geometric:
    """gravitational geometric-sweepout kernel
    (reference ``collision_kernels/geometric.py``):
    K = E_c * pi * (r + r')^2 * |v_t - v_t'|"""

    required_attributes = ("radius", "relative fall velocity")
    kernel_id = GEOMETRIC

    def __init__(self, collection_efficiency=1.0, x="volume"):
        self.collection_efficiency = collection_efficiency
        self.x = x

    @property
    def cuda_params(self):
        # the JAX package multiplies pi * E_c in double before float32
        return (np.pi * self.collection_efficiency, 0.0)

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        r_sum = attrs_a["radius"] + attrs_b["radius"]
        dv = torch.abs(
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        )
        return np.pi * self.collection_efficiency * r_sum**2 * dv


class SimpleGeometric:
    """geometric kernel without fall velocities
    (reference ``collision_kernels/simple_geometric.py``):
    K = C * (r + r')^2 * |A - A'|"""

    required_attributes = ("radius", "area")
    kernel_id = SIMPLE_GEOMETRIC

    def __init__(self, C):
        self.C = C

    @property
    def cuda_params(self):
        return (self.C, 0.0)

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("area")

    def pairwise(self, formulae, attrs_a, attrs_b):
        r_sum = attrs_a["radius"] + attrs_b["radius"]
        d_area = torch.abs(attrs_a["area"] - attrs_b["area"])
        return self.C * r_sum**2 * d_area
