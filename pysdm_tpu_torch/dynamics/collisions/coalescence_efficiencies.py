"""Coalescence efficiencies (parity: reference
``PySDM/dynamics/collisions/coalescence_efficiencies/``), port of
``pysdm_tpu/dynamics/collisions/coalescence_efficiencies.py``.

``ConstEc`` and ``Berry1967`` are the JAX package's ``pallas_safe`` set: K5
(``ops/cuda/breakup.py``) evaluates them in its body from ``kernel_id`` and
``cuda_params``, and ``pairwise`` computes the same over tensors of any
dtype. ``SpecifiedEff``, ``Straub2010Ec`` and ``LowList1982Ec`` have no
``kernel_id``: a collision with them takes the float64 breakup path
(``ops/breakup.py``), as in the JAX package.
"""

import torch

from ...ops.cuda.breakup import EC_BERRY1967, EC_CONST, berry_1967_efficiency


class ConstEc:
    required_attributes = ()
    kernel_id = EC_CONST

    def __init__(self, Ec=1.0):
        self.Ec = Ec

    @property
    def cuda_params(self):
        return (self.Ec,)

    def register(self, builder):
        pass

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.Ec


class Berry1967:
    """Ec from the Berry 1967 linear-collection-efficiency fit"""

    required_attributes = ("radius",)
    kernel_id = EC_BERRY1967
    cuda_params = ()

    def register(self, builder):
        builder.request_attribute("radius")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return berry_1967_efficiency(attrs_a["radius"], attrs_b["radius"])


class SpecifiedEff:
    """piecewise-specified efficiency (reference specified_eff.py semantics):
    Ec = A inside the radius box, default outside"""

    required_attributes = ("radius",)

    def __init__(self, A=1.0, B=0.0, D1=0.0, D2=0.0, default=1.0):
        self.A = A
        self.default = default

    def register(self, builder):
        builder.request_attribute("radius")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.A + 0.0 * attrs_a["radius"]


class Straub2010Ec:
    """Weber-number-based coalescence efficiency Ec = exp(-1.15 We)
    (Straub et al. 2010; reference ``coalescence_efficiencies/straub2010.py``)"""

    required_attributes = ("volume", "relative fall velocity")

    def register(self, builder):
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        const = formulae.constants
        va, vb = attrs_a["volume"], attrs_b["volume"]
        du2 = (
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        ) ** 2
        total = va + vb
        Sc = const.PI * const.sgm_w * (6 / const.PI * total) ** (2 / 3)
        We = const.rho_w * (va * vb / (2 * total).clamp_min(1e-300)) * du2
        We = We / Sc.clamp_min(1e-300)
        return torch.exp(-1.15 * We)


class LowList1982Ec:
    """collision-energy-based coalescence efficiency (Low & List 1982;
    reference ``coalescence_efficiencies/lowlist1982.py``); Ec = 1 for
    large-drop diameters below 0.4 mm"""

    required_attributes = ("radius", "water mass", "relative fall velocity")

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("water mass")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        const = formulae.constants
        ma, mb = attrs_a["water mass"], attrs_b["water mass"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        du2 = (
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        ) ** 2
        ds = 2 * torch.minimum(ra, rb)
        dl = 2 * torch.maximum(ra, rb)
        m_total = ma + mb
        # surface energies: coalesced sphere vs the two separate drops
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * m_total ** (2 / 3)
        St = const.PI * const.sgm_w * (ds**2 + dl**2)
        dS = St - Sc
        CKE = const.rho_w / 2 * (ma * mb / m_total.clamp_min(1e-300)) * du2
        Et = CKE + dS
        a = 0.778
        b = 2.61e6  # 1/J^2 * m^2
        Ec = (
            a
            * (1.0 + ds / dl.clamp_min(1e-30)) ** -2.0
            * torch.exp(-b * const.sgm_w * Et**2 / Sc.clamp_min(1e-300))
        )
        return torch.where(dl < 0.4e-3, 1.0, Ec)
