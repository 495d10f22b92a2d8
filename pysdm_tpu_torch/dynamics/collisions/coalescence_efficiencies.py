"""Coalescence efficiencies (parity: reference
``PySDM/dynamics/collisions/coalescence_efficiencies/``), port of
``pysdm_tpu/dynamics/collisions/coalescence_efficiencies.py``.

``ConstEc`` and ``Berry1967`` are the JAX package's ``pallas_safe`` set: K5
(``ops/cuda/breakup.py``) evaluates them in its body from ``kernel_id`` and
``cuda_params``, and ``pairwise`` computes the same over tensors of any
dtype. The others need the float64 breakup path (``ops/breakup.py``), which
is not ported: they raise on construction.
"""

from ...ops.cuda.breakup import EC_BERRY1967, EC_CONST, berry_1967_efficiency

_NOT_PORTED = (
    "{} is not ported: it runs only on the JAX package's float64 breakup"
    " path (ops/breakup.py), which is not ported (ROADMAP: the float64"
    " breakup path)"
)


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


class _NotPorted:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(type(self).__name__))


class SpecifiedEff(_NotPorted):
    """piecewise-specified efficiency"""


class Straub2010Ec(_NotPorted):
    """Weber-number-based coalescence efficiency (Straub et al. 2010)"""


class LowList1982Ec(_NotPorted):
    """collision-energy-based coalescence efficiency (Low & List 1982)"""
