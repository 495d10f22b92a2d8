"""Fragmentation functions (parity: reference
``PySDM/dynamics/collisions/breakup_fragmentations/``), port of
``pysdm_tpu/dynamics/collisions/breakup_fragmentations.py``.

Each ``pairwise(formulae, attrs_a, attrs_b, u01)`` returns
``(n_fragment, fragment_mass)`` for the pair and its fragment draw.
``AlwaysN``, ``ConstantMass`` and ``Exponential`` (alias ``ExponFrag``) are
the JAX package's ``pallas_safe`` set: K5 (``ops/cuda/breakup.py``)
evaluates their fragment mass in its body from ``kernel_id`` and
``cuda_params``. The others need the float64 breakup path
(``ops/breakup.py``), which is not ported: they raise on construction.
"""

import torch

from ...physics import si
from ...ops.cuda.breakup import (
    FRAG_ALWAYS_N,
    FRAG_CONSTANT_MASS,
    FRAG_EXPONENTIAL,
    fragment_mass,
)

_NOT_PORTED = (
    "{} is not ported: it runs only on the JAX package's float64 breakup"
    " path (ops/breakup.py), which is not ported (ROADMAP: the float64"
    " breakup path)"
)


def apply_limiters(frag_volume, total_volume, *, vmin=0.0, nfmax=None):
    """reference limiter order: clip fragment to the pair total; cap the
    fragment count at nfmax; fragments below vmin suppress breakup
    (fragment = whole pair)"""
    fv = torch.where(
        torch.isnan(frag_volume) | (frag_volume <= 0), total_volume, frag_volume
    )
    fv = torch.minimum(fv, total_volume)
    if nfmax is not None:
        too_many = total_volume / fv > nfmax
        return torch.where(
            too_many, total_volume / nfmax,
            torch.where(fv < vmin, total_volume, fv),
        )
    return torch.where(fv < vmin, total_volume, fv)


class _Fragmentation:
    required_attributes = ("water mass",)
    # the default constants' water density; ``register`` takes the
    # formulae's
    rho_w = 1.0 * si.kg / si.litre

    def register(self, builder):
        builder.request_attribute("water mass")
        self.rho_w = builder.formulae.constants.rho_w

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        """(n_fragment, fragment_mass) through the body K5's twin runs"""
        mass_a, mass_b = attrs_a["water mass"], attrs_b["water mass"]
        params = self._params(formulae.constants.rho_w)
        mass = fragment_mass(self.kernel_id, params, mass_a, mass_b, u01)
        return (mass_a + mass_b) / mass, mass

    @property
    def cuda_params(self):
        return self._params(self.rho_w)


class AlwaysN(_Fragmentation):
    kernel_id = FRAG_ALWAYS_N

    def __init__(self, n=1):
        self.n = n

    def _params(self, rho_w):
        return (float(self.n),)


class ConstantMass(_Fragmentation):
    """every fragment has the prescribed mass"""

    kernel_id = FRAG_CONSTANT_MASS

    def __init__(self, c):
        self.c = c

    def _params(self, rho_w):
        return (float(self.c),)


class Exponential(_Fragmentation):
    """exponentially-distributed fragment size (reference expon_frag
    semantics): volume -scale ln(1 - u) at least vmin, at most nfmax
    fragments"""

    kernel_id = FRAG_EXPONENTIAL

    def __init__(self, scale, vmin=0.0, nfmax=None):
        self.scale = scale  # volume scale
        self.vmin = vmin
        self.nfmax = nfmax

    def _params(self, rho_w):
        nfmax = -1.0 if self.nfmax is None else float(self.nfmax)
        return (float(self.scale), float(self.vmin), nfmax, float(rho_w))


class ExponFrag(Exponential):
    """DEPRECATED alias of Exponential (reference ``expon_frag.py``)"""


class _NotPorted:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(type(self).__name__))


class Gaussian(_NotPorted):
    """normally-distributed fragment volume"""


class Feingold1988(_NotPorted):
    """scaled exponential fragment-size pdf (Feingold et al. 1999)"""


class LowList1982Nf(_NotPorted):
    """Low & List 1982 filament/sheet/disk fragment-size distribution"""


class SLAMS(_NotPorted):
    """Stochastic Lagrangian Aggregates Model spectrum"""


class Straub2010Nf(_NotPorted):
    """Straub et al. 2010 four-mode fragment-size distribution"""
