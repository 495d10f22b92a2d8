"""Disjoint-pair matchings over the particle axis (port of
``pysdm_tpu/ops/pairing.py``).

``AdjacentPairing``, the sort croupier of multi-cell domains: after the
bucket shuffle (``ops/segments.py``) slots p and p + 1 pair where
``is_first[p]``; the candidate probability per cell is
floor(n/2) / (n(n-1)/2) (``ops.collisions.normalization_factor``).

``MirrorPairing``, the sort-free croupier of a single cell: draw ONE uniform integer K in [0, N) and pair slot o with slot
(K - o) mod N. The map is an involution, so the matching is disjoint by
construction; every unordered pair is a candidate with probability exactly
1/N, hence the normalization factor dt/dv * N
(``ops.collisions.mirror_normalization_factor``). Fixed points 2o = K (mod N)
and dead slots (multiplicity 0) are masked out of ``is_first``.

The JAX package reads the partner as ``roll(flip(x), K + 1)``; here the
partner index is computed directly and read with a gather.
"""

import torch


class AdjacentPairing:
    """pairs = slots (p, p+1) where is_first[p] (sort-croupier convention)"""

    def __init__(self, is_first):
        self.is_first = is_first

    @staticmethod
    def partner(x, axis=0):
        """partner value at leader slots (slot p sees p + 1; garbage at the
        other slots, which every use masks by ``is_first``)"""
        return torch.roll(x, -1, dims=axis)


class MirrorPairing:
    """pairs = slots {o, (K - o) mod N}; single-cell, sort-free"""

    def __init__(self, K, n_sd, alive):
        self.n_sd = n_sd
        self.K = int(K)
        o = torch.arange(n_sd, dtype=torch.int64, device=alive.device)
        self.partner_index = torch.remainder(self.K - o, n_sd)
        # strict '>' excludes fixed points (2o == K mod N)
        self.is_first = alive & self.partner(alive) & (self.partner_index > o)

    def partner(self, x, axis=0):
        """value of the pair partner at EVERY slot:
        partner(x)[o] = x[(K - o) mod N]"""
        return x.index_select(axis, self.partner_index)
