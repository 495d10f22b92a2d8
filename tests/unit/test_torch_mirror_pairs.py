"""The map from a pair's index to its slots that the mirror kernels K1
(``csrc/collision_mirror.cu``) and K5 (``csrc/collision_breakup.cu``) take,
one thread per pair, in its Python mirror
``pysdm_tpu_torch.ops.cuda.collision.mirror_pairs``: against the
croupier's definition (slot o pairs with (K - o) mod n), every slot exactly
once as a leader, a partner or a slot that pairs with itself, at every K of
small and odd n (sampled at n = 4096)."""

import numpy as np
import pytest

from pysdm_tpu_torch.ops.cuda.collision import mirror_pairs

CASES = [(n, K) for n in (1, 2, 3, 4, 5, 16, 17) for K in range(n)] + [
    (4096, int(K))
    for K in np.unique(np.r_[0, 1, 2, 2047, 2048, 4094, 4095,
                             np.random.default_rng(4096).integers(0, 4096, 9)])
]


@pytest.mark.parametrize("n, K", CASES)
def test_pair_map_covers_every_slot_once(n, K):
    leaders, partners, selves = (x.numpy() for x in mirror_pairs(n, K))
    o = np.arange(n)
    partner_of = (K - o) % n
    np.testing.assert_array_equal(partners, partner_of[leaders])
    assert (leaders < partners).all()
    np.testing.assert_array_equal(partner_of[selves], selves)
    slots = np.concatenate([leaders, partners, selves])
    np.testing.assert_array_equal(np.sort(slots), o)
    # the leaders in slot order, so that pair p is the p-th leader; a warp's
    # 32 pairs read and write 32 consecutive leaders and, within each run,
    # 32 consecutive partners in descending order
    np.testing.assert_array_equal(leaders, o[o < partner_of])
    run = leaders <= K
    for part in (partners[run], partners[~run]):
        assert (np.diff(part) == -1).all()
