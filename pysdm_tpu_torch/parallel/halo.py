"""Halo exchange for decomposed Eulerian fields (port of
``pysdm_tpu/parallel/halo.py``).

Each rank owns a contiguous slab (or tile) of the domain; the MPDATA pads
along a decomposed axis take the neighbouring ranks' boundary slices. The
global domain is periodic, so the first and last ranks of a ring are
neighbours. Where the JAX package runs one ``ppermute`` pair under
``shard_map``, the port runs one ``all_to_all_single`` over the ring's
process group: it carries the forward payload to the right neighbour and
the backward payload to the left one, and nothing to any other rank. The
same call runs on NCCL (one GPU per rank), on gloo with CPU tensors and on
gloo with CUDA tensors, which gloo stages through the host.

Every exchange goes through ``ring_exchange``, which counts its calls and
the bytes it sends in ``traffic`` (the exchange layer's metric).
"""

import torch
import torch.distributed as dist


class Traffic:
    """calls of ``ring_exchange`` and the bytes they sent, this process"""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def reset(self):
        self.calls = 0
        self.bytes = 0


traffic = Traffic()


class RingExchange:
    """an issued ``ring_exchange``: ``wait()`` returns (from_left,
    from_right). It holds the send buffer until then: the collective may
    still read it (NCCL's stream, gloo's host staging)."""

    def __init__(self, work, send, out, sizes, left_first):
        self.work = work
        self.send = send
        self.out = out
        self.sizes = sizes
        self.left_first = left_first

    def wait(self):
        if self.work is not None:
            self.work.wait()
        self.send = None
        n_fwd, n_bwd = self.sizes
        if self.left_first:
            return self.out[:n_fwd], self.out[n_fwd:]
        return self.out[n_bwd:], self.out[:n_bwd]


def ring_exchange(fwd, bwd, group, async_op=False):
    """send the flat tensor ``fwd`` to the right neighbour and ``bwd`` to
    the left one in one ``all_to_all_single``; receive the left
    neighbour's ``fwd`` and the right neighbour's ``bwd``. Every rank of
    ``group`` must call it with the same sizes and dtype. With two ranks
    both neighbours are one rank, with one rank the ring is the rank
    itself; the payloads keep their roles either way. Returns a
    ``RingExchange``; with ``async_op=False`` the collective has already
    completed."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    left, right = (r - 1) % n, (r + 1) % n
    n_fwd, n_bwd = fwd.numel(), bwd.numel()
    # chunks in destination order, and in source order on arrival; one
    # rank that is both neighbours gets (and sends) fwd before bwd
    send = torch.cat([fwd, bwd] if right <= left else [bwd, fwd])
    in_splits = [n_fwd * (k == right) + n_bwd * (k == left) for k in range(n)]
    out_splits = [n_fwd * (s == left) + n_bwd * (s == right) for s in range(n)]
    out = torch.empty(n_fwd + n_bwd, dtype=send.dtype, device=send.device)
    traffic.calls += 1
    traffic.bytes += send.numel() * send.element_size()
    work = dist.all_to_all_single(
        out, send, out_splits, in_splits, group=group, async_op=async_op
    )
    return RingExchange(
        work if async_op else None, send, out, (n_fwd, n_bwd), left <= right
    )


def ring_halo_pad(arr, axis, group, depth=1, staggered=False):
    """halo-``depth`` pad along ``axis`` with the ring neighbours' boundary
    slices (global-periodic ring; one exchange whatever the depth). With one
    rank in ``group`` it equals the periodic pad. Requires depth <= the
    local extent (the decomposition gives slabs of >= 2 cells).

    ``staggered``: ``arr`` holds the faces of the rank's cells along
    ``axis``, its first and last face shared with the neighbours; the halo
    takes the faces beyond the shared ones (the neighbours' second and
    second-to-last), so that a cell in the halo reads its own faces"""
    moved = arr.movedim(axis, 0)
    n = moved.shape[0]
    rest = moved.shape[1:]
    skip = 1 if staggered else 0
    last = moved[n - skip - depth:n - skip].reshape(-1)
    first = moved[skip:skip + depth].reshape(-1)
    # my left halo is the left neighbour's last slices (sent forward)
    left_halo, right_halo = ring_exchange(last, first, group).wait()
    halo_shape = (depth,) + tuple(rest)
    padded = torch.cat(
        [left_halo.reshape(halo_shape), moved, right_halo.reshape(halo_shape)]
    )
    return padded.movedim(0, axis)


def make_sharded_bc(group):
    """MPDATA boundary condition of a decomposed axis: the ring halo
    exchange over ``group``"""
    return ("shard", group)
