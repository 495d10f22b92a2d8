"""Cell bucketing and per-cell reductions over the cell-sorted state (port
of ``pysdm_tpu/ops/segments.py``).

One sort of the particles by the packed key (cell, random bits) gives both
the cell segments and a uniform random order within each cell (the sort
croupier); dead particles (multiplicity 0) go to a trailing bucket, cell
``n_cell``. Per-cell sums over sorted slots are differences of one prefix
sum (K4, ``ops/cuda/scan.py``), with no scatter-add; rows that share their
segments are summed together, in one scan.

The key is an int64 ``(cell << nbits) | bits``: it orders as the JAX
package's u32 key does (``:36-59``, and as its two-key sort where fewer
than 16 random bits fit). ``torch.sort`` carries no payloads, so every row
is gathered through the permutation; cell id and cell origin are rebuilt
from the sorted key.
"""

import numpy as np
import torch

from .cuda.scan import cumsum


def rand_bits_for(n_cell):
    """bits of per-cell randomness in the packed key (the JAX package's
    u32 layout: the cell, dead bucket included, takes the high bits)"""
    cell_bits = max(1, int(np.ceil(np.log2(n_cell + 1))))
    return 32 - cell_bits


def shuffle_bits(rand, n_cell):
    """the random part of the key: ``rand`` as u01 floats (the injected
    streams; ``floor(u * 2^nbits)`` in float32 as the JAX package converts
    them) or as integers already in [0, 2^nbits)"""
    nbits = rand_bits_for(n_cell)
    if rand.dtype.is_floating_point:
        bits = (rand.to(torch.float32) * np.float32(2.0**nbits)).to(torch.int64)
        return bits.clamp_max(2**nbits - 1)
    return rand.to(torch.int64)


def _cell_start(sorted_cell, n_cell):
    """segment starts (n_cell + 1,); the last entry counts the live slots"""
    return torch.searchsorted(
        sorted_cell,
        torch.arange(n_cell + 1, dtype=sorted_cell.dtype, device=sorted_cell.device),
    )


def reconstruct_cell_rows(particles, sorted_cell, n_cell, mesh=None):
    """cell id and cell origin rebuilt from the sorted cells (dead slots
    clip to cell n_cell - 1; multiplicity 0 masks them everywhere)"""
    cell_id = sorted_cell.clamp_max(n_cell - 1).to(torch.int32)
    if particles.cell_origin.shape[0] == 0:
        return particles.replace(cell_id=cell_id)
    if mesh is None:
        raise ValueError("the mesh is needed to rebuild cell_origin")
    rows = []
    rem = cell_id.to(torch.int64)
    for s in np.asarray(mesh.strides).ravel():
        rows.append(torch.div(rem, int(s), rounding_mode="floor"))
        rem = torch.remainder(rem, int(s))
    origin = torch.stack(rows).to(particles.cell_origin.dtype)
    return particles.replace(cell_id=cell_id, cell_origin=origin)


def _permute_rows(particles, order):
    """multiplicity, extensive rows and position in cell gathered through
    ``order`` (cell rows are rebuilt by the caller)"""
    return particles.replace(
        multiplicity=particles.multiplicity[order],
        extensive=particles.extensive[:, order],
        position_in_cell=particles.position_in_cell[:, order],
    )


def _is_first(sorted_cell, cell_start, n_cell):
    """slot p leads the pair (p, p + 1): same cell and an even offset from
    the cell's segment start (reference ``pair_methods.py:35-55``)"""
    n_sd = sorted_cell.shape[0]
    p = torch.arange(n_sd, dtype=torch.int64, device=sorted_cell.device)
    offset = p - cell_start[sorted_cell]
    same_as_next = torch.zeros_like(sorted_cell, dtype=torch.bool)
    same_as_next[:-1] = sorted_cell[1:] == sorted_cell[:-1]
    return same_as_next & (offset % 2 == 0) & (sorted_cell < n_cell)


def bucket_shuffle_state(particles, rand, n_cell, mesh=None):
    """sort the whole state by (cell, random key): the sort croupier. The
    returned state is in sorted-slot order. ``rand``: u01 floats or
    integer bits (``shuffle_bits``). Returns (sorted_particles,
    sorted_cell, cell_start, is_first)."""
    nbits = rand_bits_for(n_cell)
    key_cell = torch.where(
        particles.alive, particles.cell_id.to(torch.int64), n_cell
    )
    key = (key_cell << nbits) | shuffle_bits(rand, n_cell)
    sorted_key, order = torch.sort(key, stable=True)
    sorted_cell = sorted_key >> nbits
    cell_start = _cell_start(sorted_cell, n_cell)
    is_first = _is_first(sorted_cell, cell_start, n_cell)
    sorted_particles = reconstruct_cell_rows(
        _permute_rows(particles, order), sorted_cell, n_cell, mesh
    )
    return sorted_particles, sorted_cell, cell_start, is_first


def sort_state_by_cell(particles, n_cell, mesh=None):
    """stable sort of the whole state by cell id, dead particles to the
    trailing bucket. Returns (sorted_particles, sorted_cell, cell_start)."""
    key_cell = torch.where(
        particles.alive, particles.cell_id.to(torch.int64), n_cell
    )
    sorted_cell, order = torch.sort(key_cell, stable=True)
    cell_start = _cell_start(sorted_cell, n_cell)
    sorted_particles = reconstruct_cell_rows(
        _permute_rows(particles, order), sorted_cell, n_cell, mesh
    )
    return sorted_particles, sorted_cell, cell_start


def cell_start_of_sorted(cell_id, n_cell):
    """segment starts of a state already sorted by cell id"""
    return _cell_start(cell_id.to(torch.int64), n_cell)


def sorted_segment_sum(values, cell_start, n_cell):
    """per-cell sums over cell-sorted slots as differences of one inclusive
    prefix sum (K4 on CUDA tensors): sum_i = c[start[i+1]] - c[start[i]].
    ``values`` is one row ``(n,)``, giving ``(n_cell,)``, or rows ``(R, n)``
    that share ``cell_start``, giving ``(R, n_cell)`` from one scan and one
    pair of gathers, each row equal to its own call bit for bit. Exact for
    integers; for floats the error is that of a prefix over the whole
    array, ~eps |prefix| per cell."""
    c = cumsum(values)
    cpad = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)
    return (
        cpad[..., cell_start[1 : n_cell + 1]] - cpad[..., cell_start[:n_cell]]
    )


def sorted_segment_min(values, sorted_cell, n_cell):
    """per-cell min over sorted slots; empty cells give +inf (a min does
    not depend on the order of its inputs, so ``scatter_reduce`` is
    deterministic here)"""
    out = torch.full(
        (n_cell + 1,), torch.inf, dtype=values.dtype, device=values.device
    )
    out = out.scatter_reduce(0, sorted_cell, values, reduce="amin")
    return out[:n_cell]


def cell_counts(cell_start):
    return torch.diff(cell_start)


def pair_roll(x, axis=0):
    """value at slot p + 1 (garbage at the last slot, which never leads a
    pair)"""
    return torch.roll(x, -1, dims=axis)
