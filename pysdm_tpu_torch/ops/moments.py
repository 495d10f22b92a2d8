"""Statistical-moment reductions over particles (port of
``pysdm_tpu/ops/moments.py``; reference
``PySDM/backends/impl_numba/methods/moments_methods.py``).

Dead particles carry multiplicity 0 and vanish from every sum. The sums are
deterministic on every device: the values are sorted by their segment
((bin, cell) or cell) with a stable sort and each segment is reduced on its
own (``torch.segment_reduce``, in two passes: ``segment_sums``), in
float64 whatever the backend's float dtype, and returned in that dtype. A float ``index_add_`` or
``scatter_add_`` adds in another order from run to run on CUDA; a float32
prefix difference loses the small segments next to large ones (ROADMAP,
"float32 per-cell sums by prefix difference"); and a float32 running sum
over one segment of 2^20 particles drifts by 0.4% (the total volume of the
Srivastava box on the card).
"""

import torch


# elements of one segment that one thread adds in the first of the two
# passes of ``segment_sums``
_PIECE = 1024


def segment_sums(values, segment, n_segments):
    """per-segment sums of the columns of ``values`` (n, k) for integer
    ``segment`` ids (n,) in [0, n_segments); (n_segments, k) in ``values``'
    dtype, added in float64 in a fixed order.

    ``torch.segment_reduce`` adds each segment in one thread, which takes
    ~50 ms on the card for a box's one segment of 2^20 particles. So the
    sorted values are added in two passes: pieces of at most ``_PIECE``
    elements of one segment, then each segment's pieces. The pieces are
    laid out on the device for the most a state of n particles can need,
    n // _PIECE + n_segments, the unused ones empty, so nothing is read
    back to the host."""
    order = torch.argsort(segment, stable=True)
    lengths = torch.bincount(segment, minlength=n_segments)
    pieces = (lengths + _PIECE - 1) // _PIECE  # per segment
    ends = torch.cumsum(pieces, 0)
    q = torch.arange(
        values.shape[0] // _PIECE + n_segments, device=values.device
    )
    owner = torch.searchsorted(ends, q, right=True)
    s = owner.clamp_max(n_segments - 1)
    first = (q - (ends[s] - pieces[s])) * _PIECE  # the piece's offset
    piece_lengths = torch.where(
        owner < n_segments, (lengths[s] - first).clamp(0, _PIECE), 0
    )
    partial = torch.segment_reduce(
        values[order].to(torch.float64), "sum", lengths=piece_lengths, axis=0
    )
    per_segment = torch.cat([pieces, (q.shape[0] - ends[-1:])])
    sums = torch.segment_reduce(partial, "sum", lengths=per_segment, axis=0)
    return sums[:n_segments].to(values.dtype)


def cell_sums(values, cell, n_cell):
    """per-cell sums of ``values`` (n,) for cell ids ``cell`` (n,), added in
    float64 in a fixed order and returned in ``values``' dtype: one sum for
    a single cell, ``segment_sums`` otherwise"""
    if n_cell == 1:
        return values.sum(dtype=torch.float64).to(values.dtype)[None]
    return segment_sums(values[:, None], cell, n_cell)[:, 0]


def _weights(multiplicity, ftype, weighting_attribute, weighting_rank):
    weight = multiplicity.to(ftype)
    if weighting_rank != 0 and weighting_attribute is not None:
        weight = weight * weighting_attribute**weighting_rank
    return weight


def moments(
    *,
    multiplicity,
    attr_data,
    cell_id,
    ranks,
    filter_attr_data,
    min_x,
    max_x,
    n_cell,
    weighting_attribute=None,
    weighting_rank=0,
    skip_division_by_m0=False,
):
    """per-cell weighted moments of ``attr_data`` for particles with
    min_x <= filter_attr_data < max_x; returns (moment_0[n_cell],
    moments[n_ranks, n_cell])"""
    ftype = attr_data.dtype
    in_range = (filter_attr_data >= min_x) & (filter_attr_data < max_x)
    weight = _weights(multiplicity, ftype, weighting_attribute, weighting_rank)
    weight = torch.where(in_range, weight, 0.0)
    columns = [weight] + [
        weight * attr_data**rank if rank != 0 else weight for rank in ranks
    ]
    sums = segment_sums(torch.stack(columns, dim=1), cell_id.long(), n_cell)
    m0, mks = sums[:, 0], sums[:, 1:].T
    if not skip_division_by_m0:
        mks = torch.where(
            m0[None, :] != 0, mks / torch.where(m0 == 0, 1.0, m0)[None, :], 0.0
        )
    return m0, mks


def spectrum_moments(
    *,
    multiplicity,
    attr_data,
    x_attr,
    cell_id,
    x_bins,
    rank,
    n_cell,
    weighting_attribute=None,
    weighting_rank=0,
):
    """per-(bin, cell) weighted moments; returns (moment_0, moments) each of
    shape (n_bins, n_cell) with moments normalized by per-bin moment_0"""
    ftype = attr_data.dtype
    n_bins = x_bins.shape[0] - 1
    k = torch.searchsorted(x_bins, x_attr, right=True) - 1
    valid = (k >= 0) & (k < n_bins)
    weight = _weights(multiplicity, ftype, weighting_attribute, weighting_rank)
    weight = torch.where(valid, weight, 0.0)
    segment = torch.where(valid, k, 0) * n_cell + cell_id.long()
    values = torch.stack(
        [weight, weight * attr_data**rank if rank != 0 else weight], dim=1
    )
    sums = segment_sums(values, segment, n_bins * n_cell)
    m0 = sums[:, 0].reshape(n_bins, n_cell)
    m1 = sums[:, 1].reshape(n_bins, n_cell)
    mom = torch.where(m0 != 0, m1 / torch.where(m0 == 0, 1.0, m0), 0.0)
    return m0, mom
