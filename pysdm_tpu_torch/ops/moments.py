"""Statistical-moment reductions over particles (port of
``pysdm_tpu/ops/moments.py``; reference
``PySDM/backends/impl_numba/methods/moments_methods.py``).

Dead particles carry multiplicity 0 and vanish from every sum. The sums are
deterministic on every device: the values are sorted by their segment
((bin, cell) or cell) with a stable sort and each segment is reduced on its
own in the backend's float dtype (``torch.segment_reduce``). A float
``index_add_`` or ``scatter_add_`` adds in another order from run to run on
CUDA, and a float32 prefix difference loses the small segments next to
large ones (ROADMAP queue 3).
"""

import torch


def segment_sums(values, segment, n_segments):
    """per-segment sums of the columns of ``values`` (n, k) for integer
    ``segment`` ids (n,) in [0, n_segments); (n_segments, k), in a fixed
    order"""
    order = torch.argsort(segment, stable=True)
    lengths = torch.bincount(segment, minlength=n_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0)


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
