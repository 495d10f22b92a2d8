"""SDM collision ops (Shima et al. 2009), port of
``pysdm_tpu/ops/collisions.py``: the single-cell (mirror) and the
multi-cell (sorted-segment) branches.

The pair update itself (gamma draw, capping and the Shima update) is a
kernel of ``ops/cuda/collision.py`` (K1 or K2); these are the plain tensor
ops around it: the normalization factor, the adaptive substep choice and
the counter accumulation. Per-cell sums and minima run over the
cell-sorted slots of the sort croupier (``ops/segments.py``); a
``sorted_cell`` of None selects the single-cell branch.

Conventions: within a pair, ``j`` is the particle with the not-smaller
multiplicity, ``k`` the other (reference ``pair_methods.py:127-140``).
"""

import torch

from .segments import cell_counts, sorted_segment_min, sorted_segment_sum


def normalization_factor(cell_start, dt, dv, dtype):
    """Shima eq. 20 norm factor per cell: dt/dv * n(n-1)/2 / floor(n/2)
    (reference ``collisions_methods.py:634-650``), 0 where n < 2"""
    sd_num = cell_counts(cell_start).to(dtype)
    factor = dt / torch.tensor(dv, dtype=dtype) * sd_num * (sd_num - 1) / 2 / (
        torch.floor(sd_num / 2)
    )
    return torch.where(sd_num < 2, 0.0, factor)


def at_slots(per_cell, sorted_cell):
    """a per-cell row at every sorted slot (0 in the dead bucket)"""
    return torch.cat([per_cell, per_cell.new_zeros(1)])[sorted_cell]


def mirror_normalization_factor(dt, dv, n_sd, dtype, device):
    """normalization for the mirror croupier (single cell): every unordered
    pair is a candidate with probability exactly 1/N, so the Shima scaling
    1/P(candidate) is just N (``ops.pairing.MirrorPairing``)"""
    return torch.full((1,), dt / dv * n_sd, dtype=dtype, device=device)


def collision_probability(
    kernel_values, mult_s, norm_factor, pairing, sorted_cell=None
):
    """prob[p] = max(xi_p, xi_partner) * K * norm_factor[cell] at pair
    leaders"""
    max_mult = torch.maximum(mult_s, pairing.partner(mult_s)).to(
        kernel_values.dtype
    )
    if sorted_cell is None:
        norm = norm_factor[0]
    else:
        norm = at_slots(norm_factor, sorted_cell)
    prob = max_mult * kernel_values * norm
    return torch.where(pairing.is_first, prob, 0.0)


def scale_prob_adaptive(
    *, prob, mult_s, dt_left, dt, dt_range, stats_n_substep, pairing,
    sorted_cell=None, n_cell=1,
):
    """per-cell adaptive substep scaling
    (reference ``collisions_methods.py:330-378``): pick each cell's largest
    substep dt_todo <= min(dt_left, dt_max) that keeps every pair's expected
    collision count ~<= its multiplicity ratio, and decrement dt_left.
    Returns (dt_left, stats_n_substep, dt_todo); dt_todo/dt is the
    probability scale the kernel applies (the JAX package folds it into its
    kernel's input the same way)."""
    ftype = prob.dtype
    mult_p = pairing.partner(mult_s)
    mj = torch.maximum(mult_s, mult_p)
    mk = torch.minimum(mult_s, mult_p)
    # the JAX package takes the f32/f64 image of the floor division here
    # (it only paces the substep); kept identical for parity
    prop = torch.floor(mj.to(ftype) / mk.clamp_min(1).to(ftype))
    dt_optimal = dt * prop / torch.where(prob > 0, prob, 1.0)
    dt_optimal = dt_optimal.clamp_min(dt_range[0])
    dt_optimal = torch.where(
        pairing.is_first & (prob > 0), dt_optimal, torch.inf
    )
    if sorted_cell is None:
        per_cell_opt = dt_optimal.min()[None]
    else:
        per_cell_opt = sorted_segment_min(dt_optimal, sorted_cell, n_cell)
    dt_todo = torch.minimum(dt_left.clamp_max(dt_range[1]), per_cell_opt)
    stats_n_substep = stats_n_substep + (dt_todo > 0)
    return dt_left - dt_todo, stats_n_substep, dt_todo


def per_cell_rates(values, cell_start, n_cell):
    """float32 per-cell sums of a per-slot rate row, or of ``(R, n)`` rate
    rows in one scan (K4 under ``sorted_segment_sum``); the JAX package sums
    rates in float32 whatever the counter's dtype"""
    return sorted_segment_sum(values.to(torch.float32), cell_start, n_cell)


def accumulate_counter(counter, total, counters):
    """add one substep's float32 sums ``total`` (a 0-d tensor for one cell,
    else one per cell) to a rate counter, and record the largest per-step
    sum in ``counters["rate_step_sum_max"]`` (sums past 2^24 are no longer
    exact in float32; the reference accumulates exactly via int64 atomics)"""
    s = total.reshape(-1)
    counters["rate_step_sum_max"] = torch.maximum(
        counters["rate_step_sum_max"], s.max()[None]
    )
    if counter.dtype.is_floating_point:
        return counter + s.to(counter.dtype)
    return counter + torch.round(s).to(counter.dtype)
