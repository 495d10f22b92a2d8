"""SDM collision ops (Shima et al. 2009), port of
``pysdm_tpu/ops/collisions.py``: the single-cell (mirror) and the
multi-cell (sorted-segment) branches.

The pair update itself (gamma draw, capping and the Shima update) is a
kernel of ``ops/cuda/collision.py`` (K1, K1a or K2) where the JAX package
takes a Pallas kernel; these are the plain tensor ops around it: the
normalization factor, the adaptive substep choice and the counter
accumulation. Per-cell sums and minima run over the cell-sorted slots of
the sort croupier (``ops/segments.py``); a ``sorted_cell`` (or
``cell_start``) of None selects the single-cell branch.

Where the JAX package takes its XLA ops instead (collisions with breakup
outside K5, a state with max-merged rows, u01-injected breakup), the pair
update is ``compute_gamma`` and ``coalesce`` below (then ``ops/breakup.py``)
on either pairing (``ops/pairing.py``), in the state's float dtype. gamma is
capped by an exact int64 division here; the JAX package walks an f32
quotient estimate +-5 steps (``capped_floor_div``), which misses the exact
floor when floor(xi_j/xi_k) is above ~2^26 and below the cap (ROADMAP,
"large-quotient gamma"). The per-cell rate sums run in float32 through K4
(``per_cell_rates``), as the JAX package sums them in float32.

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
    sum in ``counters["rate_step_sum_max"]``, where that slot exists (sums
    past 2^24 are no longer exact in float32; the reference accumulates
    exactly via int64 atomics)"""
    s = total.reshape(-1)
    if "rate_step_sum_max" in counters:
        counters["rate_step_sum_max"] = torch.maximum(
            counters["rate_step_sum_max"], s.max()[None]
        )
    if counter.dtype.is_floating_point:
        return counter + s.to(counter.dtype)
    return counter + torch.round(s).to(counter.dtype)


def add_rates(counters, name, values, cell_start=None, n_cell=1):
    """add the float32 sums of a per-slot rate row (zero off the pair
    leaders) to ``counters[name]``: one sum for a single cell
    (``cell_start`` None), else one per cell over the sorted slots (K4)"""
    if cell_start is None:
        total = values.to(torch.float32).sum()
    else:
        total = per_cell_rates(values, cell_start, n_cell)
    counters[name] = accumulate_counter(counters[name], total, counters)


# gamma's float estimate is clamped here before its cast to int64; any
# admissible quotient xi_j / xi_k is far below it
_GAMMA_F_MAX = 2.0**62


def compute_gamma(
    prob, rand, mult_s, pairing, counters=None, cell_start=None, n_cell=1
):
    """gamma = ceil(prob - rand), capped at floor(xi_j / xi_k), at pair
    leaders (reference ``collisions_methods.py:522-560``); adds the
    collision rate and its deficit to ``counters`` when given. Returns
    gamma in the multiplicities' dtype."""
    is_first = pairing.is_first
    gamma_f = torch.ceil(prob - rand).clamp_min(0.0)
    gamma_f = torch.where(is_first, gamma_f, 0.0)
    mult_p = pairing.partner(mult_s)
    mj = torch.maximum(mult_s, mult_p)
    mk = torch.minimum(mult_s, mult_p)
    cap = gamma_f.clamp_max(_GAMMA_F_MAX).to(mult_s.dtype)
    gamma = torch.minimum(cap, mj // mk.clamp_min(1))
    gamma = torch.where(is_first, gamma, 0)
    if counters is not None:
        rate = gamma.to(torch.float32) * mk.to(torch.float32)
        deficit = (gamma_f - gamma.to(gamma_f.dtype)) * mk.to(gamma_f.dtype)
        for name, row in (
            ("collision_rate", rate), ("collision_rate_deficit", deficit),
        ):
            add_rates(
                counters, name, torch.where(is_first, row, 0.0), cell_start,
                n_cell,
            )
    return gamma


def coalesce(
    mult_s, ext_s, gamma, pairing, mask=None, counters=None, cell_start=None,
    n_cell=1, max_s=None,
):
    """Shima 2009 coalescence update (reference
    ``collisions_methods.py:45-59``) of the pairs in ``mask`` (default: every
    pair leader): xi_j -= gamma xi_k and extensive_k += gamma extensive_j;
    when xi_j hits 0 the j droplet takes half of k's multiplicity and k's
    attributes. Max-merged rows (``max_s``, the freezing records) take the
    pair's ``fmax`` where k absorbed anything (NaN is "not recorded" and
    loses to a value), and both halves in a split, as the JAX package's
    ``coalesce`` does (``pysdm_tpu/ops/collisions.py:252-326``; the
    reference leaves them unwired, TODO #594). Adds the coalescence rate to
    ``counters`` when given. Returns (mult, ext, max_s), max_s None when
    none was given."""
    mask = pairing.is_first if mask is None else mask
    a_m, b_m = mult_s, pairing.partner(mult_s)
    a_e, b_e = ext_s, pairing.partner(ext_s, axis=1)

    j_is_a = a_m >= b_m
    mj = torch.where(j_is_a, a_m, b_m)
    mk = torch.where(j_is_a, b_m, a_m)
    ej = torch.where(j_is_a[None, :], a_e, b_e)
    ek = torch.where(j_is_a[None, :], b_e, a_e)

    g = torch.where(mask, gamma, 0)
    gf = g.to(ext_s.dtype)
    new_n = mj - g * mk
    split = mask & (new_n == 0) & (g > 0)
    mk_half = mk // 2
    mj_new = torch.where(split, mk_half, new_n)
    mk_new = torch.where(split, mk - mk_half, mk)
    # k absorbs g copies of j; in a split both slots take the merged values
    ek_new = ek + gf[None, :] * ej
    ej_new = torch.where(split[None, :], ek_new, ej)

    if counters is not None:
        coal = g.to(torch.float32) * mk.to(torch.float32)
        add_rates(
            counters, "coalescence_rate", torch.where(mask, coal, 0.0),
            cell_start, n_cell,
        )

    a_m_new = torch.where(j_is_a, mj_new, mk_new)
    b_m_new = torch.where(j_is_a, mk_new, mj_new)
    a_e_new = torch.where(j_is_a[None, :], ej_new, ek_new)
    b_e_new = torch.where(j_is_a[None, :], ek_new, ej_new)
    mult_out = pairing.merge(mult_s, a_m_new, b_m_new, mask)
    ext_out = pairing.merge(ext_s, a_e_new, b_e_new, mask, axis=1)
    if max_s is None:
        return mult_out, ext_out, None

    a_x, b_x = max_s, pairing.partner(max_s, axis=1)
    xj = torch.where(j_is_a[None, :], a_x, b_x)
    xk = torch.where(j_is_a[None, :], b_x, a_x)
    merged_x = torch.fmax(xj, xk)
    xk_new = torch.where((g > 0)[None, :], merged_x, xk)
    xj_new = torch.where(split[None, :], merged_x, xj)
    a_x_new = torch.where(j_is_a[None, :], xj_new, xk_new)
    b_x_new = torch.where(j_is_a[None, :], xk_new, xj_new)
    max_out = pairing.merge(max_s, a_x_new, b_x_new, mask, axis=1)
    return mult_out, ext_out, max_out
