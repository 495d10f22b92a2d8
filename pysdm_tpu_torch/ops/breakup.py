"""SDM collisional breakup (de Jong, Mackay et al. 2023) in float64, port
of ``pysdm_tpu/ops/breakup.py``: the collision path of every breakup that
K5 (``ops/cuda/breakup.py``) does not take (another croupier, u01
injection, ``handle_all_breakups``, functions K5 has no body for).

Semantics as the reference CPU kernels
(``PySDM/backends/impl_numba/methods/collisions_methods.py:62-243,248-311``):
the reference's per-pair serial loop in ``compute_transfer_multiplicities``
is a geometric recursion

    new_mult_k(g)  = mult_k * alpha * (1+beta)^(g-1)
    take_from_j(g) = mult_k * (1 + alpha * ((1+beta)^(g-1) - 1) / beta)

with ``alpha = (mass_j+mass_k)/fragment_mass`` and
``beta = mass_j/fragment_mass``, so the largest admissible number of
breakup events has a closed form through logarithms, evaluated for all
pairs at once and corrected by +-2 monotone validity checks.

Process per pair: bounce if ``rand > Ec + (1-Ec)*Eb``; coalesce if
``rand < Ec`` (the Shima update, ``ops/collisions.py`` ``coalesce``); else
break up.

The JAX package's two divergences from the reference stay (both guard
reference bugs):
- with ``handle_all_breakups`` the reference spins forever where the closed
  form yields no event without overflow; here, as there, the pair is
  deactivated and its remaining gamma goes to the deficit;
- the reference's equal-multiplicity overflow branch adds the deficit twice;
  here it is added once.

``handle_all_breakups`` runs the JAX package's ``while_loop`` as a Python
loop that reads its condition from the device (``read``, which the caller
counts) after each of the first ``_MAX_UNCHECKED`` iterations, then after
runs of 2, 4, ... and at most ``_MAX_UNCHECKED`` iterations: an iteration
in which no pair is active changes nothing, so the result is the
``while_loop``'s. A short loop (the usual one) runs no idle iteration; a
long one reads about once in ``_MAX_UNCHECKED`` iterations and runs at
most as many idle iterations as it ran past the first
``_MAX_UNCHECKED``, and fewer than ``_MAX_UNCHECKED``. On the card an idle
iteration costs its ~100 launches, a read little more than the wait for
the queued ones.
"""

import torch

from .collisions import add_rates, coalesce

_F64 = torch.float64
_TINY = torch.finfo(_F64).tiny
# iterations of the handle_all_breakups loop read one by one, and between
# two reads at most
_MAX_UNCHECKED = 32


def fragmentation_limiters(fragment_mass, mass_sum, *, vmin_mass=0.0, nfmax=None):
    """reference ``fragmentation_methods.py:_fragmentation_limiters_body``:
    NaN/zero fragment -> whole mass (no breakup); fragment <= total; at most
    nfmax fragments; fragments below vmin -> whole mass"""
    fm = torch.where(
        torch.isnan(fragment_mass) | (fragment_mass <= 0.0), mass_sum,
        fragment_mass,
    )
    fm = torch.minimum(fm, mass_sum)
    if nfmax is not None:
        fm_capped = torch.maximum(fm, mass_sum / nfmax)
        too_many = mass_sum / fm > nfmax
    else:
        fm_capped = fm
        too_many = torch.zeros_like(fm, dtype=torch.bool)
    fm = torch.where(
        too_many, fm_capped, torch.where(fm < vmin_mass, mass_sum, fm)
    )
    return torch.where(mass_sum <= 0.0, torch.ones_like(fm), fm)


def _transfer_closed_form(gamma_f, mult_j, mult_k, mass_j, mass_k, fm, max_mult):
    """closed form of reference ``compute_transfer_multiplicities``; all
    float64. Returns (take_from_j, new_mult_k, gamma_j_k, overflow)."""
    fm = fm.clamp_min(_TINY)
    alpha = (mass_j + mass_k) / fm
    beta = mass_j / fm
    beta_pos = beta > 0.0
    beta_safe = torch.where(beta_pos, beta, 1.0)
    log1pb = torch.log1p(beta_safe)
    mk = mult_k
    alpha_safe = alpha.clamp_min(_TINY)

    def pair_values(g):
        """(new_mult_k, take_from_j) accepted at gamma_j_k = g (g >= 1)"""
        p = torch.exp((g - 1.0) * log1pb)  # (1+beta)^(g-1)
        nmk = mk * alpha * p
        tfj = torch.where(
            beta_pos,
            mk * (1.0 + alpha * (p - 1.0) / beta_safe),
            mk * (1.0 + (g - 1.0) * alpha),
        )
        return nmk, tfj

    def valid(g):
        nmk, tfj = pair_values(g)
        return (g >= 1.0) & (g <= gamma_f) & (nmk <= max_mult) & (tfj <= mult_j)

    # log-estimates of the two monotone constraints' break points
    g1 = torch.floor(torch.log(max_mult / (mk * alpha_safe)) / log1pb) + 1.0
    rhs2 = 1.0 + beta_safe * (mult_j / mk - 1.0) / alpha_safe
    g2 = torch.where(
        beta_pos,
        torch.floor(torch.log(rhs2.clamp_min(1.0)) / log1pb) + 1.0,
        torch.floor((mult_j / mk - 1.0) / alpha_safe) + 1.0,
    )
    # jnp.clip(x, 0, gamma_f) = min(max(x, 0), gamma_f), NaN kept
    g = torch.minimum(g1, g2)
    g = torch.minimum(torch.minimum(g, gamma_f).clamp_min(0.0), gamma_f)
    g = torch.where(torch.isnan(g), 0.0, g)
    for _ in range(2):  # absorb log rounding: push up while still valid
        g = torch.where(valid(g + 1.0), g + 1.0, g)
    for _ in range(2):  # ...and down while invalid
        g = torch.where(valid(g) | (g <= 0.0), g, g - 1.0)
    g = g.clamp_min(0.0)

    nmk_g, tfj_g = pair_values(g.clamp_min(1.0))
    take_from_j = torch.where(g >= 1.0, tfj_g, 0.0)
    new_mult_k = torch.where(g >= 1.0, nmk_g, mk)
    nmk_next, _ = pair_values(g + 1.0)
    overflow = (g < gamma_f) & (nmk_next > max_mult)
    return take_from_j, new_mult_k, g, overflow


def _apply_breakup_update(mj, mk, ej, ek, take, new_mult_k):
    """reference ``get_new_multiplicities_and_update_attributes`` +
    ``round_multiplicities_to_ints_and_update_attributes``: redistribute
    attributes over the fragments, split j if fully consumed, round
    multiplicities to >= 1 integers rescaling attributes to conserve
    totals"""
    ek_mix = (ek * mk[None, :] + take[None, :] * ej) / new_mult_k[None, :]
    deplete = take >= mj
    nj = torch.where(deplete, new_mult_k / 2.0, mj - take)
    nk = torch.where(deplete, new_mult_k / 2.0, new_mult_k)
    ej_mix = torch.where(deplete[None, :], ek_mix, ej)
    mj_new = torch.round(nj).clamp_min(1.0)
    mk_new = torch.round(nk).clamp_min(1.0)
    ej_out = ej_mix * (nj / mj_new)[None, :]
    ek_out = ek_mix * (nk / mk_new)[None, :]
    return mj_new, mk_new, ej_out, ek_out


def _roles(j_is_a, a, b):
    """(j's, k's) values of a per-slot pair (a the leader's, b the
    partner's); rows broadcast the mask"""
    mask = j_is_a if a.dim() == 1 else j_is_a[None, :]
    return torch.where(mask, a, b), torch.where(mask, b, a)


def _break_up_while(a_m, b_m, a_e, b_e, do_break, gamma_f, fm, max_mult,
                    wm_idx, read, tally):
    """reference ``break_up_while`` (``handle_all_breakups``): transfer until
    gamma is spent, swapping the j and k roles as the multiplicities change.
    Returns (m_a, m_b, e_a, e_b, rate, deficit) in the leader/partner
    roles."""
    m_a, m_b, e_a, e_b = a_m, b_m, a_e, b_e
    act = do_break
    deficit = gamma_f
    rate = torch.zeros_like(gamma_f)
    defacc = torch.zeros_like(gamma_f)
    chunk, done = 1, 0
    while read(act.any()):
        for _ in range(chunk):
            m_a, m_b, e_a, e_b, act, deficit, rate, defacc = _break_up_once(
                m_a, m_b, e_a, e_b, act, deficit, rate, defacc, fm, max_mult,
                wm_idx,
            )
        tally(chunk)
        done += chunk
        if done >= _MAX_UNCHECKED:
            chunk = min(2 * chunk, _MAX_UNCHECKED)
    return m_a, m_b, e_a, e_b, rate, defacc


def _break_up_once(m_a, m_b, e_a, e_b, act, deficit, rate, defacc, fm,
                   max_mult, wm_idx):
    """one iteration of ``_break_up_while``; with no pair active it returns
    its arguments' values"""
    j_is_a = m_a >= m_b
    mj, mk = _roles(j_is_a, m_a, m_b)
    ej, ek = _roles(j_is_a, e_a, e_b)
    mass_j = torch.abs(ej[wm_idx])
    mass_k = torch.abs(ek[wm_idx])

    eq = mj == mk
    # equal-multiplicity branch: consume the whole deficit at once
    nmk_eq = (mass_j + mass_k) / fm.clamp_min(_TINY) * mk
    eq_overflow = nmk_eq > max_mult
    take_n, nmk_n, gjk_n, _ = _transfer_closed_form(
        deficit, mj, mk.clamp_min(1.0), mass_j, mass_k, fm, max_mult
    )
    take = torch.where(eq, mj, take_n)
    nmk = torch.where(eq, nmk_eq, nmk_n)
    gjk = torch.where(eq, deficit, gjk_n)
    # pairs making no progress (first-event overflow or eq-overflow)
    stalled = act & (eq & eq_overflow | ~eq & (gjk_n <= 0.0))
    doing = act & ~stalled
    gjk = torch.where(doing, gjk, 0.0)
    take = torch.where(doing, take, 0.0)
    nmk = torch.where(doing, nmk, mk)

    mj_new, mk_new, ej_new, ek_new = _apply_breakup_update(
        mj, mk, ej, ek, take, nmk
    )
    mj_new = torch.where(doing, mj_new, mj)
    mk_new = torch.where(doing, mk_new, mk)
    ej_new = torch.where(doing[None, :], ej_new, ej)
    ek_new = torch.where(doing[None, :], ek_new, ek)

    rate = rate + torch.where(doing, gjk * mk, 0.0)
    deficit_new = torch.where(doing, deficit - gjk, deficit)
    defacc = defacc + torch.where(stalled, deficit * mk, 0.0)
    act = doing & (deficit_new > 0.0)
    deficit = deficit_new
    m_a, m_b = _roles(j_is_a, mj_new, mk_new)
    e_a, e_b = _roles(j_is_a, ej_new, ek_new)
    return m_a, m_b, e_a, e_b, act, deficit, rate, defacc


def collision_coalescence_breakup(
    *, mult_s, ext_s, ext_names, gamma, rand, Ec, Eb, fragment_mass,
    pairing, counters, max_multiplicity, handle_all_breakups,
    cell_start=None, n_cell=1, read=bool, tally=lambda iterations: None,
):
    """bounce, coalescence and breakup of every pair of ``pairing``
    (``ops/pairing.py``) with its gamma, process draw ``rand``, Ec, Eb and
    fragment mass; returns (mult_s, ext_s). Adds the coalescence rate, the
    breakup rate and the breakup deficit to ``counters`` (one sum, or one
    per cell over the sorted slots from ``cell_start``). ``read(tensor)``
    turns a device boolean into a host one (``handle_all_breakups``'s loop
    reads one per run of iterations) and ``tally(n)`` is told of every run
    of ``n`` iterations."""
    is_first = pairing.is_first
    ftype = ext_s.dtype
    mult_dtype = mult_s.dtype
    active = is_first & (gamma > 0)
    bouncing = rand - (Ec + (1.0 - Ec) * Eb) > 0.0
    do_coal = active & ~bouncing & (rand - Ec < 0.0)
    do_break = active & ~bouncing & ~do_coal

    # coalescing pairs: the coalescence update
    gamma_c = torch.where(do_coal, gamma, 0)
    mult_s, ext_s, _ = coalesce(
        mult_s, ext_s, gamma_c, pairing, mask=do_coal, counters=counters,
        cell_start=cell_start, n_cell=n_cell,
    )

    # breaking pairs
    wm_idx = ext_names.index("signed water mass")
    a_m = mult_s.to(_F64)
    b_m = pairing.partner(mult_s).to(_F64)
    a_e = ext_s.to(_F64)
    b_e = pairing.partner(ext_s, axis=1).to(_F64)
    gamma_f = torch.where(do_break, gamma, 0).to(_F64)
    mass_sum_pair = torch.abs(a_e[wm_idx]) + torch.abs(b_e[wm_idx])
    fm = fragmentation_limiters(
        torch.as_tensor(fragment_mass, device=mult_s.device).to(_F64),
        mass_sum_pair,
    )
    max_mult = torch.tensor(
        float(max_multiplicity), dtype=_F64, device=mult_s.device
    )

    if not handle_all_breakups:
        j_is_a = a_m >= b_m
        mj, mk = _roles(j_is_a, a_m, b_m)
        ej, ek = _roles(j_is_a, a_e, b_e)
        take, new_mult_k, gjk, _ = _transfer_closed_form(
            gamma_f, mj, mk.clamp_min(1.0), torch.abs(ej[wm_idx]),
            torch.abs(ek[wm_idx]), fm, max_mult,
        )
        mj_new, mk_new, ej_new, ek_new = _apply_breakup_update(
            mj, mk, ej, ek, take, new_mult_k
        )
        rate = torch.where(do_break, gjk * mk, 0.0)
        deficit = torch.where(do_break, (gamma_f - gjk) * mk, 0.0)
        a_m_new, b_m_new = _roles(j_is_a, mj_new, mk_new)
        a_e_new, b_e_new = _roles(j_is_a, ej_new, ek_new)
    else:
        a_m_new, b_m_new, a_e_new, b_e_new, rate, deficit = _break_up_while(
            a_m, b_m, a_e, b_e, do_break, gamma_f, fm, max_mult, wm_idx,
            read, tally,
        )

    mult_out = pairing.merge(
        mult_s, torch.round(a_m_new).to(mult_dtype),
        torch.round(b_m_new).to(mult_dtype), do_break,
    )
    ext_out = pairing.merge(
        ext_s, a_e_new.to(ftype), b_e_new.to(ftype), do_break, axis=1
    )
    if counters is not None:
        add_rates(counters, "breakup_rate", rate, cell_start, n_cell)
        add_rates(counters, "breakup_rate_deficit", deficit, cell_start, n_cell)
    return mult_out, ext_out
