"""MPDATA Eulerian advection in PyTorch (port of ``pysdm_tpu/ops/mpdata.py``;
N-dimensional, Arakawa-C staggered grid).

Algorithm: Smolarkiewicz & Margolin 1998 (J. Comp. Phys. 140) / the
libmpdata++ formulation (Jaruga et al. 2015, GMD 8) with the options the
reference's examples use: ``n_iters``, ``infinite_gauge``,
``nonoscillatory`` (FCT), ``third_order_terms``, a non-unit g-factor
(G = rhod), periodic and extrapolated boundary conditions. Conventions:

- cell field ``psi``: shape ``grid``;
- advector ``gc[d]`` = G * courant at faces: shape ``grid`` with ``+1``
  along axis ``d`` (boundary faces included);
- g-factor ``g``: shape ``grid`` (or None for G = 1).

The fields are small (625 cells in the 2D warm rain), so the step is a few
hundred elementwise launches and no kernel of its own. A decomposed axis
takes a ``("shard", group)`` boundary condition: its pads are halo
exchanges between the ranks of ``group`` (``parallel/halo.py``).

Spans (while a profiler records, ``utils/profiling.py``), named for the
dynamic that runs the step: ``EulerianAdvection.upwind`` (the upwind
pass), ``EulerianAdvection.antidiffusive`` (each corrective iteration) and,
inside it, ``EulerianAdvection.fct`` (the nonoscillatory limiter).
"""

import torch

from ..utils.profiling import span

PERIODIC = "periodic"
EXTRAPOLATED = "extrapolated"  # constant (zero-gradient) scalar extrapolation


def _eps(dtype):
    return 1e-15 if torch.finfo(dtype).bits == 64 else 1e-7


def _pad1(arr, axis, bc, depth=1):
    """halo-``depth`` pad along one axis: wrapped (periodic), edge copies
    (extrapolated), or, for a ``("shard", group)`` bc, the ring
    neighbours' boundary slices (``parallel/halo.py``: global-periodic
    across the ranks of ``group``)"""
    if isinstance(bc, tuple):
        if bc[0] != "shard":
            raise ValueError(f"unknown boundary condition {bc!r}")
        from ..parallel.halo import ring_halo_pad

        return ring_halo_pad(arr, axis, bc[1], depth=depth)
    n = arr.shape[axis]
    if bc == PERIODIC:
        lo = arr.narrow(axis, n - depth, depth)
        hi = arr.narrow(axis, 0, depth)
    else:
        lo = arr.narrow(axis, 0, 1).repeat_interleave(depth, dim=axis)
        hi = arr.narrow(axis, n - 1, 1).repeat_interleave(depth, dim=axis)
    return torch.cat([lo, arr, hi], dim=axis)


def _pad_all(psi, bcs, depth=1):
    for ax, bc in enumerate(bcs):
        psi = _pad1(psi, ax, bc, depth=depth)
    return psi


def _face_view(psi_p, d, side, shifts=()):
    """cell values adjacent to the n_d+1 faces along axis d, from the
    everywhere-padded field; side 0 = left cell, 1 = right cell; ``shifts``
    optionally offsets other axes by -1/0/+1 (cross-derivative stencils)"""
    shifts = dict(shifts)
    idx = []
    for ax in range(psi_p.ndim):
        if ax == d:
            idx.append(slice(side, psi_p.shape[ax] - 1 + side))
        else:
            s = shifts.get(ax, 0)
            idx.append(slice(1 + s, psi_p.shape[ax] - 1 + s))
    return psi_p[tuple(idx)]


def _face_view_deep(psi_p2, d, offset, shifts=()):
    """cell values at relative position ``offset`` w.r.t. the n_d+1 faces
    along axis d (0 = left cell, 1 = right cell, +2/-1 = next-nearest),
    from the everywhere-halo-2-padded field"""
    shifts = dict(shifts)
    idx = []
    for ax in range(psi_p2.ndim):
        if ax == d:
            idx.append(slice(1 + offset, psi_p2.shape[ax] - 2 + offset))
        else:
            s = shifts.get(ax, 0)
            idx.append(slice(2 + s, psi_p2.shape[ax] - 2 + s))
    return psi_p2[tuple(idx)]


def _flux_divergence(fluxes, psi_shape):
    div = 0.0
    for d, flx in enumerate(fluxes):
        idx_hi = [slice(None)] * len(psi_shape)
        idx_lo = [slice(None)] * len(psi_shape)
        idx_hi[d] = slice(1, None)
        idx_lo[d] = slice(0, -1)
        div = div + (flx[tuple(idx_hi)] - flx[tuple(idx_lo)])
    return div


def _pos(x):
    return x.clamp_min(0.0)


def _neg(x):
    return x.clamp_max(0.0)


def _upwind_fluxes(psi_p, gc):
    fluxes = []
    for d, gc_d in enumerate(gc):
        psi_l = _face_view(psi_p, d, 0)
        psi_r = _face_view(psi_p, d, 1)
        fluxes.append(_pos(gc_d) * psi_l + _neg(gc_d) * psi_r)
    return fluxes


def _frac(num, den, dtype):
    return num / (den + _eps(dtype))


def _gc_bar(gc_q, d, q, bcs):
    """average of the 4 q-faces around each d-face"""
    gp = _pad1(gc_q, d, bcs[d])

    def sl(d_off, q_off):
        idx = []
        for ax in range(gp.ndim):
            if ax == d:
                idx.append(slice(d_off, gp.shape[ax] - 1 + d_off))
            elif ax == q:
                idx.append(slice(q_off, gp.shape[ax] - 2 + q_off + 1))
            else:
                idx.append(slice(None))
        return gp[tuple(idx)]

    return 0.25 * (sl(0, 0) + sl(0, 1) + sl(1, 0) + sl(1, 1))


def _g_at_faces(g, d, bc):
    gp = _pad1(g, d, bc)
    idx_l = [slice(None)] * gp.ndim
    idx_r = [slice(None)] * gp.ndim
    idx_l[d] = slice(0, -1)
    idx_r[d] = slice(1, None)
    return 0.5 * (gp[tuple(idx_l)] + gp[tuple(idx_r)])


def _antidiffusive_gc(psi, gc, g, bcs, infinite_gauge, third_order_terms=False):
    """pseudo-velocity GC' per SM98 eq. 13 generalised to non-unit G
    (libmpdata++ eqs. 29-32), with the SM98 eq. 36 corrections when
    ``third_order_terms``"""
    dtype = psi.dtype
    ndim = psi.ndim
    psi_p = _pad_all(psi, bcs)
    psi_p2 = _pad_all(psi, bcs, depth=2) if third_order_terms else None
    gc_out = []
    for d, gc_d in enumerate(gc):
        psi_l = _face_view(psi_p, d, 0)
        psi_r = _face_view(psi_p, d, 1)
        if infinite_gauge:
            a_term = 0.5 * (psi_r - psi_l)
        else:
            a_term = _frac(
                psi_r.abs() - psi_l.abs(), psi_r.abs() + psi_l.abs(), dtype
            )
        g_bar = (
            _g_at_faces(g, d, bcs[d]) if g is not None else torch.ones_like(gc_d)
        )
        out = (gc_d.abs() - gc_d**2 / g_bar) * a_term
        for q in range(ndim):
            if q == d:
                continue
            lu = _face_view(psi_p, d, 0, {q: +1})
            ru = _face_view(psi_p, d, 1, {q: +1})
            ld = _face_view(psi_p, d, 0, {q: -1})
            rd = _face_view(psi_p, d, 1, {q: -1})
            if infinite_gauge:
                b_term = 0.5 * (lu + ru - ld - rd) / 4.0
            else:
                b_term = 0.5 * _frac(
                    lu.abs() + ru.abs() - ld.abs() - rd.abs(),
                    lu.abs() + ru.abs() + ld.abs() + rd.abs(),
                    dtype,
                )
            out = out - gc_d * _gc_bar(gc[q], d, q, bcs) / g_bar * b_term

        if third_order_terms:
            p2 = _face_view_deep(psi_p2, d, 2)
            p1 = _face_view_deep(psi_p2, d, 1)
            p0 = _face_view_deep(psi_p2, d, 0)
            pm = _face_view_deep(psi_p2, d, -1)
            coef = (
                3.0 * gc_d * gc_d.abs() / g_bar
                - 2.0 * gc_d**3 / g_bar**2
                - gc_d
            ) / 6.0
            if infinite_gauge:
                tot = coef * (p2 - p1 - p0 + pm) / 2.0
            else:
                tot = coef * 2.0 * _frac(
                    p2.abs() - p1.abs() - p0.abs() + pm.abs(),
                    p2.abs() + p1.abs() + p0.abs() + pm.abs(),
                    dtype,
                )
            out = out + tot
            for q in range(ndim):
                if q == d:
                    continue
                lu = _face_view(psi_p, d, 0, {q: +1})
                ru = _face_view(psi_p, d, 1, {q: +1})
                ld = _face_view(psi_p, d, 0, {q: -1})
                rd = _face_view(psi_p, d, 1, {q: -1})
                coef_x = (
                    _gc_bar(gc[q], d, q, bcs)
                    / (2.0 * g_bar)
                    * (gc_d.abs() - 2.0 * gc_d**2 / g_bar)
                )
                if infinite_gauge:
                    tot_x = coef_x * (ru - lu - rd + ld) / 2.0
                else:
                    tot_x = coef_x * 2.0 * _frac(
                        ru.abs() - lu.abs() - rd.abs() + ld.abs(),
                        ru.abs() + lu.abs() + rd.abs() + ld.abs(),
                        dtype,
                    )
                out = out + tot_x
        gc_out.append(out)
    return gc_out


def _local_extrema(psi_p, psi0_p, d_axes, reduce_fn):
    """per-cell extremum over the cell and its face neighbours along every
    axis, for both the initial and the current iterate"""
    ext = None
    for arr in (psi_p, psi0_p):
        centre_idx = tuple(slice(1, s - 1) for s in arr.shape)
        vals = [arr[centre_idx]]
        for d in d_axes:
            lo = tuple(
                slice(0, s - 2) if ax == d else slice(1, s - 1)
                for ax, s in enumerate(arr.shape)
            )
            hi = tuple(
                slice(2, s) if ax == d else slice(1, s - 1)
                for ax, s in enumerate(arr.shape)
            )
            vals += [arr[lo], arr[hi]]
        cand = vals[0]
        for v in vals[1:]:
            cand = reduce_fn(cand, v)
        ext = cand if ext is None else reduce_fn(ext, cand)
    return ext


def _fct_limit(psi, psi0, gc_corr, g, bcs, infinite_gauge):
    """nonoscillatory (flux-corrected transport) limiting of the corrective
    pseudo-velocities (Smolarkiewicz & Grabowski 1990; libmpdata++ eqs.
    37-42)"""
    dtype = psi.dtype
    ndim = psi.ndim
    psi_p = _pad_all(psi, bcs)
    psi0_p = _pad_all(psi0, bcs)
    axes = range(ndim)
    psi_max = _local_extrema(psi_p, psi0_p, axes, torch.maximum)
    psi_min = _local_extrema(psi_p, psi0_p, axes, torch.minimum)

    g_cell = g if g is not None else torch.ones_like(psi)
    flux_in = torch.zeros_like(psi)
    flux_out = torch.zeros_like(psi)
    for d, gc_d in enumerate(gc_corr):
        if infinite_gauge:
            donor_l = donor_r = torch.ones_like(gc_d)
        else:
            donor_l = _face_view(psi_p, d, 0).abs()
            donor_r = _face_view(psi_p, d, 1).abs()
        lf = tuple(slice(0, -1) if ax == d else slice(None) for ax in range(ndim))
        rf = tuple(slice(1, None) if ax == d else slice(None) for ax in range(ndim))
        # into cell i: + through left face, - through right face
        flux_in = (
            flux_in
            + _pos(gc_d)[lf] * donor_l[lf]
            - _neg(gc_d)[rf] * donor_r[rf]
        )
        # out of cell i: + through right face, - through left face
        flux_out = (
            flux_out
            + _pos(gc_d)[rf] * donor_l[rf]
            - _neg(gc_d)[lf] * donor_r[lf]
        )

    beta_up = _frac((psi_max - psi) * g_cell, flux_in, dtype)
    beta_dn = _frac((psi - psi_min) * g_cell, flux_out, dtype)

    limited = []
    for d, gc_d in enumerate(gc_corr):
        bu_p = _pad1(beta_up, d, bcs[d])
        bd_p = _pad1(beta_dn, d, bcs[d])
        idx_l = tuple(slice(0, -1) if ax == d else slice(None) for ax in range(ndim))
        idx_r = tuple(slice(1, None) if ax == d else slice(None) for ax in range(ndim))
        bd_donor = bd_p[idx_l]  # donor cell for GC' > 0 is the left cell
        bu_recv = bu_p[idx_r]
        bd_donor_neg = bd_p[idx_r]
        bu_recv_neg = bu_p[idx_l]
        pos = torch.minimum(bd_donor, bu_recv).clamp_max(1.0)
        neg = torch.minimum(bd_donor_neg, bu_recv_neg).clamp_max(1.0)
        limited.append(_pos(gc_d) * pos + _neg(gc_d) * neg)
    return limited


def mpdata_step(
    psi,
    gc,
    g=None,
    *,
    n_iters=2,
    infinite_gauge=False,
    nonoscillatory=False,
    third_order_terms=False,
    bcs=None,
):
    """advance one MPDATA time step; returns the updated cell field.
    ``gc``: tuple of face advector components (G * courant); ``bcs``:
    per-axis 'periodic' (default) or 'extrapolated'."""
    ndim = psi.ndim
    bcs = tuple(bcs) if bcs is not None else (PERIODIC,) * ndim
    if len(gc) != ndim or len(bcs) != ndim:
        raise ValueError("one advector component and one bc per axis")
    psi0 = psi

    with span("EulerianAdvection.upwind"):
        psi_p = _pad_all(psi, bcs)
        div = _flux_divergence(_upwind_fluxes(psi_p, gc), psi.shape)
        psi = psi - (div / g if g is not None else div)

    for _ in range(n_iters - 1):
        with span("EulerianAdvection.antidiffusive"):
            gc_corr = _antidiffusive_gc(
                psi, gc, g, bcs, infinite_gauge,
                third_order_terms=third_order_terms,
            )
            if nonoscillatory:
                with span("EulerianAdvection.fct"):
                    gc_corr = _fct_limit(
                        psi, psi0, gc_corr, g, bcs, infinite_gauge
                    )
            if infinite_gauge:
                fluxes = gc_corr  # donor-cell flux of the constant gauge field
            else:
                fluxes = _upwind_fluxes(_pad_all(psi, bcs), gc_corr)
            div = _flux_divergence(fluxes, psi.shape)
            psi = psi - (div / g if g is not None else div)
            gc = gc_corr
    return psi
