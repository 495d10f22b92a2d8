"""The card's peaks and the bytes each kernel needs, from shapes.

A frozen copy of ``chip_smoke.py``'s yardstick (``HBM_BYTES_PER_S``,
``bound_ms`` and the byte models beside its calls): each input byte read
once, each output byte written once, for the work these inputs need.

- K1 (``coalesce_mirror_kernel``, one mirror substep): per slot the
  multiplicity read and written (8 + 8), each float32 extensive row read and
  written (4 + 4), each float32 attribute row the collision kernel reads
  (4); 36 B with Golovin's one row and two extensive rows.
- K2 (``coalesce_adjacent_kernel``, one sort-croupier substep): per slot the
  multiplicity (8 + 8), each float32 extensive row (4 + 4), kernel x norm
  (4), the u01 draw (4), ``is_first`` (1), the rate and deficit rows out
  (8); 57 B with three extensive rows.
- K3 (``masses_new_kernel``, one solve): 24 B in, 5 B out per drop, 29 B.
"""

# NVIDIA H100 SXM data sheet, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(n, extensive_rows, attribute_rows):
    return n * (16 + 8 * extensive_rows + 4 * attribute_rows)


def k2_bytes(n, extensive_rows):
    return n * (8 + 4 * extensive_rows + 4 + 4 + 1 + 8 + 4 * extensive_rows + 8)


def k3_bytes(n):
    return n * 29


def bound_s(n_bytes):
    """the least time on the card to move ``n_bytes``. K1 and K2 are bound
    by their bytes; K3's operations grow with each drop's root-search
    iterations, which no counter reports yet, so its share is taken
    against the bytes alone and may read low where the operations bind"""
    return n_bytes / HBM_BYTES_PER_S


def roofline_pct(trace, pattern, bytes_per_launch):
    """100 x the least time of the launches of the kernels named like
    ``pattern`` over their measured time; None where none ran"""
    launches = trace.kernels(pattern)
    if not launches:
        return None
    measured_s = sum(op.dur_us for op in launches) * 1e-6
    return 100.0 * len(launches) * bound_s(bytes_per_launch) / measured_s
