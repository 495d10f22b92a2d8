"""Super-droplet migration between domain slabs (port of
``pysdm_tpu/parallel/migration.py``).

After displacement, particles whose cell left the owning slab are handed
to the ring neighbour (courant < 1 and halo-1 advection allow one slab per
step, so only +-1 exchanges are needed). Fixed-capacity buffers keep every
exchange's size known to both sides in advance; what exceeds them is
counted (the particle dies, its loss in a deficit counter, as the
reference counts breakup overflows).

Each round packs one direction's rows into one buffer per dtype group:
the integer rows (multiplicity, cell origin) as int64 and the float rows
(extensive, max-merged, position in cell) in their own dtype; a slot of
the buffer beyond the shipped count carries multiplicity 0 and so is not
valid. Each group crosses in one ``ring_exchange`` (``halo.py``) that
carries both directions.
"""

import torch

from .halo import ring_exchange


def classify_dest_shift(x, nx_local, multiplicity):
    """destination shift (+-1/0) from a post-displacement x cell origin,
    and a ``far`` mask for moves beyond the ring neighbour: a particle
    landing outside [-nx_local, 2 nx_local) cannot ride a +-1 exchange, and
    callers kill it and count it in ``migration_far_moves``"""
    alive = multiplicity > 0
    far = alive & ((x < -nx_local) | (x >= 2 * nx_local))
    dest = torch.where(
        x < 0, -1, torch.where(x >= nx_local, 1, 0)
    ).to(torch.int32)
    dest = torch.where(alive & ~far, dest, 0)
    return dest, far


def _as_rows(a):
    """the array as a 2D block of rows (a 1D array is one row)"""
    return a.reshape(1, -1) if a.dim() == 1 else a


def _first_of(mask, capacity):
    """indices of the first ``capacity`` slots of ``mask`` in slot order,
    and the count of them (the stable order of the JAX ``argsort(~mask)``
    prefix); entries past the count point at slot 0"""
    rank = torch.cumsum(mask, 0) - 1
    pos = torch.where(mask & (rank < capacity), rank, capacity)
    take = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    take.scatter_(0, pos, torch.arange(mask.shape[0], device=mask.device))
    count = torch.clamp_max(mask.sum(), capacity)
    return take[:capacity], count


def _pack(arrays, multiplicity_index, mask, capacity):
    """up to ``capacity`` masked particles, slot order kept, as one flat
    int64 buffer and one flat float buffer; slots past the count carry
    multiplicity 0"""
    take, count = _first_of(mask, capacity)
    valid = torch.arange(capacity, device=mask.device) < count
    ints, floats = [], []
    for i, a in enumerate(arrays):
        rows = _as_rows(a)[:, take]
        if i == multiplicity_index:
            rows = torch.where(valid, rows, 0)
        if rows.is_floating_point():
            floats.append(rows)
        else:
            ints.append(rows.to(torch.int64))
    return _flat(ints, mask.device), _flat(floats, mask.device)


def _flat(blocks, device):
    """the row blocks as one flat buffer (an empty float64 one for none)"""
    if not blocks:
        return torch.zeros(0, dtype=torch.float64, device=device)
    return torch.cat(blocks).reshape(-1)


def _unpack(arrays, ints, floats, capacity):
    """the buffers of ``_pack`` back to per-array row blocks of
    ``capacity`` columns, in each array's dtype"""
    ints = ints.reshape(-1, capacity)
    floats = floats.reshape(-1, capacity)
    out, i_row, f_row = [], 0, 0
    for a in map(_as_rows, arrays):
        k = a.shape[0]
        if a.is_floating_point():
            out.append(floats[f_row:f_row + k])
            f_row += k
        else:
            out.append(ints[i_row:i_row + k].to(a.dtype))
            i_row += k
    return out


def _place(arrays, free_mask, bufs, valid):
    """scatter the valid buffer entries into free slots (multiplicity-0
    graves), free slots taken in slot order; an entry that finds no free
    slot is dropped and counted. Returns (arrays, n_lost)."""
    n = free_mask.shape[0]
    capacity = valid.shape[0]
    slots, n_free = _first_of(free_mask, capacity)
    slot_ok = valid & (torch.arange(capacity, device=valid.device) < n_free)
    # a column n past the end takes what is dropped
    target = torch.where(slot_ok, slots, n)
    out = []
    for a, b in zip(arrays, bufs):
        rows = _as_rows(a)
        wide = torch.cat([rows, rows.new_zeros(rows.shape[0], 1)], dim=1)
        wide.index_copy_(1, target, b)
        out.append(wide[:, :n].reshape(a.shape))
    n_lost = valid.sum() - slot_ok.sum()
    return out, n_lost


def migrate_ring(
    *, arrays, multiplicity_index, dest_shift, group, capacity, rounds=2
):
    """move particles with dest_shift == +-1 to the ring neighbour.

    ``arrays``: per-particle tensors ((n,) or (k, n)); the one at
    ``multiplicity_index`` is the integer multiplicity that defines
    liveness. Returns (arrays, n_dropped): migrated particles zeroed at the
    source and placed into dead slots at the destination. ``n_dropped`` is
    the int64 pair [send_overflow, placement_overflow]: send overflow wants
    more ``rounds`` or ``capacity``, placement overflow more free slots at
    the receiver. An arrival that finds no free slot is dropped even though
    a later round might free one (the multi-round retry helps senders over
    capacity, not receivers over occupancy).

    Up to ``rounds`` passes, each shipping up to ``capacity`` of the
    remaining departures per direction; only what is still undelivered
    after the last pass dies and is counted."""
    arrays, inflight = migrate_ring_start(
        arrays=arrays, multiplicity_index=multiplicity_index,
        dest_shift=dest_shift, group=group, capacity=capacity,
    )
    return migrate_ring_commit(
        arrays=arrays, inflight=inflight,
        multiplicity_index=multiplicity_index, group=group,
        capacity=capacity, rounds=rounds,
    )


def _send_round(arrays, multiplicity_index, pending, group, capacity,
                async_op=False):
    """pack both directions, issue their exchanges, kill the shipped
    departures at the source. Returns (arrays, pending, exchanges,
    shipped): the exchanges of the int and the float buffers."""
    mult = arrays[multiplicity_index]
    # pack BOTH directions from the pre-placement state (a slot refilled
    # by an arrival must not be shipped again by the other direction),
    # then kill every shipped departure before any placement
    packed = []
    departing = torch.zeros_like(mult, dtype=torch.bool)
    for direction in (1, -1):
        mask = (pending == direction) & (mult > 0)
        # the first `capacity` movers in slot order ship this pass
        shipped = mask & (torch.cumsum(mask, 0) <= capacity)
        packed.append(_pack(arrays, multiplicity_index, shipped, capacity))
        departing = departing | shipped
    (fwd_ints, fwd_floats), (bwd_ints, bwd_floats) = packed
    exchanges = (
        ring_exchange(fwd_ints, bwd_ints, group, async_op=async_op),
        ring_exchange(fwd_floats, bwd_floats, group, async_op=async_op),
    )
    pending = torch.where(departing, 0, pending)
    arrays = [
        torch.where(departing, 0, a) if i == multiplicity_index else a
        for i, a in enumerate(arrays)
    ]
    return arrays, pending, exchanges, departing.sum()


def _place_round(arrays, multiplicity_index, pending, exchanges, capacity):
    """place what ``_send_round``'s exchanges brought: first the left
    neighbour's forward movers, then the right neighbour's backward ones"""
    ints, floats = (x.wait() for x in exchanges)
    n_dropped_place = torch.zeros((), dtype=torch.int64, device=pending.device)
    for side in (0, 1):
        bufs = _unpack(arrays, ints[side], floats[side], capacity)
        valid = bufs[multiplicity_index][0] > 0
        free = arrays[multiplicity_index] <= 0
        placed, n_lost = _place(
            arrays + [pending], free,
            bufs + [pending.new_zeros(1, capacity)], valid,
        )
        arrays, pending = placed[:-1], placed[-1]
        n_dropped_place = n_dropped_place + n_lost
    return arrays, pending, n_dropped_place


def migrate_ring_start(
    *, arrays, multiplicity_index, dest_shift, group, capacity
):
    """the first send round, for overlap with compute: pack the departures,
    kill them at the source and issue the exchanges with ``async_op``;
    return them in flight, placed nothing. The caller runs cell-local
    compute (collision) meanwhile; ``migrate_ring_commit`` waits for the
    exchanges, places the arrivals and runs any further rounds. Against the
    inline ``migrate_ring``: a migrating particle skips the collision step
    of its transit, resident in neither slab while in flight (one-step
    staleness, as the reference's asynchronous MPDATA thread,
    ``examples/.../mpdata_2d.py:106-116``). ``inflight["shipped"]`` is the
    count of particles in flight."""
    pending = dest_shift.to(torch.int32)
    arrays, pending, exchanges, shipped = _send_round(
        arrays, multiplicity_index, pending, group, capacity, async_op=True
    )
    return arrays, {
        "pending": pending, "exchanges": exchanges, "shipped": shipped
    }


def migrate_ring_commit(
    *, arrays, inflight, multiplicity_index, group, capacity, rounds=2
):
    """place the arrivals of ``migrate_ring_start`` and run the remaining
    ``rounds - 1`` rounds; kill and count what is left undelivered.
    Returns (arrays, [send_drop, place_drop])."""
    arrays, pending, n_dropped_place = _place_round(
        arrays, multiplicity_index, inflight["pending"],
        inflight["exchanges"], capacity,
    )
    for _ in range(rounds - 1):
        arrays, pending, exchanges, _ = _send_round(
            arrays, multiplicity_index, pending, group, capacity
        )
        arrays, pending, lost = _place_round(
            arrays, multiplicity_index, pending, exchanges, capacity
        )
        n_dropped_place = n_dropped_place + lost

    # undeliverable leftovers (send-capacity overflow): kill and count
    mult = arrays[multiplicity_index]
    leftover = (pending != 0) & (mult > 0)
    n_dropped_send = leftover.sum()
    arrays = [
        torch.where(leftover, 0, a) if i == multiplicity_index else a
        for i, a in enumerate(arrays)
    ]
    return arrays, torch.stack([n_dropped_send, n_dropped_place])
