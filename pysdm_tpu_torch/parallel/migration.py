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

With overlap (``migrate_ring_start`` / ``migrate_ring_commit``) the first
round's exchange flies while the cell-local physics (collision) runs, and
every mover is out of the slab from start to commit. The movers the first
round could not ship (past ``capacity`` in slot order: the leftovers)
leave too: the start copies their rows, slots and directions into a stash
in ``inflight`` and gives their slots multiplicity 0, so that collision
and its sort see graves there. The commit puts the stash back before it
places the first arrivals, each leftover into its recorded slot where that
is still a grave, else into the first graves in slot order (one that finds
none is a place drop), and its later rounds ship the stash in the start's
slot order, ``capacity`` a round and direction; what is left after
``rounds`` rounds dies as a send drop. The recorded slot is a preference
only, so nothing the commit reads is indexed by slots the sort can
permute; with nothing between start and commit every recorded slot is
still a grave, and the pair is ``migrate_ring`` slot for slot. (The JAX
package keeps the leftovers resident under a per-slot pending flag, which
a sort between start and commit leaves stale.)
"""

import torch

from .halo import ring_exchange

# the order in which a round packs the directions
DIRECTIONS = (1, -1)


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


def _first_of(mask, capacity, values=None):
    """the first ``capacity`` entries of ``values`` (default: the indices)
    where ``mask`` holds, in order, and the count of them (the stable order
    of the JAX ``argsort(~mask)`` prefix); entries past the count are 0"""
    if values is None:
        values = torch.arange(mask.shape[0], device=mask.device)
    rank = torch.cumsum(mask, 0) - 1
    pos = torch.where(mask & (rank < capacity), rank, capacity)
    take = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    take.scatter_(0, pos, values)
    count = torch.clamp_max(mask.sum(), capacity)
    return take[:capacity], count


def _mask_of(index, n):
    """the length-``n`` mask of the slots in ``index`` (entries equal to
    ``n`` mark nothing)"""
    mask = torch.zeros(n + 1, dtype=torch.bool, device=index.device)
    mask[index] = True
    return mask[:n]


def _killed(arrays, multiplicity_index, mask):
    """``arrays`` with multiplicity 0 where ``mask`` holds"""
    return [
        torch.where(mask, 0, a) if i == multiplicity_index else a
        for i, a in enumerate(arrays)
    ]


def _pack(arrays, multiplicity_index, take, valid):
    """the slots ``take`` as one flat int64 buffer and one flat float
    buffer; entries not ``valid`` carry multiplicity 0"""
    ints, floats = [], []
    for i, a in enumerate(arrays):
        rows = _as_rows(a)[:, take]
        if i == multiplicity_index:
            rows = torch.where(valid, rows, 0)
        if rows.is_floating_point():
            floats.append(rows)
        else:
            ints.append(rows.to(torch.int64))
    return _flat(ints, take.device), _flat(floats, take.device)


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


def _scatter(arrays, target, bufs):
    """write the columns of ``bufs`` into slots ``target`` (a column
    ``n`` past the end takes those whose target is ``n``)"""
    out = []
    for a, b in zip(arrays, bufs):
        rows = _as_rows(a)
        wide = torch.cat([rows, rows.new_zeros(rows.shape[0], 1)], dim=1)
        wide.index_copy_(1, target, b)
        out.append(wide[:, :rows.shape[1]].reshape(a.shape))
    return out


def _place(arrays, free_mask, bufs, valid):
    """scatter the valid buffer entries into free slots (multiplicity-0
    graves), free slots taken in slot order; an entry that finds no free
    slot is dropped and counted. Returns (arrays, n_lost)."""
    n = free_mask.shape[0]
    capacity = valid.shape[0]
    slots, n_free = _first_of(free_mask, capacity)
    slot_ok = valid & (torch.arange(capacity, device=valid.device) < n_free)
    target = torch.where(slot_ok, slots, n)
    n_lost = valid.sum() - slot_ok.sum()
    return _scatter(arrays, target, bufs), n_lost


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


def _send_round(arrays, multiplicity_index, takes, group, capacity,
                async_op=False):
    """pack each direction's ``takes`` (slots and count, of
    ``_first_of``), issue their exchanges, kill the shipped slots at the
    source. Returns (arrays, exchanges, departing): the exchanges of the
    int and the float buffers, and the mask of the shipped slots."""
    n = arrays[multiplicity_index].shape[0]
    # pack BOTH directions from the pre-placement state (a slot refilled
    # by an arrival must not be shipped again by the other direction),
    # then kill every shipped departure before any placement
    packed, shipped = [], []
    for take, count in takes:
        valid = torch.arange(capacity, device=take.device) < count
        packed.append(_pack(arrays, multiplicity_index, take, valid))
        shipped.append(torch.where(valid, take, n))
    (fwd_ints, fwd_floats), (bwd_ints, bwd_floats) = packed
    exchanges = (
        ring_exchange(fwd_ints, bwd_ints, group, async_op=async_op),
        ring_exchange(fwd_floats, bwd_floats, group, async_op=async_op),
    )
    departing = _mask_of(torch.cat(shipped), n)
    return (
        _killed(arrays, multiplicity_index, departing), exchanges, departing
    )


def _place_round(arrays, multiplicity_index, exchanges, capacity):
    """place what ``_send_round``'s exchanges brought: first the left
    neighbour's forward movers, then the right neighbour's backward ones.
    Returns (arrays, n_lost)."""
    ints, floats = (x.wait() for x in exchanges)
    n_dropped_place = torch.zeros(
        (), dtype=torch.int64, device=arrays[multiplicity_index].device
    )
    for side in (0, 1):
        bufs = _unpack(arrays, ints[side], floats[side], capacity)
        valid = bufs[multiplicity_index][0] > 0
        free = arrays[multiplicity_index] <= 0
        arrays, n_lost = _place(arrays, free, bufs, valid)
        n_dropped_place = n_dropped_place + n_lost
    return arrays, n_dropped_place


def migrate_ring_start(
    *, arrays, multiplicity_index, dest_shift, group, capacity
):
    """the first send round, for overlap with compute: pack the departures,
    kill them at the source and issue the exchanges with ``async_op``;
    stash the leftovers and kill them too (module docstring); place
    nothing. The caller runs cell-local compute (collision) meanwhile;
    ``migrate_ring_commit`` waits for the exchanges, places the arrivals
    and runs any further rounds. Against the inline ``migrate_ring``: a
    migrating particle skips the collision step of its transit, resident
    in neither slab meanwhile (one-step staleness, as the reference's
    asynchronous MPDATA thread, ``examples/.../mpdata_2d.py:106-116``).
    ``inflight["shipped"]`` and ``inflight["stashed"]`` are the counts of
    particles in flight and of leftovers in the stash."""
    mult = arrays[multiplicity_index]
    movers = [(dest_shift == d) & (mult > 0) for d in DIRECTIONS]
    # the first `capacity` movers in slot order ship this pass
    arrays, exchanges, departing = _send_round(
        arrays, multiplicity_index,
        [_first_of(mask, capacity) for mask in movers],
        group, capacity, async_op=True,
    )
    left = (movers[0] | movers[1]) & ~departing
    slots = torch.nonzero(left).reshape(-1)
    stash = {
        "slots": slots,
        "direction": dest_shift[slots],
        "rows": [_as_rows(a)[:, slots] for a in arrays],
    }
    arrays = _killed(arrays, multiplicity_index, left)
    return arrays, {
        "exchanges": exchanges, "stash": stash,
        "shipped": departing.sum(), "stashed": slots.shape[0],
    }


def _restore(arrays, multiplicity_index, stash):
    """the stash back into graves: each leftover into its recorded slot
    where that is a grave, the rest into the first other graves in slot
    order. Returns (arrays, target): each leftover's slot, ``n`` for one
    that found no grave."""
    slots = stash["slots"]
    n = arrays[multiplicity_index].shape[0]
    free = arrays[multiplicity_index] <= 0
    home = free[slots]
    spare = free & ~_mask_of(torch.where(home, slots, n), n)
    graves, n_graves = _first_of(spare, slots.shape[0])
    away = torch.cumsum(~home, 0) - 1
    target = torch.where(
        home, slots,
        torch.where(away < n_graves, graves[away.clamp_min(0)], n),
    )
    return _scatter(arrays, target, stash["rows"]), target


def migrate_ring_commit(
    *, arrays, inflight, multiplicity_index, group, capacity, rounds=2
):
    """put back the stash of ``migrate_ring_start``, place its arrivals
    and run the remaining ``rounds - 1`` rounds on the stash; kill and
    count what is left undelivered. Returns (arrays, [send_drop,
    place_drop])."""
    stash = inflight["stash"]
    arrays, target = _restore(arrays, multiplicity_index, stash)
    n = arrays[multiplicity_index].shape[0]
    restored = target < n
    arrays, n_dropped_place = _place_round(
        arrays, multiplicity_index, inflight["exchanges"], capacity
    )
    n_dropped_place = n_dropped_place + (~restored).sum()
    # each direction's queue: its leftovers in the start's slot order
    queues = [(stash["direction"] == d) & restored for d in DIRECTIONS]
    ranks = [torch.cumsum(q, 0) - 1 for q in queues]
    for r in range(rounds - 1):
        arrays, exchanges, _ = _send_round(
            arrays, multiplicity_index,
            [_first_of(q & (k >= r * capacity), capacity, target)
             for q, k in zip(queues, ranks)],
            group, capacity,
        )
        arrays, lost = _place_round(
            arrays, multiplicity_index, exchanges, capacity
        )
        n_dropped_place = n_dropped_place + lost

    # undeliverable leftovers (send-capacity overflow): kill and count
    over = torch.zeros_like(restored)
    for q, k in zip(queues, ranks):
        over = over | (q & (k >= (rounds - 1) * capacity))
    arrays = _killed(
        arrays, multiplicity_index, _mask_of(torch.where(over, target, n), n)
    )
    return arrays, torch.stack([over.sum(), n_dropped_place])
