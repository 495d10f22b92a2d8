"""How far the decomposed warm rain drifts from one rank, step by step, on
the card.

Config #5 at full width (25 x 25 x 2^12 super-droplets from a haze start,
seed 44, collisions off) runs on one rank twice (NCCL) and on ``--ranks``
x-slabs (NCCL with a card a rank, else gloo with CUDA tensors on one
card); after each of ``--steps`` the canonical particle rows and the
global thd, qv and RH of each run are compared: the second one-rank run
and the decomposed run against the first. Printed per step: quantiles of
the position and water-mass differences, the rows beyond 1e-3 relative
in mass, the largest positions apart at slab edges and inside, the
worst rows, and the fields' largest relative differences.

    python tools/decomposition_drift.py [--ranks 5] [--steps 1,3,10]
"""

import argparse
import concurrent.futures
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUANTILES = (0.5, 0.99, 0.999, 0.9999, 1.0)


def rows_at(settings_factory, checkpoints):
    """inside a rank: the canonical rows and fields at each checkpoint,
    on rank 0"""
    import torch.distributed as dist

    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.parallel import DistributedSimulation2D
    from pysdm_tpu_torch.parallel.verification import (
        FIELDS,
        _global_field,
        canonical_particles,
    )

    settings = settings_factory()
    sim = DistributedSimulation2D(settings, backend_class=GPU)
    sim.particulator.set_flag("collision_enable", False)
    out, done = {}, 0
    for n in checkpoints:
        sim.run(n - done)
        done = n
        rows = canonical_particles(sim, settings)
        fields = {f: _global_field(sim, settings, f) for f in FIELDS}
        if dist.get_rank() == 0:
            out[n] = (rows, fields)
    return out


def compare(label, got, ref, slab):
    for n, (rows, fields) in got.items():
        ref_rows, ref_fields = ref[n]
        if not (np.array_equal(rows[:, 0], ref_rows[:, 0])
                and np.array_equal(rows[:, 4], ref_rows[:, 4])):
            raise AssertionError(f"{label} step {n}: identities differ")
        dpos = np.abs(rows[:, 1:3] - ref_rows[:, 1:3]).max(axis=1)
        dm = np.abs(rows[:, 3] - ref_rows[:, 3])
        rel = dm / np.maximum(np.abs(ref_rows[:, 3]), 1e-30)
        x = ref_rows[:, 1]
        edge = np.abs(x - np.round(x / slab) * slab) < 1.0

        def q(v):
            return [float(np.quantile(v, p)) for p in QUANTILES]

        print(f"{label} step {n}: position quantiles {QUANTILES} {q(dpos)}"
              f" (slab edges {float(dpos[edge].max())!r}, inside"
              f" {float(dpos[~edge].max())!r}); water mass {q(dm)} kg;"
              f" relative {q(rel)}, {int((rel > 1e-3).sum())} rows beyond"
              f" 1e-3; worst mass row {ref_rows[np.argmax(dm)].tolist()} ->"
              f" {rows[np.argmax(dm)].tolist()}; fields"
              f" {[float(np.max(np.abs(fields[f] - ref_fields[f]) / np.abs(ref_fields[f]))) for f in ref_fields]}",
              flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=5)
    parser.add_argument("--steps", default="1,3,10")
    args = parser.parse_args()
    steps = tuple(int(s) for s in args.steps.split(","))

    from pysdm_tpu_torch.ops.cuda import collision, condensation, scan
    from pysdm_tpu_torch.parallel import multihost
    from pysdm_tpu_torch.parallel.verification import warm_rain_settings

    with concurrent.futures.ThreadPoolExecutor() as pool:
        loaders = (condensation.library, scan.library, collision.library_adjacent)
        for future in [pool.submit(load) for load in loaders]:
            future.result()
    settings = functools.partial(
        warm_rain_settings, seed=44, grid=(25, 25), n_sd_per_gridbox=2**12
    )
    backend = multihost.backend_for(args.ranks, "cuda")
    print(f"{args.ranks} ranks over {backend}; one rank over"
          f" {multihost.backend_for(1, 'cuda')}", flush=True)
    runs = [
        multihost.spawn(rows_at, n, settings, steps, timeout=600,
                        backend=multihost.backend_for(n, "cuda"))[0]
        for n in (1, 1, args.ranks)
    ]
    compare("one rank again", runs[1], runs[0], 25 // args.ranks)
    compare(f"{args.ranks} ranks", runs[2], runs[0], 25 // args.ranks)


if __name__ == "__main__":
    main()
