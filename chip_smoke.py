"""Smoke run of the PyTorch/CUDA port (``pysdm_tpu_torch``) on one NVIDIA GPU.

Run from the root of the checkout: ``python3 chip_smoke.py``. Phases:

0. environment: the card's name and power limit (nvidia-smi), torch, CUDA,
   nvcc, whether triton imports;
1. build of every CUDA kernel from ``pysdm_tpu_torch/csrc``, one nvcc per
   source, all started together;
2. K1 (mirror coalescence) against its plain PyTorch twin on the card, on
   random states with dead slots, ties and multiplicities up to 2^40, at 2^16
   and 2^20 slots: multiplicities exactly, extensive rows to rtol 1e-6
   (float32) or 1e-12 (float64), rate sums to rtol 1e-5; three launches on
   the same inputs bit-equal, rate sums included, and launches on two
   inputs queued on two streams at once bit-equal to the launches alone;
   then the device time of kernel and twin at 2^20 (CUDA events), the
   kernel's on one input (which stays in the L2) and over a rotation of
   four inputs (which does not);
3. the box path: ``bench.py``'s box (Golovin b = 1.5e3, 2^20 super-droplets,
   dv = 1e6 m^3, dt = 1 s, non-adaptive) on the ``GPU`` backend, run(1) as
   warm-up, then run(100) timed; launch counts are reset just before and
   read just after, and K1 must have launched once per substep; the same
   step is then timed with the plain twin in the kernel's place (timing
   only), and a 2^16 box is run through kernel and twin and compared;
4. the adaptive box: 5 steps at dt = 10 s, launches == substeps;
5. K3 (the per-drop condensation solve) against its twin on the card at 2^17
   and 2^20 drops in five cells (supersaturated growing drops, haze settled
   at its float32 equilibrium, an inactive cell, dead and zero-mass drops,
   a non-finite root): success equal drop for drop, log-mass within
   2 rtol_x |x_old| + 2e-5 (see ``compare_k3``); the same drops in a random
   order (blocks whose threads compute their own cell's state) bit-equal
   to the sorted ones and within the same bound of the twin; then the
   device time of
   kernel and twin at both sizes, the kernel's time on three uniform sets
   of rows (every drop growing, every drop haze at equilibrium, every cell
   inactive), and the minfun evaluations the rows need beside what plain
   halving would need;
6. the parcel path: ``bench.py``'s parcel (BASELINE config #3: 2^17
   super-droplets, adaptive, w = 2 m/s) on the ``GPU`` backend, run(1) as
   warm-up, then run(100) timed with K3's count reset just before and read
   just after: it must equal the per-drop solves the solver counted, fake
   and real. The run goes on to 1000 steps (2 km of ascent) and checks
   success, 1.0005 < RH_max < 1.05, liquid water above 1e-4 kg/kg, a mean
   radius between 5 and 50 um and qv plus liquid conserved; then 10 more
   steps through K3 and 10 with the twin in its place (timing only);
7. the parcel on the card (float32, K3) against the port's CPU float64
   backend, 64 drops, 50 steps, adaptive and not: water masses to rtol 2e-3
   and qv to rtol 1e-4. From qv0 = 0.0158 the parcel stays subsaturated in
   50 steps (the haze grows); a third, non-adaptive case starts from qv0 =
   0.0225 and activates the drops within the 50 steps;
8. K4 (the prefix sum) against torch.cumsum and float64 sums at 2^20, at
   the warm rain's 2.56 M, at 2.56 M + 12345, below one tile and at n = 1:
   integers exactly, float32 within 1e-5 of the float64 prefix and three
   runs bit-equal; the rows of a (4, n) call bit-equal to their 1D scans;
   two scans queued on two streams at once bit-equal to the scans alone;
   then the device time of the kernel, of a (4, n) call and of
   torch.cumsum, on one input (which stays in the L2) and over a rotation
   of eight inputs (which does not);
9. K2 (sort-croupier coalescence) against its twin at 2.56 M slots;
10. the warm rain (config #5, 25 x 25 cells x 2^12 super-droplets) through
   ``make_simulation`` on the card, 30 steps after one, with K2, K3 and K4
   launches (and K4's rows) counted; the per-cell float32 sums against
   float64; then one more step whose first condensation solve is captured:
   on that solve's inputs (2.56 M drops sorted into 625 cells) K3 on the
   shuffled drops bit-equal to the sorted ones and K3 against its twin
   (``compare_k3_near_saturation``), its time and its minfun evaluations;
11. ``tests/smoke/test_kinematic_2d.py``'s 8x8 scenario on the card, and a
   float32 card spin-up against the CPU float64 one;
12. the warm-rain step with K2's and K4's twins in their places (timing);
13. K5 (collision with breakup) against its twin on the card at 2^17 and
   2^20, with config #2's functions and with a set that bounces and
   coalesces too (``compare_k5`` states the bounds); then the device time
   of kernel and twin; determinism as in phase 2; the kernel's time over a
   rotation of 16 random states at 2^17 (device memory); then K5 on 16
   substeps captured from config #2's main path (phase 14's recipe, one
   warm-up step): against the twin and timed, on the first state and over
   the rotation of all 16;
14. config #2, the de Jong/Mackay 2023 breakup box, through ``bench.py``'s
   recipe (2^17 super-droplets, adaptive, dt = 1 s) on the ``GPU``
   backend, run(1) as warm-up, then run(100) timed with K5's count reset
   just before and read just after: it must equal the collision substeps;
   water mass to 1e-5 (the bench's assert), multiplicities >= 0,
   coalescence and breakup rates > 0; then 10 steps through K5 and 10 with
   its twin in its place (timing only);
15. config #2 through its model entry point, ``run_box_breakup`` on the
   card at 2^17: finite spectra, each read twice bit-equal (deterministic
   sums), the liquid under dv/dlnr conserved, rates;
16. config #4, the Shipway and Hill 2012 1D column, through ``Simulation``
   on the card at the JAX model's defaults (dz = 25 m, dt = 1 s, 145 cells)
   with 2^12 super-droplets per cell (593,920): run(1) as warm-up, then
   run(100) timed below cloud; on to t = 400 s, where it must have formed
   its cloud (max qc > 0.05 g/kg, at least 10 cells above 1e-5 kg/kg, peak
   supersaturation > 0, ``condensation_success``, multiplicities >= 0),
   every product of the default ``Simulation`` read twice on that state
   (bit-equal, but for the two that reset their counter on read); one more
   step whose first K2 substep, first K3 solve and first K4 scan of each
   dtype and rank are captured, and each kernel held against its twin on
   those inputs at the bounds of phases 9, 10 and 8 (``_column_kernels_vs_
   twins``); the water budget over 30 steps, precipitation included, to
   5%; then run(50)
   timed in cloud. Around each timed window the launches of K2, K3 and K4
   (and K4's rows) are set to 0 and read: K2's must equal the collision
   substeps, K3's the condensation solves;
17. the published-profile scenario of ``tests/smoke/test_kinematic_1d.py``
   (128 super-droplets per cell, dt = 30 s, dz = 60 m, 50 steps, seed 44)
   on the card in float32, with that test's statistics and bounds;
18. K1 with the geometric kernels (``Geometric`` and ``SimpleGeometric``,
   two attribute rows) against its twin on the card at 2^16 and 2^20 on
   random states as in phase 2 (the same bounds), determinism as there,
   and Geometric's device time at 2^20 on one input and rotated;
19. ``shima_et_al_2009.run`` (config #1's physics) at 2^20 on the card:
   3600 steps, dv/dlnr against the Golovin solution at t = 1200 s (rmse
   under the JAX test's 0.15), the mass under the spectrum to 5e-2 and the
   liquid to 1e-6, K1 launches = substeps, ``WallTime`` positive and
   within the host clock around the call; then ``dejong_azimi.run_box`` and
   ``bartman_2020_fig_4`` at their defaults on the card with the JAX
   tests' bounds (``_box_model_entry_points``);
20. ``berry_1967.run`` at 2^20 on the card (Geometric on K1, Gunn-Kinzer
   fall velocities): the mean radius grows, liquid to 1e-6, K1 launches =
   substeps; one more substep captured and K1 held against its twin on it;
21. ``bulenok_2023_benchmark`` at 2^17 and 2^20, 64 steps, on the card
   (K5): pair-updates/s, the final mean mass within ``BULENOK_FACTOR`` of
   eq. 13, multiplicities >= 0, K5 launches = substeps; K5 held against
   its twin (``compare_k5``) on a substep captured from the 2^20 run;
22. de Jong and Azimi's ``Settings1D`` (the column without condensation,
   Golovin b = 5e3, 145 cells x 2^12) through the column's ``Simulation``
   on the card, 300 steps: K2 launches = collision substeps, K4 launched,
   a coalescence rate > 0, liquid conserved to 1e-5 with the
   precipitation counted; every liquid-phase product that applies to such
   a column read twice, bit-equal but for those that reset on read; then
   K2 and K4 held against their twins on a captured substep and scan
   (``_column_kernels_vs_twins``).

Every box phase checks multiplicities >= 0, water mass conserved to 1e-6 and
coalescence having happened. Any failure raises, and the script exits
non-zero; without a CUDA device, or without the package beside it, it exits
non-zero before printing any result. The last two lines are one JSON object
of the kernels (K2's, K3's and K4's with their launches in the column's two
timed windows, ``column_launches``, beside those of their main path, and
their largest differences to their twins on the column's inputs,
``column_max_abs_err``; K2's and K4's launches in phase 22,
``dejong_column_launches``; K1's Geometric time, bound and difference to
its twin from phase 18 and its launches in phase 20, ``berry_launches``;
K5's in phase 21, ``bulenok_launches``) and one of the device.
"""

import concurrent.futures
import contextlib
import json
import subprocess
import sys
import time

N_MAIN = 2**20
N_STEPS = 100
N_PARCEL = 2**17
PARCEL_STEPS = 1000
# K3's DropSolveSettings on the parcel path: Condensation's defaults
K3_SETTINGS = (1e-6, 1e-7, 16, 64)
K3_ARGS = (
    "water_mass", "vdry", "kappa", "multiplicity", "cell_id", "thd", "qv",
    "rhod", "dt_sub", "active", "rho_air", "mu_air",
)


def gpu_line():
    """the card's name and power limit as nvidia-smi reports them"""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _nvcc_version(nvcc):
    out = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout
    return out.strip().splitlines()[-1]


def _random_state(torch, n, K, ext_dtype, seed, device):
    """multiplicities up to 2^40 with 5% dead slots and 5% ties with the
    partner (K - o) mod n; two extensive rows; float32 volumes"""
    import numpy as np

    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, size=(2, n)).astype(ext_dtype)
    volume = rng.uniform(1e-15, 1e-12, size=n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (mult, ext, volume)]


def _time_ms(torch, fn, reps):
    """device milliseconds per call: CUDA events around ``reps`` calls queued
    behind a device-side sleep, so that the host's enqueue time (wrapper,
    allocation, launch) is hidden and the events see only device work"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s at ~2 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k1_args(torch, n, ext_dtype, seed, device):
    """K1's arguments on a random state (``_random_state``), Golovin (its
    one attribute row, the volume), a scale that changes 5-95% of the
    slots"""
    from pysdm_tpu_torch.ops.cuda.collision import GOLOVIN

    K = (n // 3) * 2
    mult, ext, volume = _random_state(torch, n, K, ext_dtype, seed, device)
    scale = torch.tensor([2e-3], dtype=torch.float32, device=device)
    # the collision kernel's attribute rows: Golovin reads the volume
    attr = volume[None, :].contiguous()
    return (mult, ext, attr, GOLOVIN, (1.5e3, 0.0), scale, K, 3141592653)


def check_deterministic(torch, fn, inputs, label):
    """three calls of ``fn`` on the same inputs bit-equal in every output,
    rate sums included; calls on two inputs queued on two streams at once
    (each stream has its own scratch) bit-equal to the calls alone"""
    runs = [fn(*inputs[0]) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        if not all(torch.equal(a, b) for a, b in zip(runs[0], run)):
            raise AssertionError(f"{label}: three runs differ")
    alone = [runs[0], fn(*inputs[1])]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in alone]
    together = []
    for _ in range(10):
        for args, stream in zip(inputs, streams):
            with torch.cuda.stream(stream):
                together.append(fn(*args))
    torch.cuda.synchronize()
    for k, got in enumerate(together):
        if not all(torch.equal(a, b) for a, b in zip(got, alone[k % 2])):
            raise AssertionError(f"{label}: calls on two streams differ")
    print(f"{label}: three runs bit-equal, rate sums included; 10 pairs of"
          f" calls queued on two streams bit-equal to the calls alone")


def _kernel_vs_twin(torch, kern, device, gpu):
    """phase 2; returns (max_abs_err, kernel_ms, twin_ms) at N_MAIN"""
    import numpy as np

    max_abs_err = 0.0
    for n, ext_dtype in ((2**16, np.float32), (2**16, np.float64),
                         (N_MAIN, np.float32)):
        args = k1_args(torch, n, ext_dtype, n, device)
        mult = args[0]
        before = kern.coalesce_mirror.launches
        got = kern.coalesce_mirror(*args)
        torch.cuda.synchronize()
        if kern.coalesce_mirror.launches != before + 1:
            raise AssertionError("launch counter did not count the launch")
        want = kern.coalesce_mirror_reference(*args)
        got = [x.cpu().numpy() for x in got]
        want = [x.cpu().numpy() for x in want]
        np.testing.assert_array_equal(got[0], want[0])
        changed = float((got[0] != mult.cpu().numpy()).mean())
        if not 0.05 < changed < 0.95:
            raise AssertionError(f"update touched {changed} of the slots")
        rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got[1], want[1], rtol=rtol)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, rtol=1e-5)
        err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
        if n == N_MAIN:
            max_abs_err = err
        print(f"phase 2: n={n} ext={np.dtype(ext_dtype).name}: xi equal,"
              f" ext max abs err {err!r}, rates {got[2:]} vs {want[2:]}")
    # four inputs of 37 MB each (mult, two float32 rows, volume in; mult
    # and rows out), together past the 50 MB L2
    inputs = [args] + [
        k1_args(torch, N_MAIN, ext_dtype, seed, device) for seed in (1, 2, 3)
    ]
    check_deterministic(torch, kern.coalesce_mirror, inputs[:2], "phase 2: K1")
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_mirror(*args), 200)
    twin_ms = _time_ms(torch, lambda: kern.coalesce_mirror_reference(*args), 10)
    rotated_ms = _time_rotated_ms(
        torch, lambda a: kern.coalesce_mirror(*a), inputs, 200
    )
    print(f"phase 2: n={N_MAIN} kernel {kernel_ms!r} ms on one input (in the"
          f" L2), {rotated_ms!r} ms over a rotation of {len(inputs)} inputs"
          f" (device memory), plain twin {twin_ms!r} ms per substep [{gpu}]")
    return max_abs_err, kernel_ms, twin_ms


def k2_state(n, n_cell, n_ext, ext_dtype, seed):
    """K2's inputs over a cell-sorted state, as numpy rows: n slots in
    n_cell cells of random sizes, 5% dead slots in the trailing bucket,
    multiplicities up to 2^40 with 5% of the pairs tied, kernel-times-norm
    values spread so that the pairs see gamma = 0, gamma capped by
    xi_j / xi_k and exhaustion splits. Returns (mult, ext, kernnorm, rand,
    is_first, cell)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dead = n // 20
    cell = np.concatenate([
        np.sort(rng.integers(0, n_cell, n - n_dead)), np.full(n_dead, n_cell)
    ])
    start = np.searchsorted(cell, np.arange(n_cell + 1))
    offset = np.arange(n) - start[cell]
    same_as_next = np.append(cell[1:] == cell[:-1], False)
    is_first = same_as_next & (offset % 2 == 0) & (cell < n_cell)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    mult[n - n_dead:] = 0
    leaders = np.flatnonzero(is_first)
    tied = leaders[rng.uniform(size=leaders.size) < 0.05]
    mult[tied + 1] = mult[tied]
    ext = rng.uniform(1e-12, 1e-9, size=(n_ext, n)).astype(ext_dtype)
    kernnorm = (
        rng.lognormal(0.0, 2.0, n) / np.median(mult[: n - n_dead])
    ).astype(np.float32)
    rand = rng.uniform(size=n).astype(np.float32)
    return mult, ext, kernnorm, rand, is_first, cell


def build_box(n_sd, dt, adaptive):
    """``bench.py``'s box (Golovin b = 1.5e3, dv = 1e6 m^3, exponential
    spectrum) on the port's ``GPU`` backend"""
    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics import Coalescence
    from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.initialisation.spectra import Exponential
    from pysdm_tpu_torch.physics import si

    formulae = Formulae(seed=44)
    builder = Builder(
        n_sd=n_sd, backend=GPU(formulae),
        environment=Box(dv=1e6 * si.m**3, dt=dt * si.s),
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=adaptive)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
    ).sample(n_sd)
    return builder.build(attributes)


def _totals(p):
    """(water mass, droplet count) after checking the state's shape, signs
    and finiteness"""
    import numpy as np

    mult = p.attributes["multiplicity"]
    mass = p.attributes["water mass"]
    if mult.shape != (p.n_sd,) or mass.shape != (p.n_sd,):
        raise AssertionError(f"state shapes {mult.shape}, {mass.shape}")
    if (mult < 0).any():
        raise AssertionError("negative multiplicity")
    if not np.isfinite(mass).all():
        raise AssertionError("non-finite water mass")
    return float((mult * mass).sum()), float(mult.sum())


def _check_conserved(label, before, after):
    (mass0, count0), (mass1, count1) = before, after
    if abs(mass1 - mass0) > 1e-6 * mass0:
        raise AssertionError(f"{label}: water mass {mass0} -> {mass1}")
    if not count1 < count0:
        raise AssertionError(f"{label}: no coalescence ({count0} -> {count1})")


@contextlib.contextmanager
def _replaced(module, name, value):
    """``module.name`` set to ``value`` inside the block: a kernel's wrapper
    replaced by its plain twin where the path calls it (for timing and
    comparison only)"""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _k1_twin_in_place():
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops.cuda.collision import coalesce_mirror_reference

    return _replaced(collision, "coalesce_mirror", coalesce_mirror_reference)


def _main_path(torch, kern, gpu):
    """phase 3; returns the main path's launch count"""
    import numpy as np

    p = build_box(N_MAIN, 1.0, adaptive=False)
    before = _totals(p)
    p.run(1)
    p.block_until_ready()
    kern.coalesce_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(N_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = kern.coalesce_mirror.launches
    if launches != N_STEPS:
        raise AssertionError(f"{launches} kernel launches for {N_STEPS} substeps")
    _check_conserved("phase 3", before, _totals(p))
    ms_step = elapsed / N_STEPS * 1e3
    print(f"phase 3: box n_sd={N_MAIN} non-adaptive:"
          f" {N_MAIN / 2 * N_STEPS / elapsed!r}"
          f" pair-updates/s, {ms_step!r} ms/step, {launches} launches [{gpu}]")

    with _k1_twin_in_place():
        n_plain = 10
        t0 = time.perf_counter()
        p.run(n_plain)
        p.block_until_ready()
        plain_ms = (time.perf_counter() - t0) / n_plain * 1e3
    print(f"phase 3: the same step with the plain twin: {plain_ms!r} ms/step"
          f" [{gpu}]")

    # end to end on a small box: the kernel path against the twin path on
    # the same draws (the generator is host-side and seeded alike)
    runs = []
    for use_twin in (False, True):
        small = [build_box(2**16, 1.0, False), build_box(2**16, 10.0, True)]
        with (_k1_twin_in_place() if use_twin else contextlib.nullcontext()):
            for q, steps in zip(small, (5, 3)):
                q.run(steps)
        runs.append([
            (q.attributes["multiplicity"], q.attributes["water mass"])
            for q in small
        ])
    for (mk, wk), (mt, wt) in zip(*runs):
        np.testing.assert_array_equal(mk, mt)
        np.testing.assert_allclose(wk, wt, rtol=1e-6)
    print("phase 3: 2^16 box through kernel and twin: xi equal after 5"
          " non-adaptive and 3 adaptive steps")
    return launches


def _adaptive(kern, gpu):
    p = build_box(N_MAIN, 10.0, adaptive=True)
    before = _totals(p)
    n0 = int(p.get_counter("collision_n_substep")[0])
    kern.coalesce_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(5)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    substeps = int(p.get_counter("collision_n_substep")[0]) - n0
    if kern.coalesce_mirror.launches != substeps or substeps < 5:
        raise AssertionError(
            f"{kern.coalesce_mirror.launches} launches for {substeps} substeps"
        )
    _check_conserved("phase 4", before, _totals(p))
    print(f"phase 4: adaptive box n_sd={N_MAIN} dt=10 s: 5 steps, {substeps}"
          f" substeps, {elapsed / 5 * 1e3!r} ms/step [{gpu}]")


def k3_rows(n, seed=7):
    """K3's inputs for ``n`` drops in five cells, as numpy rows (float32,
    int64 multiplicity, int32 cell id, bool cell activity): cell 0
    supersaturated, its drops growing; cell 1 subsaturated haze, wet radius
    twice the dry (``settle_haze`` brings it to equilibrium); cell 2
    inactive; cell 3 with every third drop dead (multiplicity 0) and every
    third of zero mass; cell 4 with dt_sub = 1e30 under supersaturation,
    which drives the root past x_max, where exp overflows"""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = (n // 4, n // 4, n // 8, n // 8, n - 2 * (n // 4) - 2 * (n // 8))
    cell = np.repeat(np.arange(5), sizes).astype(np.int32)
    r_dry = np.exp(rng.uniform(np.log(2e-8), np.log(2e-7), n))
    r_wet = np.exp(rng.uniform(np.log(1e-6), np.log(20e-6), n))
    r_wet[cell == 1] = 2 * r_dry[cell == 1]
    water_mass = (4 / 3 * np.pi * r_wet**3 * 1e3).astype(np.float32)
    mult = rng.integers(1, 10**9, n).astype(np.int64)
    in_cell_3 = np.flatnonzero(cell == 3)
    mult[in_cell_3[::3]] = 0
    water_mass[in_cell_3[1::3]] = 0
    return {
        "water_mass": water_mass,
        "vdry": (4 / 3 * np.pi * r_dry**3).astype(np.float32),
        "kappa": np.full(n, 0.61, np.float32),
        "multiplicity": mult,
        "cell_id": cell,
        "thd": np.full(5, 290.0, np.float32),
        "qv": np.array([0.013, 7.5e-3, 0.013, 0.013, 0.013], np.float32),
        "rhod": np.full(5, 1.1944, np.float32),
        "dt_sub": np.array([0.5, 0.1, 0.5, 0.5, 1e30], np.float32),
        "active": np.array([True, True, False, True, True]),
        "rho_air": np.full(5, 1.2, np.float32),
        "mu_air": np.full(5, 1.8e-5, np.float32),
    }


def k3_call(fn, formulae, settings, rows, device):
    """``fn`` (K3's wrapper or its twin) on the rows moved to ``device``;
    numpy (mass_new, success)"""
    import torch

    mass, success = fn(
        formulae, settings,
        *(torch.from_numpy(rows[k]).to(device) for k in K3_ARGS),
    )
    return mass.cpu().numpy(), success.cpu().numpy()


def settle_haze(formulae, rows, device, cell=1, max_rounds=60):
    """iterate the drops of ``cell`` through K3's wrapper (the kernel on a
    CUDA device, the twin on the CPU) until their masses change by less than
    5e-5 in a round: haze at its float32 Koehler equilibrium"""
    import numpy as np

    from pysdm_tpu_torch.ops.condensation import DropSolveSettings
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    rows = dict(rows)
    in_cell = rows["cell_id"] == cell
    for _ in range(max_rounds):
        mass, _ = k3_call(
            k3.masses_new, formulae, DropSolveSettings(*K3_SETTINGS), rows,
            device,
        )
        old = rows["water_mass"]
        change = np.max(np.abs(mass[in_cell] - old[in_cell]) / old[in_cell])
        rows["water_mass"] = np.where(in_cell, mass, old)
        if change < 5e-5:
            return rows
    raise AssertionError("haze did not settle")


def check_k3_regimes(rows, mass, success):
    """what each cell of ``k3_rows`` must give, whatever computed it"""
    import numpy as np

    cell, old = rows["cell_id"], rows["water_mass"]
    growing, haze = cell == 0, cell == 1
    inert = (cell == 2) | (rows["multiplicity"] == 0) | (old == 0)
    non_finite = (cell == 4) & ~inert
    if not (success[growing].all() and (mass[growing] > old[growing]).all()):
        raise AssertionError("K3: the supersaturated drops did not all grow")
    if not success[haze].all():
        raise AssertionError("K3: settled haze failed")
    np.testing.assert_allclose(mass[haze], old[haze], rtol=1e-4)
    if not success[inert].all() or (mass[inert] != old[inert]).any():
        raise AssertionError("K3: an inactive, dead or dry drop changed")
    if success[non_finite].any() or (mass[non_finite] != old[non_finite]).any():
        raise AssertionError("K3: a non-finite root was not refused")


def compare_k3(rows, kernel, twin, rtol_x):
    """kernel against twin: success equal; where either moved the drop,
    log-mass within 2 rtol_x |x_old| + 2e-5: each stops bisecting inside a
    bracket of width rtol_x |x_old| around the root, an ulp in minfun can
    send the last halvings to either side, and two float32 libms put the
    root itself up to ~1e-5 apart (the twin on the CPU lies within 9e-6 of
    the float64 root); elsewhere equal. Returns the largest absolute and
    relative mass differences."""
    import numpy as np

    (mass_k, ok_k), (mass_t, ok_t) = kernel, twin
    np.testing.assert_array_equal(ok_k, ok_t)
    old = rows["water_mass"]
    moved = (mass_k != old) | (mass_t != old)
    x_old = np.abs(np.log(np.where(old > 0, old, 1e-18).astype(np.float64)))
    dx = np.abs(np.log(mass_k[moved].astype(np.float64))
                - np.log(mass_t[moved].astype(np.float64)))
    if not (dx <= 2 * rtol_x * x_old[moved] + 2e-5).all():
        raise AssertionError(f"K3: log-mass off by {dx.max()!r}")
    np.testing.assert_array_equal(mass_k[~moved], mass_t[~moved])
    diff = np.abs(mass_k.astype(np.float64) - mass_t)
    rel = diff[moved] / mass_t[moved]
    return float(diff.max()), float(rel.max()) if rel.size else 0.0


def k3_uniform_rows(rows, source_cell, active=True):
    """``k3_rows`` made uniform: every drop takes the state of a drop of
    ``source_cell`` and every cell that cell's rows (``active`` for all)"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    take = np.resize(np.flatnonzero(rows["cell_id"] == source_cell), n)
    uniform = {
        k: v[take] if v.shape[0] == n else np.full_like(v, v[source_cell])
        for k, v in rows.items()
    }
    uniform["cell_id"] = rows["cell_id"]
    uniform["active"] = np.full_like(rows["active"], active)
    return uniform


def k3_permuted_rows(rows, seed=3):
    """(rows with the drops in a random order, the order): a block's drops
    then come from every cell, before and after its first drop's, so most
    blocks' threads compute their cells' states themselves"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    order = np.random.default_rng(seed).permutation(n)
    return {
        k: v[order] if v.shape[0] == n else v for k, v in rows.items()
    }, order


def k3_regrouped_rows(rows, n_cell):
    """``k3_rows`` spread over ``n_cell`` cells of equal size, sorted by
    cell: cell c takes the rows of cell c % 5 and drops of that cell"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    cell = (np.arange(n) * n_cell // n).astype(np.int32)
    take = np.empty(n, np.int64)
    for source in range(5):
        slots = np.flatnonzero(cell % 5 == source)
        take[slots] = np.resize(
            np.flatnonzero(rows["cell_id"] == source), slots.size
        )
    regrouped = {
        k: v[take] if v.shape[0] == n else v[np.arange(n_cell) % 5]
        for k, v in rows.items()
    }
    regrouped["cell_id"] = cell
    return regrouped


def k3_evaluations(k3, formulae, settings, args, halving=False):
    """minfun evaluations the twin counts on ``args``; ``halving``: with
    every round of the root search in the middle of the bracket"""
    import torch

    from pysdm_tpu_torch.ops import condensation as cond_ops

    stats = {}
    context = (
        _replaced(cond_ops, "_interpolation_fraction",
                  lambda xa, *rest: torch.full_like(xa, 0.5))
        if halving else contextlib.nullcontext()
    )
    with context:
        k3.masses_new_reference(formulae, settings, *args, stats=stats)
    return stats["minfun_evaluations"]


def _k3_vs_twin(torch, k3, device, gpu):
    """phase 5; returns (max_abs_err, {n: (kernel_ms, twin_ms)}, {n: the
    minfun evaluations the rows need})"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.ops.condensation import DropSolveSettings

    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*K3_SETTINGS)
    max_abs_err, times, evaluations = 0.0, {}, {}
    for n in (N_PARCEL, N_MAIN):
        rows = settle_haze(formulae, k3_rows(n, seed=n), device)
        before = k3.masses_new.launches
        kernel = k3_call(k3.masses_new, formulae, settings, rows, device)
        if k3.masses_new.launches != before + 1:
            raise AssertionError("K3's counter did not count the launch")
        twin = k3_call(
            k3.masses_new_reference, formulae, settings, rows, device
        )
        check_k3_regimes(rows, *kernel)
        check_k3_regimes(rows, *twin)
        abs_err, rel_err = compare_k3(rows, kernel, twin, settings.rtol_x)
        max_abs_err = max(max_abs_err, abs_err)
        # the same drops in a random order: the blocks whose drops do not lie
        # within eight cells of the first one's take the per-thread cell
        # state, which must give every drop the bits of the shared one
        permuted, order = k3_permuted_rows(rows)
        shuffled = k3_call(k3.masses_new, formulae, settings, permuted, device)
        for got, want in zip(shuffled, kernel):
            if (got != want[order]).any():
                raise AssertionError("K3: a drop's result depends on its block")
        compare_k3(
            permuted, shuffled,
            k3_call(k3.masses_new_reference, formulae, settings, permuted, device),
            settings.rtol_x,
        )
        args = [torch.from_numpy(rows[k]).to(device) for k in K3_ARGS]
        evaluations[n] = k3_evaluations(k3, formulae, settings, args)
        times[n] = (
            _time_ms(torch, lambda: k3.masses_new(formulae, settings, *args), 50),
            _time_ms(
                torch,
                lambda: k3.masses_new_reference(formulae, settings, *args), 3,
            ),
        )
        bound = bound_ms(n * 29, evaluations[n] * K3_OPS_PER_MINFUN)
        print(f"phase 5: K3 n={n}: success equal, mass max abs diff"
              f" {abs_err!r} kg, max rel diff {rel_err!r}, and the drops in"
              f" a random order bit-equal to the sorted ones; kernel"
              f" {times[n][0]!r} ms, plain twin {times[n][1]!r} ms; the rows"
              f" need {evaluations[n]} minfun evaluations"
              f" ({evaluations[n] / n!r} per drop), bound {bound[0]!r} ms"
              f" ({bound[1]}) [{gpu}]")
        if n != N_PARCEL:
            continue
        halving = k3_evaluations(k3, formulae, settings, args, halving=True)
        print(f"phase 5: K3 n={n}: plain halving would need {halving} minfun"
              f" evaluations ({halving / n!r} per drop)")
        for name, source_cell, active in (
            ("every drop growing", 0, True),
            ("every drop haze at equilibrium", 1, True),
            ("every cell inactive", 0, False),
        ):
            uniform = k3_uniform_rows(rows, source_cell, active)
            u_args = [torch.from_numpy(uniform[k]).to(device) for k in K3_ARGS]
            kernel = k3_call(k3.masses_new, formulae, settings, uniform, device)
            twin = k3_call(
                k3.masses_new_reference, formulae, settings, uniform, device
            )
            compare_k3(uniform, kernel, twin, settings.rtol_x)
            count = k3_evaluations(k3, formulae, settings, u_args)
            ms = _time_ms(
                torch, lambda: k3.masses_new(formulae, settings, *u_args), 50
            )
            print(f"phase 5: K3 n={n}, {name}: kernel {ms!r} ms,"
                  f" {count / n!r} minfun evaluations per drop [{gpu}]")
    return max_abs_err, times, evaluations


def build_parcel(n_sd, backend, adaptive, qv0=0.0158):
    """``bench.py``'s parcel (BASELINE config #3: p0 = 1000 hPa, T0 = 300 K,
    w = 2 m/s, lognormal dry spectrum, kappa = 0.5) on the port's ``backend``
    class"""
    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation
    from pysdm_tpu_torch.environments import Parcel
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.initialisation.spectra import Lognormal

    formulae = Formulae(seed=44)
    env = Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=qv0, T0=300.0, w=2.0,
    )
    builder = Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=adaptive))
    spectrum = Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = ConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes)


def _liquid(p):
    """liquid water mixing ratio (kg/kg) in float64"""
    mult = p.attributes["multiplicity"].astype(float)
    return float((mult * p.attributes["water mass"]).sum()) / float(
        p.get_env("m_d")[0]
    )


def _parcel_main_path(k3, gpu):
    """phase 6; returns (K3 launches, ms/step)"""
    import numpy as np

    from pysdm_tpu_torch.backends import GPU

    p = build_parcel(N_PARCEL, GPU, adaptive=True)
    water0 = float(p.get_env("qv")[0]) + _liquid(p)
    p.run(1)
    p.block_until_ready()
    solver = p.dynamics["Condensation"].solver
    k3.masses_new.launches = 0
    solves0, reads0 = solver.substep_solves, solver.host_reads
    t0 = time.perf_counter()
    p.run(N_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = k3.masses_new.launches
    solves = solver.substep_solves - solves0
    if launches != solves or launches < N_STEPS:
        raise AssertionError(f"{launches} K3 launches for {solves} solves")
    ms_step = elapsed / N_STEPS * 1e3
    print(f"phase 6: parcel n_sd={N_PARCEL} adaptive: {N_PARCEL * N_STEPS / elapsed!r}"
          f" droplet-steps/s, {ms_step!r} ms/step, {launches} K3 launches"
          f" ({launches / N_STEPS!r}/step), host reads"
          f" {(solver.host_reads - reads0) / N_STEPS!r}/step [{gpu}]")

    p.run(PARCEL_STEPS - N_STEPS - 1)
    p.block_until_ready()
    if not p.get_counter("condensation_success").all():
        raise AssertionError("parcel: condensation failed")
    RH_max = float(p.get_counter("condensation_RH_max")[0])
    liquid = _liquid(p)
    qv = float(p.get_env("qv")[0])
    mean_r = float(np.mean(p.attributes["radius"].astype(float)))
    drift = (qv + liquid - water0) / water0
    print(f"phase 6: after {PARCEL_STEPS} steps (z = {float(p.get_env('z')[0])!r}"
          f" m): RH_max {RH_max!r}, liquid {liquid!r} kg/kg, qv {qv!r},"
          f" mean radius {mean_r!r} m, total water drift {drift!r}")
    if not 1.0005 < RH_max < 1.05:
        raise AssertionError(f"parcel: RH_max {RH_max}")
    if not liquid > 1e-4:
        raise AssertionError(f"parcel: liquid water {liquid}")
    if not 5e-6 < mean_r < 50e-6:
        raise AssertionError(f"parcel: mean radius {mean_r}")
    # float32 state: qv is rounded at ~6e-10 kg/kg per substep and the
    # liquid sum over 2^17 drops at ~1e-7 of itself
    if not abs(drift) < 1e-4:
        raise AssertionError(f"parcel: total water drifted by {drift}")

    # kernel and twin over the same stretch of cloud, 10 steps each
    in_cloud_ms = []
    twin = _replaced(k3, "masses_new", k3.masses_new_reference)
    for context in (contextlib.nullcontext(), twin):
        with context:
            t0 = time.perf_counter()
            p.run(10)
            p.block_until_ready()
            in_cloud_ms.append((time.perf_counter() - t0) / 10 * 1e3)
    print(f"phase 6: in cloud, steps {PARCEL_STEPS}-{PARCEL_STEPS + 20}:"
          f" {in_cloud_ms[0]!r} ms/step through K3, {in_cloud_ms[1]!r}"
          f" ms/step with the plain twin in its place [{gpu}]")
    return launches, ms_step


def _parcel_gpu_vs_cpu(k3):
    """phase 7: float32 through K3 on the card against the CPU float64
    backend (the bounds of the JAX package's fused-kernel test)"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU, GPU

    # adaptive from qv0 = 0.0225 is not compared: float32 and float64 pick
    # different substep counts through activation (2.8e-3 apart in a CPU
    # float32 run)
    for qv0, adaptive in ((0.0158, False), (0.0158, True), (0.0225, False)):
        before = k3.masses_new.launches
        on_card, on_cpu = (
            build_parcel(64, b, adaptive, qv0=qv0) for b in (GPU, CPU)
        )
        on_card.run(50)
        on_cpu.run(50)
        if k3.masses_new.launches == before:
            raise AssertionError("phase 7: the card's run did not launch K3")
        for q in (on_card, on_cpu):
            if not q.get_counter("condensation_success").all():
                raise AssertionError("phase 7: condensation failed")
        np.testing.assert_allclose(
            on_card.attributes["water mass"], on_cpu.attributes["water mass"],
            rtol=2e-3,
        )
        np.testing.assert_allclose(
            on_card.get_env("qv"), on_cpu.get_env("qv"), rtol=1e-4
        )
        err = np.max(np.abs(
            on_card.attributes["water mass"] / on_cpu.attributes["water mass"]
            - 1
        ))
        print(f"phase 7: 64 drops, 50 steps, qv0={qv0}, adaptive={adaptive}:"
              f" RH_max {float(on_cpu.get_counter('condensation_RH_max')[0])!r},"
              f" water mass max rel diff {err!r}, qv"
              f" {on_card.get_env('qv')[0]!r} vs"
              f" {on_cpu.get_env('qv')[0]!r}")



# the card's published rates (NVIDIA H100 SXM data sheet, at 700 W): device
# memory bytes/s and dense float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations charged to one minfun evaluation in K3's bound: the
# count of its first formulation (exp, cube root, the Koehler and Fick
# terms, the log-coordinate derivative: ~20 multiply-adds, ~8 divisions, 4
# transcendental calls, each counted as one operation), kept so that the
# bounds of all slices compare; the kernel now runs fewer
K3_OPS_PER_MINFUN = 60
WARM_RAIN_GRID = (25, 25)
WARM_RAIN_SD_PER_CELL = 2**12
WARM_RAIN_STEPS = 30


def bound_ms(n_bytes, n_ops=0.0):
    """(least time on the card in ms, what sets it): the larger of the
    bytes over the memory rate and the operations over the float32 rate"""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_rotated_ms(torch, fn, inputs, reps):
    """``_time_ms`` of ``fn(x)`` with x taken in turn from ``inputs``, which
    together exceed the L2, so that every call reads device memory"""
    state = {"k": 0}

    def call():
        state["k"] += 1
        return fn(inputs[state["k"] % len(inputs)])

    return _time_ms(torch, call, reps)


def _k4_vs_twin(torch, scan, device, gpu):
    """phase 8: K4 against torch.cumsum and float64; returns (max_abs_err,
    kernel_ms, twin_ms, n) for float32 at 2.56 M, on one input"""
    import numpy as np

    n_main = WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1] * WARM_RAIN_SD_PER_CELL
    max_abs_err = 0.0
    for n in (2**20, n_main, n_main + 12345, 1000, 1):
        rng = np.random.default_rng(n)
        for dtype in (torch.int32, torch.int64):
            x = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dtype).to(device)
            got = scan.cumsum(x)
            if not torch.equal(got, scan.cumsum_reference(x)):
                raise AssertionError(f"K4 {dtype} n={n}: not exact")
        x_np = rng.uniform(size=n).astype(np.float32)
        x = torch.from_numpy(x_np).to(device)
        before = scan.cumsum.launches, scan.cumsum.rows
        runs = [scan.cumsum(x) for _ in range(3)]
        torch.cuda.synchronize()
        if (scan.cumsum.launches, scan.cumsum.rows) != (before[0] + 3, before[1] + 3):
            raise AssertionError("K4's counters did not count the launches")
        if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])):
            raise AssertionError("K4: three runs differ")
        exact = np.cumsum(x_np.astype(np.float64))
        err = np.abs(runs[0].cpu().numpy() - exact)
        twin_err = np.abs(scan.cumsum_reference(x).cpu().numpy() - exact)
        # a chain of at most ~40 roundings of 2^-24 of the prefix each
        if not (err <= 1e-5 * exact).all():
            raise AssertionError(f"K4 f32 n={n}: rel err {np.max(err / exact)!r}")
        if n == n_main:
            max_abs_err = float(err.max())
        # four rows in one launch (rows 1-3 of an odd n are not 16-byte
        # aligned), each bit-equal to its own scan
        rows_np = np.stack([x_np, *rng.uniform(size=(3, n)).astype(np.float32)])
        rows = torch.from_numpy(rows_np).to(device)
        before = scan.cumsum.launches, scan.cumsum.rows
        got = scan.cumsum(rows)
        if (scan.cumsum.launches, scan.cumsum.rows) != (before[0] + 1, before[1] + 4):
            raise AssertionError("K4's counters did not count the rows")
        if not torch.equal(got[0], runs[0]) or not all(
            torch.equal(got[r], scan.cumsum(rows[r])) for r in (1, 2, 3)
        ):
            raise AssertionError(f"K4 n={n}: a row of (4, n) is not its 1D scan")
        print(f"phase 8: K4 n={n}: int32 and int64 exact, float32 max rel"
              f" err {float(np.max(err / exact))!r} (torch.cumsum"
              f" {float(np.max(twin_err / exact))!r}), three runs and the"
              f" rows of a (4, n) call bit-equal")

    rng = np.random.default_rng(0)
    inputs = [
        torch.from_numpy(rng.uniform(size=n_main).astype(np.float32)).to(device)
        for _ in range(8)
    ]
    # two scans in flight at once, each on its own stream with its own flags
    alone = [scan.cumsum(x) for x in inputs[:2]]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in alone]
    together = []
    for _ in range(20):
        for x, stream in zip(inputs[:2], streams):
            with torch.cuda.stream(stream):
                together.append(scan.cumsum(x))
    torch.cuda.synchronize()
    if not all(torch.equal(got, alone[k % 2]) for k, got in enumerate(together)):
        raise AssertionError("K4: scans on two streams differ from scans alone")
    print("phase 8: K4: 20 pairs of scans queued on two streams bit-equal to"
          " the scans alone")

    x = inputs[0]
    stacked = [torch.stack(inputs[k : k + 4]) for k in (0, 4)]
    kernel_ms = _time_ms(torch, lambda: scan.cumsum(x), 200)
    twin_ms = _time_ms(torch, lambda: scan.cumsum_reference(x), 200)
    rows_ms = _time_ms(torch, lambda: scan.cumsum(stacked[0]), 100)
    kernel_cold = _time_rotated_ms(torch, scan.cumsum, inputs, 200)
    twin_cold = _time_rotated_ms(torch, scan.cumsum_reference, inputs, 200)
    rows_cold = _time_rotated_ms(torch, scan.cumsum, stacked, 100)
    rows_twin = _time_rotated_ms(torch, scan.cumsum_reference, stacked, 100)
    print(f"phase 8: K4 n={n_main} float32, one input (in the L2): kernel"
          f" {kernel_ms!r} ms, torch.cumsum {twin_ms!r} ms, a (4, n) call"
          f" {rows_ms!r} ms; over a rotation of 8 inputs (device memory):"
          f" kernel {kernel_cold!r} ms, torch.cumsum {twin_cold!r} ms; (4, n)"
          f" over a rotation of 2: kernel {rows_cold!r} ms, torch.cumsum"
          f" {rows_twin!r} ms [{gpu}]")
    return max_abs_err, kernel_ms, twin_ms, n_main


def _k2_vs_twin(torch, kern, device, gpu):
    """phase 9: K2 against its twin at the warm rain's size, three float32
    rows; returns (max_abs_err, kernel_ms, twin_ms, bytes)"""
    import numpy as np

    n = WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1] * WARM_RAIN_SD_PER_CELL
    state = k2_state(n, WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1], 3, np.float32, 9)
    args = [torch.from_numpy(a).to(device) for a in state[:5]]
    before = kern.coalesce_adjacent.launches
    got = kern.coalesce_adjacent(*args)
    torch.cuda.synchronize()
    if kern.coalesce_adjacent.launches != before + 1:
        raise AssertionError("K2's counter did not count the launch")
    want = kern.coalesce_adjacent_reference(*args)
    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    changed = float((got[0] != state[0]).mean())
    if not 0.05 < changed < 0.95:
        raise AssertionError(f"K2 touched {changed} of the slots")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_adjacent(*args), 200)
    twin_ms = _time_ms(torch, lambda: kern.coalesce_adjacent_reference(*args), 20)
    # each input read once, each output written once: mult 8, three rows
    # 12, kernnorm 4, rand 4, is_first 1 in; mult 8, rows 12, rate and
    # deficit 8 out
    n_bytes = n * (8 + 12 + 4 + 4 + 1 + 8 + 12 + 8)
    print(f"phase 9: K2 n={n} R=3: xi equal ({changed!r} of the slots"
          f" changed), ext max abs err {err!r}; kernel {kernel_ms!r} ms,"
          f" plain twin {twin_ms!r} ms [{gpu}]")
    return err, kernel_ms, twin_ms, n_bytes


def warm_rain(backend, grid, n_sd_per_gridbox, seed=44, spin_up_time=0.0):
    """config #5, the Arabas et al. 2015 2D warm rain, through the port's
    entry point; ``backend`` None takes make_simulation's default (the
    card)"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import arabas_et_al_2015 as model

    settings = model.Settings(
        Formulae(seed=seed), grid=grid, size=(1500.0, 1500.0),
        n_sd_per_gridbox=n_sd_per_gridbox, spin_up_time=spin_up_time,
    )
    kwargs = {} if backend is None else {"backend_class": backend}
    particulator, spin_up = model.make_simulation(settings, **kwargs)
    return settings, particulator, spin_up


def total_water(p):
    """vapour, liquid and this step's precipitation, kg (float64), after
    checking multiplicities and masses"""
    import numpy as np

    mult = p.attributes["multiplicity"]
    mass = p.attributes["water mass"]
    if (mult < 0).any():
        raise AssertionError("negative multiplicity")
    if not np.isfinite(mass).all():
        raise AssertionError("non-finite water mass")
    vapour = float(np.sum(
        p.get_env("rhod").astype(float) * p.get_env("qv") * p.mesh.dv
    ))
    liquid = float(np.sum(mult.astype(float) * mass))
    return vapour + liquid + float(np.sum(p.get_counter("precipitated_mass")))


def _host_reads(p):
    return (
        p.dynamics["Collision"].host_reads
        + p.dynamics["Displacement"].host_reads
        + p.dynamics["Condensation"].solver.host_reads
    )


def _warm_rain_main_path(kern, k3, scan, gpu):
    """phase 10: the full-width warm rain on the card; returns (launches
    per kernel, the particulator, ms/step)"""
    import numpy as np

    _, p, spin_up = warm_rain(None, WARM_RAIN_GRID, WARM_RAIN_SD_PER_CELL)
    if p.device.type != "cuda":
        raise AssertionError(f"make_simulation built on {p.device}")
    spin_up.finish()
    p.run(1)
    p.block_until_ready()
    water0 = total_water(p)
    collision = p.dynamics["Collision"]
    substeps0, reads0 = collision.substeps_run, _host_reads(p)
    solves0 = p.dynamics["Condensation"].solver.substep_solves
    kern.coalesce_adjacent.launches = 0
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    t0 = time.perf_counter()
    p.run(WARM_RAIN_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = {
        "coalesce_adjacent": kern.coalesce_adjacent.launches,
        "masses_new": k3.masses_new.launches,
        "cumsum": scan.cumsum.launches,
    }
    substeps = collision.substeps_run - substeps0
    solves = p.dynamics["Condensation"].solver.substep_solves - solves0
    if launches["coalesce_adjacent"] != substeps or substeps < WARM_RAIN_STEPS:
        raise AssertionError(f"{launches} for {substeps} collision substeps")
    if launches["masses_new"] != solves or launches["cumsum"] == 0:
        raise AssertionError(f"{launches} for {solves} condensation solves")
    if not p.get_counter("condensation_success").all():
        raise AssertionError("warm rain: condensation failed")
    drift = (total_water(p) - water0) / water0
    if not abs(drift) < 1e-3:
        raise AssertionError(f"warm rain: total water drifted by {drift}")
    ms_step = elapsed / WARM_RAIN_STEPS * 1e3
    n_cell = p.mesh.n_cell
    per_step = {k: v / WARM_RAIN_STEPS for k, v in launches.items()}
    per_step["cumsum rows"] = scan.cumsum.rows / WARM_RAIN_STEPS
    print(f"phase 10: warm rain {WARM_RAIN_GRID} x {WARM_RAIN_SD_PER_CELL}"
          f" ({p.n_sd} super-droplets), {WARM_RAIN_STEPS} steps after one:"
          f" {ms_step!r} ms/step, {n_cell * WARM_RAIN_STEPS / elapsed!r} grid"
          f" points/s, {p.n_sd / 2 * substeps / elapsed!r} pair-updates/s;"
          f" launches per step {per_step}, collision substeps"
          f" {substeps / WARM_RAIN_STEPS!r}/step, condensation solves"
          f" {solves / WARM_RAIN_STEPS!r}/step, host reads"
          f" {(_host_reads(p) - reads0) / WARM_RAIN_STEPS!r}/step; total"
          f" water drift {drift!r}; coalescence rate"
          f" {float(p.get_counter('coalescence_rate').sum())!r} [{gpu}]")
    return launches, p, ms_step


def compare_k3_near_saturation(formulae, settings, rows, kernel, twin_of):
    """kernel against twin where compare_k3's bound cannot hold: in cells
    within ~1e-3 of saturation a drop's growth goes with RH - RH_eq, so its
    new log-mass moves by ~4e3 per unit of RH, and two float32 evaluations
    of RH (T through a power, pvs through an 8th-degree polynomial) lie up
    to 4e-6 apart (each within 2e-6 of the float64 value), which puts
    kernel, twin on the card and twin on the CPU up to 5e-3 apart in
    log-mass, each as far from the float64 root. So: success equal, and
    every drop's log-mass between the twin's results with the cells'
    vapour content 32 float32 ulps (3.8e-6) lower and higher, widened by
    compare_k3's 2 rtol_x |x_old| + 2e-5. At a drop about to activate the
    interval is wide, whatever computes it. ``rows``: K3's tensors;
    ``twin_of(rows)``: the twin's (mass, success), in the rows' dtype.
    Returns what was seen: the largest absolute mass and log-mass
    differences to the twin on the rows as they are, the kernel's and the
    twin's largest log-mass distance from the twin in float64, how many
    drops have an interval wider than 0.02, and the largest distance of a
    cell's float32 RH from its float64 one."""
    import torch

    from pysdm_tpu_torch.ops.condensation import thermo

    def log_mass(mass):
        return torch.log(mass.double().clamp_min(1e-300))

    def relative_humidity(dtype):
        thd, qv, rhod, _, _, rho_air, mu_air = (
            r.to(dtype) for r in rows[5:]
        )
        return thermo(formulae, thd, qv, rhod, rho_air, mu_air)[2]

    (mass_k, ok_k), (mass_t, ok_t) = kernel, twin_of(rows)
    if not torch.equal(ok_k, ok_t):
        raise AssertionError("K3: success differs from the twin's")
    qv = K3_ARGS.index("qv")
    step = 32 * torch.finfo(torch.float32).eps
    ends = [
        log_mass(twin_of([*rows[:qv], rows[qv] * factor, *rows[qv + 1:]])[0])
        for factor in (1 - step, 1 + step)
    ]
    old = rows[0]
    tol = 2 * settings.rtol_x * log_mass(old.clamp_min(1e-18)).abs() + 2e-5
    low = torch.minimum(*ends) - tol
    high = torch.maximum(*ends) + tol
    x_k = log_mass(mass_k)
    outside = (old > 0) & ((x_k < low) | (x_k > high))
    if outside.any():
        worst = torch.maximum(low - x_k, x_k - high)[outside].max()
        raise AssertionError(
            f"K3: {int(outside.sum())} drops outside the twin's interval, by"
            f" up to {float(worst)!r} in log-mass"
        )
    mass_64, ok_64 = twin_of(
        [r.double() if r.is_floating_point() else r for r in rows]
    )
    solved = (old > 0) & ok_64
    return {
        "mass": float((mass_k.double() - mass_t.double()).abs().max()),
        "log-mass": float((x_k - log_mass(mass_t)).abs()[old > 0].max()),
        "kernel to float64": float(
            (x_k - log_mass(mass_64)).abs()[solved].max()
        ),
        "twin to float64": float(
            (log_mass(mass_t) - log_mass(mass_64)).abs()[solved].max()
        ),
        "wide intervals": int(((high - low)[old > 0] > 0.02).sum()),
        "RH float32 to float64": float(
            (relative_humidity(torch.float32).double()
             - relative_humidity(torch.float64)).abs().max()
        ),
    }


def _k3_on_a_warm_rain_solve(torch, p, k3, gpu):
    """phase 10, after the counted steps: one more step whose first
    condensation solve is captured; on that solve's inputs (2.56 M drops
    sorted into 625 cells, many of them near saturation) K3 on the drops in
    a random order bit-equal to K3 on the sorted ones (a block's shared
    cell states against per-thread ones), K3 against its twin
    (``compare_k3_near_saturation``), then K3's time, its minfun
    evaluations (counted by the twin) and its bound; returns the largest
    absolute mass difference to the twin"""
    captured = []
    real = k3.masses_new

    def capturing(*args):
        if not captured:
            captured.append(args)
        return real(*args)

    capturing.launches = 0
    with _replaced(k3, "masses_new", capturing):
        p.run(1)
        p.block_until_ready()
    formulae, settings, *rows = captured[0]
    n = rows[0].shape[0]
    active = int((rows[9][rows[4].long()] & (rows[3] > 0) & (rows[0] > 0)).sum())
    kernel = real(formulae, settings, *rows)
    order = torch.randperm(
        n, generator=torch.Generator(rows[0].device).manual_seed(3),
        device=rows[0].device,
    )
    shuffled = real(
        formulae, settings,
        *(r[order] if r.shape[0] == n else r for r in rows),
    )
    for got, want in zip(shuffled, kernel):
        if not torch.equal(got, want[order]):
            raise AssertionError("K3: a drop's result depends on its block")

    def twin_of(rows):
        return k3.masses_new_reference(formulae, settings, *rows)

    seen = compare_k3_near_saturation(
        formulae, settings, rows, kernel, twin_of
    )
    count = k3_evaluations(k3, formulae, settings, rows)
    ms = _time_ms(torch, lambda: real(formulae, settings, *rows), 50)
    bound = bound_ms(n * 29, count * K3_OPS_PER_MINFUN)
    print(f"phase 10: K3 on the first solve of a warm-rain step ({n} drops"
          f" in {rows[5].shape[0]} cells, {active} of them active): the drops"
          f" in a random order bit-equal to the sorted ones; success equal"
          f" to the twin's and every log-mass inside the twin's interval for"
          f" +-32 ulps of qv; largest differences {seen}; kernel {ms!r} ms;"
          f" {count} minfun evaluations"
          f" ({count / n!r} per drop), bound {bound[0]!r} ms ({bound[1]})"
          f" [{gpu}]")
    return seen["mass"]


def _percell_sums_vs_float64(p):
    """K4 per-cell sums of the main path's liquid water (the condensation
    coupling's ml) against float64 sums of the same float32 values"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.ops import segments

    particles = p.particles
    n_cell = p.mesh.n_cell
    cell_start = segments.cell_start_of_sorted(particles.cell_id, n_cell)
    mass = particles.ext("signed water mass")
    values = torch.where(
        mass > 0, particles.multiplicity.to(mass.dtype) * mass, 0.0
    )
    sums = segments.sorted_segment_sum(values, cell_start, n_cell).cpu().numpy()
    exact = np.bincount(
        particles.cell_id.cpu().numpy(),
        weights=values.cpu().numpy().astype(np.float64), minlength=n_cell,
    )
    rel = np.abs(sums - exact) / exact
    prefix = np.cumsum(exact)
    print(f"phase 10: K4 per-cell liquid sums against float64: max rel err"
          f" {float(rel.max())!r} of the cell's sum, median"
          f" {float(np.median(rel))!r}; max {float(np.max(np.abs(sums - exact) / prefix))!r}"
          f" of the prefix")


def _warm_rain_scenario_on_card(gpu):
    """phase 11: ``tests/smoke/test_kinematic_2d.py`` on the card, then the
    float32 card spin-up against the CPU float64 one"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.backends import CPU

    settings, p, spin_up = warm_rain(None, (8, 8), 16, seed=13,
                                     spin_up_time=300.0)
    w0 = total_water(p)
    lwc0 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    p.run(settings.n_spin_up)
    rh = p.get_env("RH").reshape(settings.grid)
    lwc1 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    spin_drift = (total_water(p) - w0) / w0
    if not (p.get_counter("condensation_success").all()
            and np.isfinite(rh).all() and rh.max() < 1.10
            and rh[:, -3:].max() > 0.99 and rh[:, :2].max() < 0.95
            and lwc1 > 5 * lwc0 and abs(spin_drift) < 1e-3):
        raise AssertionError(
            f"spin-up: RH max {rh.max()}, top {rh[:, -3:].max()}, bottom"
            f" {rh[:, :2].max()}, lwc {lwc0} -> {lwc1}, drift {spin_drift}"
        )
    spin_up.finish()
    w1 = total_water(p)
    p.run(120)
    rain_drift = (total_water(p) - w1) / w1
    alive = p.attributes["multiplicity"] > 0
    r_max = float(p.attributes["radius"][alive].max())
    coal = float(p.get_counter("coalescence_rate").sum())
    if not (p.get_counter("condensation_success").all() and coal > 0
            and abs(rain_drift) < 1e-3 and r_max > 1e-6):
        raise AssertionError(
            f"rain: coalescence {coal}, drift {rain_drift}, r_max {r_max}"
        )
    print(f"phase 11: 8x8 x 16 on the card: after the 5 min spin-up RH max"
          f" {float(rh.max())!r}, liquid x{lwc1 / lwc0!r}, water drift"
          f" {spin_drift!r}; after 10 min of rain coalescence rate {coal!r},"
          f" largest radius {r_max!r} m, water drift {rain_drift!r} [{gpu}]")

    # the card (float32, K3) against the CPU float64 backend over 20 spin-up
    # steps, with a CPU float32 run as the yardstick: through activation
    # (RH up to ~1.2 in the top cells) float32 alone moves single drops by
    # up to ~12% (the Richardson floor 16 eps picks other substep counts),
    # so the card must stay as close to float64 as float32 on the CPU does
    from pysdm_tpu_torch.backends import TorchBackend

    class CPU32(TorchBackend):
        def __init__(self, formulae=None):
            super().__init__(formulae, torch.float32, "cpu")

    runs = [warm_rain(b, (8, 8), 16, spin_up_time=3600.0)[1]
            for b in (None, CPU32, CPU)]
    for q in runs:
        q.run(20)
    on_card, cpu32, cpu64 = runs
    np.testing.assert_array_equal(
        on_card.attributes["cell id"], cpu64.attributes["cell id"]
    )

    def gaps(q):
        mass = np.abs(q.attributes["water mass"] / cpu64.attributes["water mass"] - 1)
        return (float(np.max(np.abs(q.get_env("qv") / cpu64.get_env("qv") - 1))),
                float(mass.max()), float(np.median(mass)))

    (qv_err, mass_err, mass_median), yardstick = gaps(on_card), gaps(cpu32)
    if not (qv_err < 1e-4 and mass_err < 1.5 * yardstick[1] + 2e-3
            and mass_median < 2e-3):
        raise AssertionError(
            f"card f32 vs CPU f64: qv {qv_err}, mass {mass_err} (median"
            f" {mass_median}); CPU f32 vs f64: {yardstick}"
        )
    print(f"phase 11: 20 spin-up steps against CPU float64: card float32 qv"
          f" max rel diff {qv_err!r}, water mass max rel diff {mass_err!r}"
          f" (median {mass_median!r}); CPU float32 {yardstick[0]!r},"
          f" {yardstick[1]!r} (median {yardstick[2]!r})")


def _warm_rain_with_twins(p, gpu):
    """phase 12 (timing only): the main path's step with K2's and K4's
    twins in their places"""
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops import segments
    from pysdm_tpu_torch.ops.cuda.collision import coalesce_adjacent_reference
    from pysdm_tpu_torch.ops.cuda.scan import cumsum_reference

    steps = 5
    times = []
    for twins in (False, True):
        contexts = (
            [_replaced(collision, "coalesce_adjacent", coalesce_adjacent_reference),
             _replaced(segments, "cumsum", cumsum_reference)]
            if twins else []
        )
        with contextlib.ExitStack() as stack:
            for c in contexts:
                stack.enter_context(c)
            t0 = time.perf_counter()
            p.run(steps)
            p.block_until_ready()
            times.append((time.perf_counter() - t0) / steps * 1e3)
    print(f"phase 12: warm rain, {steps} more steps: {times[0]!r} ms/step"
          f" through K2 and K4, {times[1]!r} ms/step with their twins in"
          f" their places [{gpu}]")


# config #2, the de Jong/Mackay 2023 breakup box, at the JAX bench's size
# (``bench.py:183-228``)
BREAKUP_N = 2**17
BREAKUP_STEPS = 100
# float32 operations K5 runs per slot (collision kernel, three pair-keyed
# draws, gamma, the process choice, the Berry efficiency with its four powf)
# and per breaking slot (the fragment mass and the transfer: nine
# exp-and-compare candidates, three logs, the rescale), each transcendental
# call counted as one operation
K5_OPS_PER_SLOT = 60
K5_OPS_PER_BREAKUP = 150
# substeps of config #2 captured for phase 13 (4.2 MB each: 16 exceed the L2)
K5_CAPTURED = 16


def k5_state(n, K, n_ext, ext_dtype, seed):
    """K5's inputs as numpy: multiplicities up to 2^40 with 5% dead slots and
    5% ties with the partner (K - o) mod n; radii log-uniform in 5-500 um;
    extensive rows signed water mass and, past the first, tracers;
    float32 rows of volume, radius and a monotone stand-in fall velocity"""
    import numpy as np

    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    radius = np.exp(rng.uniform(np.log(5e-6), np.log(500e-6), n))
    volume = 4 / 3 * np.pi * radius**3
    ext = np.concatenate([
        volume[None, :] * 1e3, rng.uniform(1e-18, 1e-16, (n_ext - 1, n))
    ]).astype(ext_dtype)
    attrs = {
        "volume": volume.astype(np.float32),
        "radius": radius.astype(np.float32),
        "relative fall velocity": (4 * (radius / 50e-6) ** 0.5).astype(
            np.float32
        ),
    }
    return mult, ext, attrs


def k5_function_sets():
    """config #2's functions (Geometric, Berry1967, ConstEb(1), Exponential)
    and a set that bounces and coalesces too (ConstantK, ConstEc(0.5),
    ConstEb(0.5), AlwaysN(4)); (kernel object, PairFunctions) each"""
    from pysdm_tpu_torch.dynamics.collisions import (
        breakup_efficiencies as be,
        breakup_fragmentations as bf,
        coalescence_efficiencies as ce,
        collision_kernels as ck,
    )
    from pysdm_tpu_torch.models.dejong_mackay_et_al_2023 import Settings0D
    from pysdm_tpu_torch.ops.cuda.breakup import PairFunctions

    s = Settings0D()
    constant = ck.ConstantK(a=1e-9)
    return {
        "config2": (s.kernel, PairFunctions.of(
            s.kernel, s.coal_eff, s.break_eff, s.fragmentation
        )),
        "mixed": (constant, PairFunctions.of(
            constant, ce.ConstEc(0.5), be.ConstEb(0.5), bf.AlwaysN(4)
        )),
    }


def k5_args(torch, state, kernel, functions, K, device):
    """the wrapper's arguments on ``device``, with a scale that gives the
    median pair about one expected collision"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda.breakup import required_rows

    mult, ext, attrs = state
    rows = {
        name: torch.from_numpy(attrs[name]).to(device)
        for name in required_rows(functions)
    }
    partner = torch.remainder(K - torch.arange(mult.shape[0], device=device), mult.shape[0])
    values = kernel.pairwise(None, rows, {k: v[partner] for k, v in rows.items()})
    scale = 1.0 / (
        np.median(mult[mult > 0]) * float(torch.median(values.float()))
    )
    return (
        torch.from_numpy(mult).to(device), torch.from_numpy(ext).to(device),
        0, rows, functions,
        torch.tensor([scale], dtype=torch.float32, device=device), K,
        2718281828, 2**63 // int(2e5),
    )


def compare_k5(got, want, processes, mult0, wm_index=0, require_changes=True):
    """kernel (or twin) ``got`` against ``want``: multiplicities equal at
    coalescing, bouncing and idle slots; at breakup slots, whose float32
    transfer runs through expf/logf/log1pf (a few ulps apart between two
    libms), equal on > 99.9% of all slots and within rel 1e-4 elsewhere
    (the JAX package's own bound, ``tests/unit/test_pallas_breakup.py``);
    extensive rows to rtol 1e-6 where the multiplicities agree; the five
    sums to rtol 1e-5 (another summation order); total water mass (row
    ``wm_index``) to 5e-6. With ``require_changes`` the update must touch
    5-95% of the slots and break some up (random states; a config #2
    substep may touch fewer). Returns (the largest absolute difference of
    the extensive rows, the number of multiplicities that differ)."""
    import numpy as np

    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in want]
    broke = processes["breakup"].cpu().numpy()
    same = got[0] == want[0]
    if not (same | broke).all():
        raise AssertionError("K5: a coalescing or bouncing slot differs")
    rel = np.abs(got[0] - want[0].astype(float)) / np.maximum(
        np.maximum(got[0], want[0]), 1
    )
    if not (same.mean() > 0.999 and rel.max() < 1e-4):
        raise AssertionError(
            f"K5: {int((~same).sum())} multiplicities differ, rel {rel.max()!r}"
        )
    changed = float((want[0] != mult0).mean())
    if require_changes and not (0.05 < changed < 0.95 and broke.any()):
        raise AssertionError(f"K5 touched {changed} of the slots")
    np.testing.assert_allclose(got[1][:, same], want[1][:, same], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    water = [
        float((m * e[wm_index].astype(float)).sum())
        for m, e in (got[:2], want[:2])
    ]
    np.testing.assert_allclose(water[0], water[1], rtol=5e-6)
    return float(np.abs(got[1].astype(float) - want[1]).max()), int((~same).sum())


def _k5_vs_twin(torch, k5, device, gpu):
    """phase 13: K5 against its twin on the card at 2^17 and 2^20 with both
    function sets; returns (max_abs_err, kernel_ms, twin_ms, bytes, ops) of
    the main path's shape (config #2's functions at 2^17, one float32
    extensive row)"""
    import numpy as np

    sets = k5_function_sets()
    out = None
    for n, name, n_ext, ext_dtype in (
        (BREAKUP_N, "config2", 1, np.float32),
        (BREAKUP_N, "mixed", 2, np.float64),
        (2**20, "config2", 2, np.float32),
        (2**20, "mixed", 1, np.float32),
    ):
        K = n // 3 * 2 + 1
        state = k5_state(n, K, n_ext, ext_dtype, seed=n + n_ext)
        kernel, functions = sets[name]
        args = k5_args(torch, state, kernel, functions, K, device)
        before = k5.coalesce_breakup_mirror.launches
        got = k5.coalesce_breakup_mirror(*args)
        torch.cuda.synchronize()
        if k5.coalesce_breakup_mirror.launches != before + 1:
            raise AssertionError("K5's counter did not count the launch")
        processes = {}
        want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
        err, n_diff = compare_k5(got, want, processes, state[0])
        n_break = int(processes["breakup"].sum())
        kernel_ms = _time_ms(torch, lambda: k5.coalesce_breakup_mirror(*args), 200)
        twin_ms = _time_ms(
            torch, lambda: k5.coalesce_breakup_mirror_reference(*args), 10
        )
        print(f"phase 13: K5 n={n} {name} n_ext={n_ext}"
              f" {np.dtype(ext_dtype).name}: {n_break} breakup slots,"
              f" {int(processes['coalescence'].sum())} coalescence slots,"
              f" {n_diff} multiplicities differ; ext max abs err {err!r};"
              f" kernel {kernel_ms!r} ms, plain twin {twin_ms!r} ms [{gpu}]")
        if out is None:
            # each input read once (mult 8, rows 4 each, attribute rows 4
            # each), each output written once (mult 8, rows 4 each)
            n_bytes = n * (8 + 4 * n_ext + 4 * len(args[3]) + 8 + 4 * n_ext)
            n_ops = n * K5_OPS_PER_SLOT + n_break * K5_OPS_PER_BREAKUP
            out = (err, kernel_ms, twin_ms, n_bytes, n_ops)
            main_args = args

    # the main shape over 16 random states of 4.2 MB each, together past
    # the 50 MB L2
    kernel, functions = sets["config2"]
    inputs = [main_args] + [
        k5_args(torch, k5_state(BREAKUP_N, K, 1, np.float32, seed), kernel,
                functions, K, device)
        for seed, K in enumerate(range(1001, 1016))
    ]
    check_deterministic(
        torch, k5.coalesce_breakup_mirror, inputs[:2], "phase 13: K5"
    )
    rotated_ms = _time_rotated_ms(
        torch, lambda a: k5.coalesce_breakup_mirror(*a), inputs, 200
    )
    print(f"phase 13: K5 n={BREAKUP_N} config2 over a rotation of"
          f" {len(inputs)} random states (device memory): {rotated_ms!r} ms"
          f" [{gpu}]")

    # the states config #2's main path hands K5
    captured = capture_k5_substeps(k5, K5_CAPTURED)
    err = out[0]
    counts = np.zeros(3, dtype=np.int64)
    for args in captured:
        got = k5.coalesce_breakup_mirror(*args)
        processes = {}
        want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
        e, _ = compare_k5(
            got, want, processes, args[0].cpu().numpy(), wm_index=args[2],
            require_changes=False,
        )
        err = max(err, e)
        counts += [
            int((want[0] != args[0]).sum()),
            int(processes["coalescence"].sum()),
            int(processes["breakup"].sum()),
        ]
    one_ms = _time_ms(torch, lambda: k5.coalesce_breakup_mirror(*captured[0]), 200)
    captured_ms = _time_rotated_ms(
        torch, lambda a: k5.coalesce_breakup_mirror(*a), captured, 200
    )
    print(f"phase 13: K5 on {len(captured)} substeps captured from config"
          f" #2's main path (2^17 slots each): within compare_k5's bounds of"
          f" the twin; per substep {counts[0] / len(captured)!r} slots"
          f" changed, {counts[1] / len(captured)!r} coalescence and"
          f" {counts[2] / len(captured)!r} breakup slots; kernel"
          f" {one_ms!r} ms on the first (in the L2), {captured_ms!r} ms over"
          f" the rotation [{gpu}]")
    return (err, *out[1:])


def capture_k5_substeps(k5, count):
    """the arguments of ``count`` K5 calls on config #2's main path
    (``build_breakup_box`` on the card, one step of warm-up first), cloned
    before each call"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics.collisions import collision

    p = build_breakup_box(BREAKUP_N, GPU)
    p.run(1)
    captured = []

    def record(mult, ext, wm_index, attrs, functions, scale, *rest):
        captured.append((
            mult.clone(), ext.clone(), wm_index,
            {name: row.clone() for name, row in attrs.items()}, functions,
            scale.clone(), *rest,
        ))
        return k5.coalesce_breakup_mirror(
            mult, ext, wm_index, attrs, functions, scale, *rest
        )

    with _replaced(collision, "coalesce_breakup_mirror", record):
        while len(captured) < count:
            p.run(1)
    p.block_until_ready()
    return captured[:count]


def build_breakup_box(n_sd, backend):
    """``bench.py``'s config #2 (``_bench_breakup``): Settings0D(seed=44),
    Collision(Geometric, Berry1967, ConstEb(1), Exponential, adaptive) on a
    Box of dv = 1 m^3, dt = 1 s"""
    from pysdm_tpu_torch import Builder
    from pysdm_tpu_torch.dynamics import Collision
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.models.dejong_mackay_et_al_2023 import Settings0D

    s = Settings0D(seed=44, warn_overflows=False)
    s.n_sd = n_sd
    builder = Builder(
        n_sd=n_sd, backend=backend(s.formulae), environment=Box(dv=s.dv, dt=s.dt)
    )
    builder.add_dynamic(Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
        adaptive=s.adaptive, warn_overflows=False,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def _breakup_main_path(k5, gpu):
    """phase 14: config #2 through ``bench.py``'s recipe on the card;
    returns K5's launches in the timed steps"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics.collisions import collision

    p = build_breakup_box(BREAKUP_N, GPU)
    mass0, count0 = _totals(p)
    p.run(1)
    p.block_until_ready()
    dyn = p.dynamics["Collision"]
    substeps0, reads0 = dyn.substeps_run, dyn.host_reads
    k5.coalesce_breakup_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(BREAKUP_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = k5.coalesce_breakup_mirror.launches
    substeps = dyn.substeps_run - substeps0
    if launches != substeps or substeps < BREAKUP_STEPS:
        raise AssertionError(f"{launches} K5 launches for {substeps} substeps")
    mass1, count1 = _totals(p)
    if abs(mass1 - mass0) > 1e-5 * mass0:
        raise AssertionError(f"phase 14: water mass {mass0} -> {mass1}")
    rates = {
        name: float(p.get_counter(name).sum())
        for name in ("collision_rate", "coalescence_rate", "breakup_rate",
                     "collision_rate_deficit", "breakup_rate_deficit")
    }
    if not (rates["coalescence_rate"] > 0 and rates["breakup_rate"] > 0):
        raise AssertionError(f"phase 14: rates {rates}")
    print(f"phase 14: breakup box (config #2) n_sd={BREAKUP_N}, adaptive,"
          f" {BREAKUP_STEPS} steps after one:"
          f" {BREAKUP_N / 2 * BREAKUP_STEPS / elapsed!r} pair-updates/s,"
          f" {elapsed / BREAKUP_STEPS * 1e3!r} ms/step, {launches} K5"
          f" launches = {substeps} substeps, host reads"
          f" {(dyn.host_reads - reads0) / BREAKUP_STEPS!r}/step; water mass"
          f" drift {(mass1 - mass0) / mass0!r}, droplets {count0!r} ->"
          f" {count1!r}; rates {rates} [{gpu}]")

    n_plain = 10
    times = []
    twin = _replaced(
        collision, "coalesce_breakup_mirror", k5.coalesce_breakup_mirror_reference
    )
    for context in (contextlib.nullcontext(), twin):
        with context:
            t0 = time.perf_counter()
            p.run(n_plain)
            p.block_until_ready()
            times.append((time.perf_counter() - t0) / n_plain * 1e3)
    print(f"phase 14: {n_plain} more steps: {times[0]!r} ms/step through K5,"
          f" {times[1]!r} ms/step with the plain twin in its place [{gpu}]")
    return launches


def _breakup_model(k5, gpu):
    """phase 15: config #2 through its model entry point,
    ``run_box_breakup(Settings0D(), backend_class=GPU)``, at the bench's
    2^17 super-droplets, spectra read at 0, 25, 50 and 100 s"""
    import numpy as np

    from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as model

    settings = model.Settings0D()
    settings.n_sd = BREAKUP_N
    settings._steps = [0, 25, 50, 100]
    k5.coalesce_breakup_mirror.launches = 0
    t0 = time.perf_counter()
    out = model.run_box_breakup(settings, return_nv=True)
    elapsed = time.perf_counter() - t0
    launches = k5.coalesce_breakup_mirror.launches
    core = out.core
    if core.device.type != "cuda":
        raise AssertionError(f"run_box_breakup built on {core.device}")
    substeps = core.dynamics["Collision"].substeps_run
    if launches != substeps or substeps < settings._steps[-1]:
        raise AssertionError(f"{launches} K5 launches for {substeps} substeps")
    if not (np.isfinite(out.y).all() and np.isfinite(out.y2).all()):
        raise AssertionError("run_box_breakup: non-finite spectrum")
    for name in ("dv/dlnr", "N(v)"):
        product = core.products[name]
        if not np.array_equal(product.get(), product.get()):
            raise AssertionError(f"run_box_breakup: {name} read twice differs")
    dlnr = np.diff(np.log(settings.radius_bins_edges))
    liquid = (out.y * dlnr).sum(axis=1)  # kg per m^3 of air under dv/dlnr
    drift = np.abs(liquid / liquid[0] - 1).max()
    collision, _, coalescence, breakup = out.rates[-1]
    if not (drift < 1e-4 and coalescence > 0 and breakup > 0):
        raise AssertionError(
            f"run_box_breakup: liquid {liquid}, rates {out.rates[-1]}"
        )
    print(f"phase 15: run_box_breakup(Settings0D(), backend_class=GPU) at"
          f" n_sd={BREAKUP_N}, {settings._steps[-1]} steps in {elapsed!r} s:"
          f" {launches} K5 launches; liquid under dv/dlnr {liquid.tolist()}"
          f" kg/m^3 (max drift {drift!r}); number"
          f" {(out.y2.sum(axis=1)).tolist()} m^-3; rates (collision,"
          f" deficit, coalescence, breakup) {out.rates[-1].tolist()} [{gpu}]")


# config #4, the Shipway and Hill 2012 1D column, at the JAX model's defaults
# (dz = 25 m, dt = 1 s, 3 km and a 625 m particle reservoir: 145 cells) with
# the warm rain's 2^12 super-droplets per cell
COLUMN_SD_PER_CELL = 2**12
COLUMN_BELOW_CLOUD_STEPS = 100
COLUMN_CLOUD_TIME = 400
COLUMN_BUDGET_STEPS = 30
COLUMN_IN_CLOUD_STEPS = 50


def shipway_hill(backend, products=None, **settings):
    """config #4 through the port's entry point; ``backend`` None takes
    ``Simulation``'s default (the card)"""
    from pysdm_tpu_torch.models import shipway_and_hill_2012 as model

    settings = model.Settings(**settings)
    kwargs = {} if backend is None else {"backend_class": backend}
    return settings, model.Simulation(settings, products=products, **kwargs)


def shipway_hill_published_profiles(backend):
    """the scenario of ``tests/smoke/test_kinematic_1d.py``
    ``test_shipway_hill_published_profile_bounds`` (the reference's
    ``test_few_steps.py``: 128 super-droplets per cell, dt = 30 s, dz =
    60 m, a 660 m reservoir, 50 steps, seed 44); returns the settings and
    each product's profile above z = 0, averaged over the last 10 steps
    and, but for the activation rate, smoothed over 5 cells"""
    import numpy as np
    from scipy.ndimage import uniform_filter1d

    from pysdm_tpu_torch import products
    from pysdm_tpu_torch.physics import si

    settings, simulation = shipway_hill(
        backend,
        products=(
            products.SuperDropletCountPerGridbox(name="sd_count"),
            products.PeakSaturation(name="peak saturation"),
            products.WaterMixingRatio(
                name="cloud water mixing ratio",
                radius_range=(1 * si.um, 50 * si.um),
            ),
            products.ActivatingRate(name="activating"),
            products.AmbientRelativeHumidity(name="RH"),
        ),
        n_sd_per_gridbox=128, dt=30 * si.s, dz=60 * si.m, precip=True,
        rho_times_w_1=2 * si.m / si.s, seed=44,
    )
    p = simulation.particulator
    p.run(40)
    # flush the reset-on-read accumulators (peak saturation, rates) so the
    # last-10-step statistics do not carry the spin-up transient
    for product in p.products.values():
        product.get()
    samples = {name: [] for name in p.products}
    for _ in range(10):
        p.run(1)
        for name, product in p.products.items():
            samples[name].append(np.asarray(product.get()).squeeze().copy())
    reservoir_cells = int(settings.particle_reservoir_depth // settings.dz)
    profiles = {}
    for name, values in samples.items():
        mean = np.mean(np.stack(values), axis=0)[reservoir_cells:]
        profiles[name] = (
            mean if name == "activating" else uniform_filter1d(mean, size=5)
        )
    return settings, profiles


def column_launches(p, run):
    """``run()`` with the launch counts of K2, K3 and K4 (and K4's rows)
    set to 0 just before and read just after, beside the collision
    substeps, the condensation solves and the host reads it took, and its
    seconds on the host clock"""
    from pysdm_tpu_torch.ops.cuda import collision, condensation, scan

    collision_dyn = p.dynamics["Collision"]
    solver = p.dynamics["Condensation"].solver
    before = (collision_dyn.substeps_run, solver.substep_solves, _host_reads(p))
    p.block_until_ready()
    collision.coalesce_adjacent.launches = 0
    condensation.masses_new.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    t0 = time.perf_counter()
    run()
    p.block_until_ready()
    seconds = time.perf_counter() - t0
    return {
        "coalesce_adjacent": collision.coalesce_adjacent.launches,
        "masses_new": condensation.masses_new.launches,
        "cumsum": scan.cumsum.launches,
        "cumsum rows": scan.cumsum.rows,
        "collision substeps": collision_dyn.substeps_run - before[0],
        "condensation solves": solver.substep_solves - before[1],
        "host reads": _host_reads(p) - before[2],
        "seconds": seconds,
    }


def _column_window(p, steps, label, gpu):
    """a timed window of the column's main path: launches checked against
    the substeps and solves, the end-to-end numbers printed"""
    counts = column_launches(p, lambda: p.run(steps))
    if (counts["coalesce_adjacent"] != counts["collision substeps"]
            or counts["collision substeps"] < steps):
        raise AssertionError(f"phase 16 {label}: {counts}")
    if (counts["masses_new"] != counts["condensation solves"]
            or counts["masses_new"] < steps or counts["cumsum"] == 0):
        raise AssertionError(f"phase 16 {label}: {counts}")
    wall = counts["seconds"]
    per_step = {
        k: v / steps for k, v in counts.items() if k != "seconds"
    }
    print(f"phase 16: column {label}, {steps} steps: {wall / steps * 1e3!r}"
          f" ms/step, {p.mesh.n_cell * steps / wall!r} grid points/s,"
          f" {p.n_sd * steps / wall!r} droplet-steps/s; per step {per_step};"
          f" displacement substeps up to"
          f" {int(p.get_counter('max_n_substeps_displacement')[0])} [{gpu}]")
    return counts


def _column_water(p):
    """vapour and liquid in the column, kg (float64), after checking
    multiplicities and masses"""
    import numpy as np

    return total_water(p) - float(np.sum(p.get_counter("precipitated_mass")))


def _column_kernels_vs_twins(p, gpu, label="phase 16"):
    """phase 16 at t = 400 s (and phase 22): one more step whose first K2
    substep, first K3 solve (where the column condenses) and first K4 scan
    of each dtype and rank are captured; on those inputs each kernel
    against its twin on the card at the bounds of phases 9, 10 and 8 (K2:
    xi equal, rows and rates to rtol 1e-6, also with the gamma draws scaled
    by 2^-30 so that pairs merge; K3: ``compare_k3_near_saturation``; K4:
    integers equal to torch.cumsum, floats within 1e-5 of the float64
    prefix of |x|). Returns the largest absolute differences to the
    twins"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops import segments
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan
    from pysdm_tpu_torch.ops.cuda.collision import coalesce_adjacent_reference

    captured = {"k2": [], "k3": [], "k4": {}}

    def cloned(args):
        return [a.clone() if torch.is_tensor(a) else a for a in args]

    def capture_k2(*args):
        if not captured["k2"]:
            captured["k2"].append(cloned(args))
        return real_k2(*args)

    def capture_k3(*args):
        if not captured["k3"]:
            captured["k3"].append(cloned(args))
        return real_k3(*args)

    def capture_k4(x):
        captured["k4"].setdefault((x.dtype, x.dim()), x.clone())
        return real_k4(x)

    # K3's wrapper counts its launches on the module's ``masses_new``
    capture_k3.launches = 0

    real_k2, real_k3, real_k4 = (
        collision.coalesce_adjacent, k3.masses_new, segments.cumsum
    )
    with contextlib.ExitStack() as stack:
        stack.enter_context(_replaced(collision, "coalesce_adjacent", capture_k2))
        stack.enter_context(_replaced(k3, "masses_new", capture_k3))
        stack.enter_context(_replaced(segments, "cumsum", capture_k4))
        p.run(1)
        p.block_until_ready()
    condenses = "Condensation" in p.dynamics
    if not (captured["k2"] and captured["k4"]
            and bool(captured["k3"]) == condenses):
        raise AssertionError(f"{label}: a kernel was not called: {captured}")

    # K2 on the column's first substep of that step
    mult, ext, kernnorm, rand, is_first = captured["k2"][0]
    k2_seen = {}
    for case, draws in (("as drawn", rand), ("draws x 2^-30", rand * 2**-30)):
        args = (mult, ext, kernnorm, draws, is_first)
        got = [x.cpu().numpy() for x in real_k2(*args)[:4]]
        want = [x.cpu().numpy() for x in coalesce_adjacent_reference(*args)[:4]]
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        k2_seen[case] = (
            int((got[0] != mult.cpu().numpy()).sum()),
            float(np.abs(got[1].astype(np.float64) - want[1]).max()),
        )
    if k2_seen["draws x 2^-30"][0] == 0:
        raise AssertionError(f"{label}: K2 merged no pair: {k2_seen}")
    print(f"{label}: K2 on a column substep ({mult.shape[0]} slots,"
          f" {int(is_first.sum())} pairs): xi equal to the twin, rows and"
          f" rates within rtol 1e-6; (slots changed, ext max abs err)"
          f" {k2_seen} [{gpu}]")

    # K3 on the column's first solve after t = 400 s
    k3_seen = {"mass": None}
    if condenses:
        formulae, settings, *rows = captured["k3"][0]

        def twin_of(rows):
            return k3.masses_new_reference(formulae, settings, *rows)

        k3_seen = compare_k3_near_saturation(
            formulae, settings, rows, real_k3(formulae, settings, *rows),
            twin_of,
        )
        active = int(
            (rows[9][rows[4].long()] & (rows[3] > 0) & (rows[0] > 0)).sum()
        )
        print(f"{label}: K3 on a column solve ({rows[0].shape[0]} drops in"
              f" {rows[5].shape[0]} cells, {active} of them active): success"
              f" equal to the twin's and every log-mass inside the twin's"
              f" interval for +-32 ulps of qv; largest differences"
              f" {k3_seen} [{gpu}]")

    # K4 on the column's scans, one of each dtype and rank
    k4_err = 0.0
    for (dtype, rank), x in captured["k4"].items():
        got = real_k4(x)
        if not x.is_floating_point():
            if not torch.equal(got, scan.cumsum_reference(x)):
                raise AssertionError(f"{label}: K4 {dtype} not exact")
            seen = "exact"
        else:
            exact = x.double().cumsum(-1)
            scale = x.double().abs().cumsum(-1)
            err = (got.double() - exact).abs()
            if not (err <= 1e-5 * scale).all():
                raise AssertionError(
                    f"{label}: K4 {dtype} rank {rank}: err {float(err.max())!r}"
                )
            twin = (scan.cumsum_reference(x).double() - exact).abs()
            k4_err = max(k4_err, float(err.max()))
            seen = (f"max abs err {float(err.max())!r} (torch.cumsum"
                    f" {float(twin.max())!r}) of a prefix up to"
                    f" {float(scale.max())!r}")
        print(f"{label}: K4 on a column scan {tuple(x.shape)} {dtype}: {seen}")
    return {"coalesce_adjacent": k2_seen["as drawn"][1],
            "masses_new": k3_seen["mass"], "cumsum": k4_err}


def _column_main_path(gpu):
    """phase 16: config #4 at full width through ``Simulation`` on the card;
    returns the launches of K2, K3 and K4 in the two timed windows and
    their largest differences to their twins on the column's inputs"""
    import numpy as np

    settings, simulation = shipway_hill(None, n_sd_per_gridbox=COLUMN_SD_PER_CELL)
    p = simulation.particulator
    if p.device.type != "cuda":
        raise AssertionError(f"Simulation built on {p.device}")
    if (p.mesh.n_cell, p.n_sd) != (145, 145 * COLUMN_SD_PER_CELL):
        raise AssertionError(f"{p.mesh.n_cell} cells, {p.n_sd} super-droplets")
    t0 = time.perf_counter()
    p.run(1)
    p.block_until_ready()
    print(f"phase 16: column (config #4) {p.mesh.n_cell} cells x"
          f" {COLUMN_SD_PER_CELL} ({p.n_sd} super-droplets), dt ="
          f" {settings.dt} s: first step {time.perf_counter() - t0!r} s")
    below = _column_window(p, COLUMN_BELOW_CLOUD_STEPS, "below cloud", gpu)
    p.run(int(COLUMN_CLOUD_TIME / settings.dt) - p.n_steps)

    first = {name: product.get() for name, product in p.products.items()}
    second = {name: product.get() for name, product in p.products.items()}
    qc = first["qc"]
    mult = p.attributes["multiplicity"]
    if not (qc.max() > 0.05e-3 and (qc > 1e-5).sum() >= 10
            and first["S_max"].max() > 0
            and p.get_counter("condensation_success").all()
            and (mult >= 0).all()):
        raise AssertionError(
            f"no cloud at t = {COLUMN_CLOUD_TIME} s: qc max {qc.max()}, cells"
            f" above 1e-5 {(qc > 1e-5).sum()}, S_max {first['S_max'].max()}"
        )
    # the reads reduce in a fixed order: a second read of the same state is
    # bit-equal, but for the two products that reset their counter on read
    for name, value in first.items():
        expected = {"S_max": np.full_like(value, -1.0),
                    "surf_precip": np.zeros_like(value)}.get(name, value)
        if not (np.isfinite(value).all()
                and np.array_equal(second[name], expected)):
            raise AssertionError(f"phase 16: {name} read twice: {value}, {second[name]}")
        print(f"phase 16: t = {COLUMN_CLOUD_TIME} s, {name}: shape"
              f" {value.shape}, min {float(value.min())!r}, max"
              f" {float(value.max())!r}")
    print(f"phase 16: cloud at t = {COLUMN_CLOUD_TIME} s: qc max"
          f" {float(qc.max()) * 1e3!r} g/kg, {int((qc > 1e-5).sum())} cells"
          f" above 1e-5 kg/kg, S_max {float(first['S_max'].max())!r}; every"
          f" product read twice bit-equal")
    errors = _column_kernels_vs_twins(p, gpu)

    # the water budget over the first steps of the cloud: the column is
    # open, MPDATA's extrapolated bounds let vapour in at the bottom and
    # out at the top (about 2% of the column's water over 30 steps at the
    # updraft's peak), hence 5% as in tests/smoke/test_kinematic_1d.py
    water0, precipitated = _column_water(p), 0.0
    for _ in range(COLUMN_BUDGET_STEPS):
        p.run(1)
        precipitated += float(np.sum(p.get_counter("precipitated_mass")))
    drift = (_column_water(p) + precipitated - water0) / water0
    if not abs(drift) < 0.05:
        raise AssertionError(f"column water drifted by {drift}")
    print(f"phase 16: water budget over {COLUMN_BUDGET_STEPS} steps in cloud:"
          f" drift {drift!r}, precipitated {precipitated!r} kg")

    cloud = _column_window(p, COLUMN_IN_CLOUD_STEPS, "in cloud", gpu)
    if not (p.get_counter("condensation_success").all()
            and (p.attributes["multiplicity"] >= 0).all()):
        raise AssertionError("phase 16: condensation failed in cloud")
    launches = {k: below[k] + cloud[k]
                for k in ("coalesce_adjacent", "masses_new", "cumsum")}
    return launches, errors


def _column_published_on_card(gpu):
    """phase 17: the published-profile scenario on the card, float32, with
    the bounds of ``tests/smoke/test_torch_shipway_hill.py``"""
    settings, profiles = shipway_hill_published_profiles(None)
    n = settings.n_sd_per_gridbox
    sd, peak = profiles["sd_count"], profiles["peak saturation"]
    qc = profiles["cloud water mixing ratio"] * 1e3  # g/kg
    activating = profiles["activating"]
    print(f"phase 17: published-profile scenario on the card: super-droplets"
          f" per cell {float(sd.min())!r}-{float(sd.max())!r}, peak"
          f" saturation max {float(peak.max())!r}, qc"
          f" {float(qc.min())!r}-{float(qc.max())!r} g/kg, activating max"
          f" {float(activating.max())!r} [{gpu}]")
    if not (0.5 * n < sd.min() < 1.5 * n and 0.5 * n < sd.max() < 1.5 * n
            and 1.0001 < peak.max() < 1.001
            and qc.min() < 1e-10 and 0.1 < qc.max() < 0.4
            and activating.max() == 0):
        raise AssertionError("phase 17: a published-profile bound failed")


# -- slice 8: the coalescence-only box models -------------------------------
# Bulenok 2023's mean mass after 64 steps against eq. 13, as a factor either
# way: on the CPU at 2^10 super-droplets the port ends 3.49x and the JAX
# package 4.75x above it (the Monte-Carlo spread at large multiplicities;
# tests/smoke/test_srivastava_1982.py's own run, total number 1e6, ends 10%
# below), hence 5
BULENOK_FACTOR = 5.0
BULENOK_STEPS = 64
BULENOK_N_SDS = (2**17, 2**20)
# de Jong and Azimi's column at full width (Settings1D's defaults: dz =
# 25 m, z_max 3 km and the 625 m reservoir, 145 cells) with the column's
# 2^12 super-droplets per cell
DEJONG_COLUMN_STEPS = 300


def k1_geometric_args(torch, n, kernel_id, ext_dtype, seed, device):
    """K1's arguments on ``_random_state``'s state with the attribute rows
    of a geometric kernel (radii of the volumes, fall velocities of 0-8
    m/s, areas of the radii) and a scale that gives the median pair about
    one expected collision"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda.collision import (
        GEOMETRIC,
        KERNEL_ROWS,
        kernel_value,
    )

    K = (n // 3) * 2
    mult, ext, volume = _random_state(torch, n, K, ext_dtype, seed, device)
    rng = np.random.default_rng(seed + 1)
    radius = (volume.double() * 3 / 4 / np.pi) ** (1 / 3)
    rows = {
        "radius": radius,
        "relative fall velocity": torch.from_numpy(
            rng.uniform(0.0, 8.0, n)
        ).to(device),
        "area": 4 * np.pi * radius**2,
    }
    attr = torch.stack(
        [rows[name].float() for name in KERNEL_ROWS[kernel_id]]
    ).contiguous()
    params = (np.pi * 0.8, 0.0) if kernel_id == GEOMETRIC else (2e3, 0.0)
    named = dict(zip(KERNEL_ROWS[kernel_id], attr))
    partner = torch.remainder(K - torch.arange(n, device=device), n)
    values = kernel_value(
        kernel_id, *params, named, {k: v[partner] for k, v in named.items()}
    )
    alive = mult[mult > 0].double()
    scale = 1.0 / float(alive.median() * values.double().median())
    return (mult, ext, attr, kernel_id, params,
            torch.tensor([scale], dtype=torch.float32, device=device), K,
            2718281828)


def _k1_geometric_vs_twin(torch, kern, device, gpu):
    """phase 18: K1 with Geometric and SimpleGeometric against its twin on
    the card at 2^16 and 2^20 (multiplicities exactly, rows to rtol 1e-6,
    rate sums to 1e-5), three launches and two streams bit-equal, then
    Geometric's device time at 2^20 on one input and over a rotation of
    four; returns (max_abs_err, ms, rotated ms, bytes)"""
    import numpy as np

    max_abs_err = 0.0
    for kernel_id, name in ((kern.GEOMETRIC, "Geometric"),
                            (kern.SIMPLE_GEOMETRIC, "SimpleGeometric")):
        for n, ext_dtype in ((2**16, np.float64), (N_MAIN, np.float32)):
            args = k1_geometric_args(torch, n, kernel_id, ext_dtype, n, device)
            mult = args[0]
            before = kern.coalesce_mirror.launches
            got = kern.coalesce_mirror(*args)
            torch.cuda.synchronize()
            if kern.coalesce_mirror.launches != before + 1:
                raise AssertionError("K1's counter did not count the launch")
            want = kern.coalesce_mirror_reference(*args)
            got = [x.cpu().numpy() for x in got]
            want = [x.cpu().numpy() for x in want]
            np.testing.assert_array_equal(got[0], want[0])
            changed = float((got[0] != mult.cpu().numpy()).mean())
            if not 0.05 < changed < 0.95:
                raise AssertionError(f"phase 18: {name} touched {changed}")
            rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
            np.testing.assert_allclose(got[1], want[1], rtol=rtol)
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=1e-5)
            err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
            max_abs_err = max(max_abs_err, err)
            print(f"phase 18: K1 {name} n={n} ext={np.dtype(ext_dtype).name}:"
                  f" xi equal ({changed!r} of the slots changed), ext max abs"
                  f" err {err!r}, rates {got[2:]} vs {want[2:]}")
    args = k1_geometric_args(torch, N_MAIN, kern.GEOMETRIC, np.float32, 7, device)
    inputs = [args] + [
        k1_geometric_args(torch, N_MAIN, kern.GEOMETRIC, np.float32, s, device)
        for s in (11, 12, 13)
    ]
    check_deterministic(torch, kern.coalesce_mirror, inputs[:2], "phase 18: K1")
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_mirror(*args), 200)
    rotated_ms = _time_rotated_ms(
        torch, lambda a: kern.coalesce_mirror(*a), inputs, 200
    )
    # each input read once, each output written once: mult 8, two float32
    # rows 8, two attribute rows 8 in; mult 8, rows 8 out
    n_bytes = N_MAIN * (8 + 8 + 8 + 8 + 8)
    print(f"phase 18: K1 Geometric n={N_MAIN}: kernel {kernel_ms!r} ms on one"
          f" input (in the L2), {rotated_ms!r} ms over a rotation of"
          f" {len(inputs)} inputs; bound {bound_ms(n_bytes)[0]!r} ms"
          f" ({n_bytes / N_MAIN:.0f} B/slot) [{gpu}]")
    return max_abs_err, kernel_ms, rotated_ms, n_bytes


@contextlib.contextmanager
def _capturing_builder(model):
    """``model.Builder`` replaced by a subclass that keeps every
    particulator it builds and its liquid water at the build (in the
    yielded list, as pairs)"""
    built = []
    base = model.Builder

    class Capturing(base):
        def build(self, *args, **kwargs):
            p = super().build(*args, **kwargs)
            built.append((p, _totals(p)[0]))
            return p

    with _replaced(model, "Builder", Capturing):
        yield built


def _shima_model(kern, gpu):
    """phase 19: ``shima_et_al_2009.run`` at 2^20 on the card: dv/dlnr
    against the Golovin solution at t = 1200 s, mass under the spectrum and
    liquid mass conserved, K1 launches = substeps, ``WallTime`` inside the
    host clock around the call"""
    import numpy as np

    from pysdm_tpu_torch.models import shima_et_al_2009 as model

    settings = model.Settings()
    settings.n_sd = N_MAIN
    with _capturing_builder(model) as built:
        kern.coalesce_mirror.launches = 0
        t0 = time.perf_counter()
        vals, wall_time = model.run(settings)
        host = time.perf_counter() - t0
    p, liquid0 = built[0]
    if p.device.type != "cuda":
        raise AssertionError(f"shima_et_al_2009.run built on {p.device}")
    substeps = p.dynamics["Collision"].substeps_run
    launches = kern.coalesce_mirror.launches
    if launches != substeps or substeps != settings.output_steps[-1]:
        raise AssertionError(f"phase 19: {launches} K1 launches, {substeps} substeps")
    if not 0 < wall_time <= host:
        raise AssertionError(f"phase 19: wall time {wall_time} s, host {host} s")
    r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
    analytic = model.golovin_analytic_dvdlnr(
        r_mid, 1200.0, b=1.5e3, x_0=settings.X0, n_part=settings.n_part,
        rho=settings.rho,
    )
    rmse = float(np.sqrt(np.mean(((vals[1200] - analytic) / analytic.max()) ** 2)))
    dlnr = np.diff(np.log(settings.radius_bins_edges))
    spectrum_mass = [float((vals[s] * dlnr).sum()) for s in settings.output_steps]
    liquid1 = _totals(p)[0]
    drift = abs(liquid1 - liquid0) / liquid0
    if not (rmse < 0.15 and np.isfinite(vals[3600]).all()
            and abs(spectrum_mass[1] / spectrum_mass[0] - 1) < 5e-2
            and drift < 1e-6):
        raise AssertionError(
            f"phase 19: rmse {rmse}, spectrum mass {spectrum_mass}, liquid"
            f" {liquid0} -> {liquid1}"
        )
    print(f"phase 19: shima_et_al_2009.run at n_sd={N_MAIN} on the card:"
          f" {substeps} steps, {launches} K1 launches, wall time"
          f" {wall_time!r} s (host clock around the call {host!r} s,"
          f" {N_MAIN / 2 * substeps / wall_time!r} pair-updates/s); dv/dlnr"
          f" rmse against Golovin at t = 1200 s {rmse!r} (bound 0.15); mass"
          f" under the spectrum {spectrum_mass} kg/m^3; liquid drift"
          f" {drift!r} [{gpu}]")


def _box_model_entry_points(kern, gpu):
    """phase 19, after the 2^20 run: the two other entry points over K1 at
    their own defaults on the card, with the JAX package's test bounds:
    ``dejong_azimi.run_box(Settings0D())`` (2^12, adaptive; the number
    falls, the Cloudy.jl comparison's M0 at t = 0 within 2% and at 60 and
    120 s within 50%, the volume conserved to 1e-5, float32 masses) and
    ``bartman_2020_fig_4`` (2^13, dt = 1 s, 10 s and adaptive at 10 s; the
    adaptive run's spectrum at 3600 s no further from dt = 1 s's than 1.25
    times the fixed 10 s run's)"""
    import numpy as np

    from pysdm_tpu_torch.models import dejong_azimi, thesis_benchmarks

    kern.coalesce_mirror.launches = 0
    out = dejong_azimi.run_box(dejong_azimi.Settings0D())
    m0, m1 = out.moments[:, 0], out.moments[:, 1]
    analytic_m0 = np.array([100.0, 4.863406413211965, 0.23652721940076313]) * 1e6
    if not (kern.coalesce_mirror.launches >= 120 and m0[0] > m0[-1]
            and abs(m0[0] / analytic_m0[0] - 1) < 0.02
            and (np.abs(m0[1:] / analytic_m0[1:] - 1) < 0.5).all()
            and np.abs(m1 / m1[0] - 1).max() < 1e-5):
        raise AssertionError(f"phase 19: run_box moments {out.moments}")
    print(f"phase 19: dejong_azimi.run_box(Settings0D()) on the card:"
          f" {kern.coalesce_mirror.launches} K1 launches; M0"
          f" {m0.tolist()} m^-3 (Cloudy.jl's Golovin {analytic_m0.tolist()}),"
          f" M1 drift {float(np.abs(m1 / m1[0] - 1).max())!r} [{gpu}]")
    kern.coalesce_mirror.launches = 0
    runs = thesis_benchmarks.bartman_2020_fig_4(dts=(1.0, 10.0, "adaptive"))
    n_sd = 2**13
    dt1, dt10, adaptive = (runs[(n_sd, dt)][0] for dt in (1.0, 10.0, "adaptive"))
    last10 = max(dt10)
    reference = dt1[max(dt1)]
    err_adaptive = float(np.abs(adaptive[last10] - reference).sum())
    err_fixed = float(np.abs(dt10[last10] - reference).sum())
    if not err_adaptive <= 1.25 * err_fixed:
        raise AssertionError(f"phase 19: bartman {err_adaptive} {err_fixed}")
    print(f"phase 19: bartman_2020_fig_4 on the card at {n_sd}:"
          f" {kern.coalesce_mirror.launches} K1 launches; distance to dt ="
          f" 1 s at 3600 s: adaptive {err_adaptive!r}, fixed 10 s"
          f" {err_fixed!r}; wall times"
          f" {[runs[(n_sd, dt)][1] for dt in (1.0, 10.0, 'adaptive')]} s"
          f" [{gpu}]")


def _berry_model(kern, gpu):
    """phase 20: ``berry_1967.run`` at 2^20 on the card (Geometric on K1,
    Gunn-Kinzer fall velocities): the mean radius grows, liquid conserved,
    K1 launches = substeps; then one substep captured and K1 held against
    its twin on it. Returns the launches"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.models import berry_1967 as model

    settings = model.Settings(steps=[0, 200, 400, 600])
    settings.n_sd = N_MAIN
    with _capturing_builder(model) as built:
        kern.coalesce_mirror.launches = 0
        t0 = time.perf_counter()
        vals, p = model.run(settings)
        p.block_until_ready()
        host = time.perf_counter() - t0
    launches = kern.coalesce_mirror.launches
    substeps = p.dynamics["Collision"].substeps_run
    liquid0 = built[0][1]
    if p.device.type != "cuda" or built[0][0] is not p:
        raise AssertionError(f"berry_1967.run built on {p.device}")
    if launches != substeps or substeps != settings.output_steps[-1]:
        raise AssertionError(f"phase 20: {launches} K1 launches, {substeps} substeps")
    r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
    mean_r = [float((vals[s] * r_mid).sum() / vals[s].sum())
              for s in settings.output_steps]
    liquid1 = _totals(p)[0]
    if abs(liquid1 - liquid0) > 1e-6 * liquid0:
        raise AssertionError(f"phase 20: liquid {liquid0} -> {liquid1}")

    captured = []

    def record(*args):
        captured.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return kern.coalesce_mirror(*args)

    with _replaced(collision, "coalesce_mirror", record):
        p.run(1)
    liquid2 = _totals(p)[0]
    args = captured[0]
    got = [x.cpu().numpy() for x in kern.coalesce_mirror(*args)]
    want = [x.cpu().numpy() for x in kern.coalesce_mirror_reference(*args)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    changed = int((got[0] != args[0].cpu().numpy()).sum())
    drift = abs(liquid2 - liquid1) / liquid1
    if not (mean_r[-1] > mean_r[0] and changed > 0 and drift < 1e-6
            and args[3] == kern.GEOMETRIC):
        raise AssertionError(
            f"phase 20: mean radius {mean_r}, {changed} slots changed, liquid"
            f" {liquid1} -> {liquid2}"
        )
    err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
    print(f"phase 20: berry_1967.run at n_sd={N_MAIN} on the card:"
          f" {substeps} steps in {host!r} s, {launches} K1 launches"
          f" (Geometric); number-weighted mean radius of dv/dlnr {mean_r} m;"
          f" on a captured substep K1 xi equal to the twin ({changed} slots"
          f" changed), ext max abs err {err!r}; liquid drift over it"
          f" {drift!r} [{gpu}]")
    return launches


def _bulenok_model(k5, gpu):
    """phase 21: ``bulenok_2023_benchmark`` at 2^17 and 2^20, 64 steps, on
    the card (K5): pair-updates/s, the final mean mass within
    BULENOK_FACTOR of eq. 13, multiplicities >= 0, K5 launches = substeps;
    K5 against its twin on the 2^20 run's 32nd substep. Returns K5's
    launches"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.models import srivastava_1982, thesis_benchmarks

    captured = []

    def record(*args):
        if len(captured) < 32:
            captured.append(
                [a.clone() if torch.is_tensor(a) else
                 {k: v.clone() for k, v in a.items()} if isinstance(a, dict)
                 else a for a in args]
            )
        return k5.coalesce_breakup_mirror(*args)

    launches = 0
    for n_sd in BULENOK_N_SDS:
        with _capturing_builder(srivastava_1982) as built, contextlib.ExitStack() as stack:
            if n_sd == BULENOK_N_SDS[-1]:
                stack.enter_context(
                    _replaced(collision, "coalesce_breakup_mirror", record)
                )
            k5.coalesce_breakup_mirror.launches = 0
            result = thesis_benchmarks.bulenok_2023_benchmark(
                n_sds=(n_sd,), n_steps=BULENOK_STEPS
            )[n_sd]
        p = built[0][0]
        substeps = p.dynamics["Collision"].substeps_run
        count = k5.coalesce_breakup_mirror.launches
        ratio = result["mean_mass_final"] / result["analytic_final"]
        mult = p.attributes["multiplicity"]
        if (p.device.type != "cuda" or count != substeps
                or substeps != BULENOK_STEPS or (mult < 0).any()
                or not 1 / BULENOK_FACTOR < ratio < BULENOK_FACTOR):
            raise AssertionError(
                f"phase 21: n_sd={n_sd} on {p.device}: {count} K5 launches,"
                f" {substeps} substeps, mean mass {result}"
            )
        launches += count
        rates = {name: float(p.get_counter(name).sum())
                 for name in ("coalescence_rate", "breakup_rate",
                              "breakup_rate_deficit", "collision_rate_deficit")}
        print(f"phase 21: bulenok_2023_benchmark n_sd={n_sd}, {BULENOK_STEPS}"
              f" steps: {result['pair_updates_per_s']!r} pair-updates/s,"
              f" {result['wall_time']!r} s; mean mass / fragment mass"
              f" {result['mean_mass_final']!r} against eq. 13's"
              f" {result['analytic_final']!r} (ratio {ratio!r}, bound"
              f" {BULENOK_FACTOR}); {count} K5 launches; multiplicity max"
              f" {int(mult.max())}; rates {rates} [{gpu}]")
    args = captured[-1]
    got = k5.coalesce_breakup_mirror(*args)
    processes = {}
    want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
    err, n_diff = compare_k5(
        got, want, processes, args[0].cpu().numpy(), wm_index=args[2],
        require_changes=False,
    )
    print(f"phase 21: K5 on the 2^20 run's substep {len(captured)}: within"
          f" compare_k5's bounds of the twin; {int(processes['coalescence'].sum())}"
          f" coalescence and {int(processes['breakup'].sum())} breakup slots,"
          f" {n_diff} multiplicities differ, ext max abs err {err!r} [{gpu}]")
    return launches


def _column_products(products):
    """every liquid-phase product that applies to a column whose particles
    carry no aerosol (no activation filter, no condensation)"""
    import numpy as np

    from pysdm_tpu_torch.physics import si

    bins = np.logspace(np.log10(1 * si.um), np.log10(5e3 * si.um), num=65)
    cloud = (1 * si.um, np.inf)
    return (
        products.ParticleVolumeVersusRadiusLogarithmSpectrum(bins, name="dv/dlnr"),
        products.NumberSizeSpectrum(bins, name="N(r)"),
        products.ParticleSizeSpectrumPerVolume(bins, name="dN/dr"),
        products.ParticleSizeSpectrumPerMassOfDryAir(bins, name="dN/dr/rhod"),
        products.RadiusBinnedNumberAveragedTerminalVelocity(bins, name="vt(r)"),
        products.TotalParticleConcentration(name="N"),
        products.TotalParticleSpecificConcentration(name="n"),
        products.ParticleConcentration(radius_range=(50 * si.um, np.inf), name="N rain"),
        products.ParticleSpecificConcentration(radius_range=cloud, name="n cloud"),
        products.MeanRadius(name="mean r"),
        products.MeanVolumeRadius(name="mean volume r"),
        products.EffectiveRadius(name="reff"),
        products.RadiusStandardDeviation(name="sd r"),
        products.AreaStandardDeviation(name="sd area"),
        products.VolumeStandardDeviation(name="sd v"),
        products.WaterMixingRatio(name="qc", radius_range=cloud),
        products.CloudWaterContent(name="cwc"),
        products.SpecificCloudWaterContent(name="scwc"),
        products.LiquidWaterContent(name="lwc"),
        products.SpecificLiquidWaterContent(name="slwc"),
        products.ZerothMoment(name="M0"),
        products.VolumeFirstMoment(name="M1"),
        products.VolumeSecondMoment(name="M2"),
        products.RadiusFirstMoment(name="R1"),
        products.RadiusSixthMoment(name="R6"),
        products.SuperDropletCountPerGridbox(name="sd count"),
        products.Time(name="time"),
        products.CollisionTimestepMin(name="dt coll min"),
        products.CollisionTimestepMean(name="dt coll mean"),
        products.CoalescenceRatePerGridbox(name="coalescence rate"),
        products.AmbientTemperature(name="T"),
        products.AmbientPressure(name="p"),
        products.AmbientRelativeHumidity(name="RH"),
        products.AmbientRelativeHumidityWrtIce(name="RH ice"),
        products.AmbientDryAirDensity(name="rhod"),
        products.AmbientDryAirPotentialTemperature(name="thd"),
        products.AmbientWaterVapourMixingRatio(name="qv"),
        products.MaxCourantNumber(name="max courant"),
        products.FlowVelocityComponent(0, name="w"),
        products.AveragedTerminalVelocity(name="vt", radius_range=cloud),
        products.SurfacePrecipitation(name="surf_precip"),
    )


# products that read and reset a counter: a second read right after the
# first sees what accumulated in between, nothing
_RESET_ON_READ = ("dt coll mean", "coalescence rate", "surf_precip")


def _dejong_column(gpu):
    """phase 22: de Jong and Azimi's ``Settings1D`` through the port's
    column ``Simulation`` at full width on the card (K2, K4): 300 steps,
    pairs merging, liquid conserved with the precipitation counted; K2 and
    K4 held against their twins on one captured substep and scan; every
    applicable product read twice. Returns the launches of K2 and K4"""
    import numpy as np

    from pysdm_tpu_torch import products
    from pysdm_tpu_torch.models import dejong_azimi
    from pysdm_tpu_torch.models.shipway_and_hill_2012 import Simulation
    from pysdm_tpu_torch.ops.cuda import collision, scan

    settings = dejong_azimi.Settings1D(n_sd_per_gridbox=COLUMN_SD_PER_CELL)
    p = Simulation(settings, products=_column_products(products)).particulator
    if p.device.type != "cuda" or "Condensation" in p.dynamics:
        raise AssertionError(f"phase 22: on {p.device}, {list(p.dynamics)}")
    if (p.mesh.n_cell, p.n_sd) != (145, 145 * COLUMN_SD_PER_CELL):
        raise AssertionError(f"{p.mesh.n_cell} cells, {p.n_sd} super-droplets")
    liquid0, count0 = _totals(p)
    dyn = p.dynamics["Collision"]
    substeps0 = dyn.substeps_run
    collision.coalesce_adjacent.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    precipitated = 0.0
    t0 = time.perf_counter()
    for _ in range(DEJONG_COLUMN_STEPS):
        p.run(1)
        precipitated += float(np.sum(p.get_counter("precipitated_mass")))
    p.block_until_ready()
    wall = time.perf_counter() - t0
    substeps = dyn.substeps_run - substeps0
    k2 = collision.coalesce_adjacent.launches
    k4, k4_rows = scan.cumsum.launches, scan.cumsum.rows
    liquid1, count1 = _totals(p)
    first = {name: product.get() for name, product in p.products.items()}
    second = {name: product.get() for name, product in p.products.items()}
    coalescence = float(first["coalescence rate"].sum())
    drift = (liquid1 + precipitated - liquid0) / liquid0
    # float32 masses on the card: each merge rounds e_k + gamma e_j once
    if not (k2 == substeps >= DEJONG_COLUMN_STEPS and k4 > 0
            and coalescence > 0 and count1 < count0 and abs(drift) < 1e-5):
        raise AssertionError(
            f"phase 22: K2 {k2}, substeps {substeps}, K4 {k4}, coalescence"
            f" {coalescence}, droplets {count0} -> {count1}, liquid drift {drift}"
        )
    for name, value in first.items():
        expected = np.zeros_like(value) if name in _RESET_ON_READ else value
        if name == "dt coll mean":
            expected = np.full_like(value, np.nan)
        if name == "dt coll min":
            # its counter was reset by the first read of "dt coll mean"
            expected = np.full_like(value, settings.dt)
        if not np.array_equal(second[name], expected, equal_nan=True):
            raise AssertionError(f"phase 22: {name} read twice: {value}, {second[name]}")
        if not np.isfinite(value).any():
            raise AssertionError(f"phase 22: {name} not finite: {value}")
    print(f"phase 22: de Jong-Azimi column {p.mesh.n_cell} cells x"
          f" {COLUMN_SD_PER_CELL}, {DEJONG_COLUMN_STEPS} steps in {wall!r} s"
          f" ({wall / DEJONG_COLUMN_STEPS * 1e3!r} ms/step,"
          f" {p.n_sd * DEJONG_COLUMN_STEPS / wall!r} droplet-steps/s):"
          f" {substeps} collision substeps = {k2} K2 launches, {k4} K4"
          f" launches of {k4_rows} rows; coalescence rate"
          f" {coalescence!r} since t = 0; droplets {count0!r} -> {count1!r};"
          f" liquid drift {drift!r} with {precipitated!r} kg precipitated;"
          f" {len(first)} products read twice, bit-equal but for the"
          f" {len(_RESET_ON_READ)} that reset on read [{gpu}]")
    for name in ("N", "mean r", "reff", "slwc", "max courant", "w"):
        value = first[name]
        print(f"phase 22: {name}: shape {value.shape}, min"
              f" {float(np.nanmin(value))!r}, max {float(np.nanmax(value))!r}")
    _column_kernels_vs_twins(p, gpu, label="phase 22")
    return {"coalesce_adjacent": k2, "cumsum": k4}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.ops.cuda import _build
    from pysdm_tpu_torch.ops.cuda import breakup as k5
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" python {sys.version.split()[0]}")
    nvcc = _build.nvcc_path()
    print(f"nvcc {nvcc}: {_nvcc_version(nvcc)}")
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as err:
        print(f"triton does not import: {err}")

    # every kernel is built anew from its source, all nvcc runs at once
    sources = (
        "collision_mirror", "condensation", "scan", "collision_adjacent",
        "collision_breakup",
    )
    for name in sources:
        _build.library_path(name)[1].unlink(missing_ok=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        loaders = (
            kern.library, k3.library, scan.library, kern.library_adjacent,
            k5.library,
        )
        for future in [pool.submit(load) for load in loaders]:
            future.result()
    print(f"phase 1: built {', '.join(sources)} in"
          f" {time.perf_counter() - t0!r} s")

    device = torch.device("cuda")
    max_abs_err, kernel_ms, twin_ms = _kernel_vs_twin(torch, kern, device, gpu)
    launches = _main_path(torch, kern, gpu)
    _adaptive(kern, gpu)
    k3_err, k3_times, k3_counts = _k3_vs_twin(torch, k3, device, gpu)
    k3_launches, _ = _parcel_main_path(k3, gpu)
    _parcel_gpu_vs_cpu(k3)
    k4_err, k4_ms, k4_twin_ms, k4_n = _k4_vs_twin(torch, scan, device, gpu)
    k2_err, k2_ms, k2_twin_ms, k2_bytes = _k2_vs_twin(torch, kern, device, gpu)
    warm_launches, p, _ = _warm_rain_main_path(kern, k3, scan, gpu)
    k3_err = max(k3_err, _k3_on_a_warm_rain_solve(torch, p, k3, gpu))
    _percell_sums_vs_float64(p)
    _warm_rain_with_twins(p, gpu)
    del p
    _warm_rain_scenario_on_card(gpu)
    k5_err, k5_ms, k5_twin_ms, k5_bytes, k5_ops = _k5_vs_twin(
        torch, k5, device, gpu
    )
    k5_launches = _breakup_main_path(k5, gpu)
    _breakup_model(k5, gpu)
    column, column_err = _column_main_path(gpu)
    _column_published_on_card(gpu)
    geo_err, geo_ms, geo_rotated_ms, geo_bytes = _k1_geometric_vs_twin(
        torch, kern, device, gpu
    )
    _shima_model(kern, gpu)
    _box_model_entry_points(kern, gpu)
    berry_launches = _berry_model(kern, gpu)
    bulenok_launches = _bulenok_model(k5, gpu)
    dejong = _dejong_column(gpu)

    # least times on the card, from this run's inputs: K1 at N_MAIN with two
    # float32 rows (mult 8 + rows 8 + volume 4 in, mult 8 + rows 8 out per
    # slot); K3 at N_PARCEL (24 B in, 5 B out per drop; its operations from
    # the minfun evaluations these drops need); K4 float32 (4 B in, 4 out)
    k1_bound = bound_ms(N_MAIN * 36)
    k3_bound = bound_ms(
        N_PARCEL * 29, k3_counts[N_PARCEL] * K3_OPS_PER_MINFUN
    )
    k4_bound = bound_ms(k4_n * 8)
    k2_bound = bound_ms(k2_bytes)
    k5_bound = bound_ms(k5_bytes, k5_ops)
    geo_bound = bound_ms(geo_bytes)

    print(json.dumps({"kernels": [{
        "name": "coalesce_mirror",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_mirror.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:582",
        "launches": launches,
        "berry_launches": berry_launches,
        "max_abs_err": max_abs_err,
        "geometric_max_abs_err": geo_err,
        "ms": kernel_ms,
        "geometric_ms": geo_ms,
        "geometric_rotated_ms": geo_rotated_ms,
        "plain_ms": twin_ms,
        "bound_ms": k1_bound[0],
        "geometric_bound_ms": geo_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "masses_new",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/condensation.cu",
        "replaces": "pysdm_tpu/ops/pallas/condensation.py:299",
        "launches": k3_launches,
        "column_launches": column["masses_new"],
        "column_max_abs_err": column_err["masses_new"],
        "max_abs_err": k3_err,
        "ms": k3_times[N_PARCEL][0],
        "plain_ms": k3_times[N_PARCEL][1],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }, {
        "name": "coalesce_adjacent",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_adjacent.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:721",
        "launches": warm_launches["coalesce_adjacent"],
        "column_launches": column["coalesce_adjacent"],
        "dejong_column_launches": dejong["coalesce_adjacent"],
        "column_max_abs_err": column_err["coalesce_adjacent"],
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_twin_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "cumsum",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/scan.cu",
        "replaces": "pysdm_tpu/ops/pallas/scan.py:105",
        "launches": warm_launches["cumsum"],
        "column_launches": column["cumsum"],
        "dejong_column_launches": dejong["cumsum"],
        "column_max_abs_err": column_err["cumsum"],
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "plain_ms": k4_twin_ms,
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        # the twin is the library call, torch.cumsum in the input's dtype
        "library_ms": k4_twin_ms,
    }, {
        "name": "coalesce_breakup_mirror",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_breakup.cu",
        "replaces": "pysdm_tpu/ops/pallas/breakup.py:340",
        "launches": k5_launches,
        "bulenok_launches": bulenok_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_twin_ms,
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
