"""Smoke run of the PyTorch/CUDA port (``pysdm_tpu_torch``) on one NVIDIA GPU.

Run from the root of the checkout: ``python3 chip_smoke.py``. Phases:

0. environment: the card's name and power limit (nvidia-smi), torch, CUDA,
   nvcc, whether triton imports;
1. build of every CUDA kernel from ``pysdm_tpu_torch/csrc``, one nvcc per
   source, all started together;
2. K1 (mirror coalescence) against its plain PyTorch twin on the card, on
   random states with dead slots, ties and multiplicities up to 2^40, at 2^16
   and 2^20 slots: multiplicities exactly, extensive rows to rtol 1e-6
   (float32) or 1e-12 (float64), rate sums to rtol 1e-5; then the device time
   of kernel and twin at 2^20 (CUDA events);
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
   2 rtol_x |x_old| + 2e-5 (see ``compare_k3``); then the device time of
   kernel and twin at both sizes;
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
   0.0225 and activates the drops within the 50 steps.

Every box phase checks multiplicities >= 0, water mass conserved to 1e-6 and
coalescence having happened. Any failure raises, and the script exits
non-zero; without a CUDA device, or without the package beside it, it exits
non-zero before printing any result. The last two lines are one JSON object
of the kernels and one of the device.
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


def _kernel_vs_twin(torch, kern, device, gpu):
    """phase 2; returns (max_abs_err, kernel_ms, twin_ms) at N_MAIN"""
    import numpy as np

    max_abs_err = 0.0
    for n, ext_dtype in ((2**16, np.float32), (2**16, np.float64),
                         (N_MAIN, np.float32)):
        K = (n // 3) * 2
        mult, ext, volume = _random_state(torch, n, K, ext_dtype, n, device)
        scale = torch.tensor([2e-3], dtype=torch.float32, device=device)
        args = (mult, ext, volume, kern.GOLOVIN, (1.5e3, 0.0), scale, K,
                3141592653)
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
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_mirror(*args), 200)
    twin_ms = _time_ms(torch, lambda: kern.coalesce_mirror_reference(*args), 10)
    print(f"phase 2: n={N_MAIN} kernel {kernel_ms!r} ms, plain twin"
          f" {twin_ms!r} ms per substep [{gpu}]")
    return max_abs_err, kernel_ms, twin_ms


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


def _k3_vs_twin(torch, k3, device, gpu):
    """phase 5; returns (max_abs_err, {n: (kernel_ms, twin_ms)})"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.ops.condensation import DropSolveSettings

    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*K3_SETTINGS)
    max_abs_err, times = 0.0, {}
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
        args = [torch.from_numpy(rows[k]).to(device) for k in K3_ARGS]
        times[n] = (
            _time_ms(torch, lambda: k3.masses_new(formulae, settings, *args), 50),
            _time_ms(
                torch,
                lambda: k3.masses_new_reference(formulae, settings, *args), 3,
            ),
        )
        print(f"phase 5: K3 n={n}: success equal, mass max abs diff"
              f" {abs_err!r} kg, max rel diff {rel_err!r}; kernel"
              f" {times[n][0]!r} ms, plain twin {times[n][1]!r} ms [{gpu}]")
    return max_abs_err, times


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.ops.cuda import _build
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3

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
    for name in ("collision_mirror", "condensation"):
        _build.library_path(name)[1].unlink(missing_ok=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for future in [pool.submit(m.library) for m in (kern, k3)]:
            future.result()
    print(f"phase 1: built collision_mirror and condensation in"
          f" {time.perf_counter() - t0!r} s")

    device = torch.device("cuda")
    max_abs_err, kernel_ms, twin_ms = _kernel_vs_twin(torch, kern, device, gpu)
    launches = _main_path(torch, kern, gpu)
    _adaptive(kern, gpu)
    k3_err, k3_times = _k3_vs_twin(torch, k3, device, gpu)
    k3_launches, _ = _parcel_main_path(k3, gpu)
    _parcel_gpu_vs_cpu(k3)

    print(json.dumps({"kernels": [{
        "name": "coalesce_mirror",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_mirror.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:582",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }, {
        "name": "masses_new",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/condensation.cu",
        "replaces": "pysdm_tpu/ops/pallas/condensation.py:299",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_times[N_PARCEL][0],
        "plain_ms": k3_times[N_PARCEL][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
