"""The port's spans and work counts (``pysdm_tpu_torch/utils/profiling.py``)
and the benchmark's readers of them (``portbench/metrics/``).

On the CPU: a span enters no ``record_function`` while no profiler
records; every CUDA wrapper registers its counters; a sample picks the
first of every n recorded calls; a profiled step of a small 2D warm rain names each dynamic and
its parts; the recorded totals are the deltas of the program's counters
over a recorded ``run`` and stay empty over an unrecorded one; each reader
gives its ratio on fabricated totals and nothing where the totals cover
other steps than the trace; K4's byte count.

Marked ``cuda`` (skipped where torch sees no CUDA device; on a GPU host
``python -m pytest tests/unit/test_torch_tracing.py --noconftest``): K3's
masses and success flags are the same bits with its counts on and off, it
counts the drops it swept, its active drops are the host's count of them, its minfun evaluations cover
every solved drop; K4's wrapper counts its bytes.
"""

import contextlib
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pysdm_tpu_torch  # noqa: E402
from pysdm_tpu_torch.backends import CPU  # noqa: E402
from pysdm_tpu_torch.models import arabas_et_al_2015 as model  # noqa: E402
from pysdm_tpu_torch.ops.cuda import scan  # noqa: E402
from pysdm_tpu_torch.utils import profiling  # noqa: E402

PARTS = {
    "Condensation": (
        "prepare", "adapt_substeps", "substep", "solve", "coupling", "read",
        "commit",
    ),
    "EulerianAdvection": ("upwind", "antidiffusive", "fct"),
    "Displacement": ("prepare", "read", "substep", "commit"),
    "Collision": (
        "prepare", "substep", "draws", "sort", "pairs", "gamma", "cell_min",
        "coalescence", "read", "commit",
    ),
}


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(name="warm_rain", scope="module")
def _warm_rain():
    """a 4 x 4 warm rain after a two-step spin-up, everything on"""
    settings = model.Settings(
        pysdm_tpu_torch.Formulae(seed=11), grid=(4, 4), n_sd_per_gridbox=8,
        spin_up_time=10.0,
    )
    p, spin_up = model.make_simulation(settings, backend_class=CPU)
    p.run(settings.n_spin_up)
    spin_up.finish()
    return p


def test_a_span_enters_no_record_function_while_nothing_records(monkeypatch):
    """the record-function scope is entered only while a profiler records"""
    entered = []

    def scope(name, *args):
        entered.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "_scope", scope)
    assert not profiling.recording()
    with profiling.span("A.part"):
        pass
    assert profiling.span("A.part", 3) is profiling.span("B.part")
    assert entered == []
    with recorded():
        assert profiling.recording()
        with profiling.span("A.part", 3):
            pass
    assert entered == [("A.part", ((), {"step": 3}))]


def test_every_cuda_wrapper_registers_its_counters():
    """the host counters ``Particulator.counts`` gives of each CUDA
    kernel's wrapper, registered where the wrapper is defined"""
    from pysdm_tpu_torch.ops.cuda import (  # noqa: F401
        breakup, chemistry, collision, condensation,
    )

    counts = profiling.host_counts()
    for name in (
        "coalesce_mirror", "coalesce_mirror_rows",
        "coalesce_mirror_parameterized", "coalesce_adjacent", "masses_new",
        "cumsum", "coalesce_breakup_mirror", "equilibrate_H",
    ):
        assert isinstance(counts[f"{name}.launches"], int), name
    assert {"cumsum.rows", "cumsum.bytes"} <= set(counts)


def test_the_dynamics_spans_carry_the_step_number(warm_rain):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        warm_rain.run(1)
    steps = {
        e.name: e.kwinputs.get("step") for e in prof.events()
        if e.name == "Condensation"
    }
    assert steps == {"Condensation": warm_rain.n_steps - 1}


def test_a_profiled_step_names_each_dynamic_and_its_parts(warm_rain):
    with recorded() as prof:
        warm_rain.run(1)
    names = {e.key for e in prof.key_averages()}
    assert {name for name, _ in warm_rain._named_step_fns} <= names
    for dynamic, parts in PARTS.items():
        assert {f"{dynamic}.{part}" for part in parts} <= names, dynamic


def test_the_benchmarks_spans_nest_inside_the_programs(warm_rain):
    """``portbench/harness/trace.py`` wraps the step functions in spans of
    its own and composes the step again: both are in the trace"""
    from portbench.harness import trace

    fns = warm_rain._named_step_fns
    try:
        trace.install_spans(warm_rain)
        with recorded() as prof:
            warm_rain.run(1)
    finally:
        warm_rain._named_step_fns = fns
        warm_rain._compose()
    names = {e.key for e in prof.key_averages()}
    for name, _ in fns:
        assert {name, trace.SPAN_PREFIX + name} <= names


def test_recorded_totals_are_the_counters_deltas(warm_rain):
    profiling.reset()
    before = warm_rain.counts()
    with recorded():
        warm_rain.run(2)
    after = warm_rain.counts()
    want = {k: v - before.get(k, 0) for k, v in after.items()}
    assert want["Collision.substeps_run"] > 0
    assert want["Condensation.substep_solves"] > 0
    assert want["Displacement.substeps_run"] >= 2
    assert profiling.totals() == {**want, "steps": 2}


def test_an_unrecorded_run_records_nothing(warm_rain):
    profiling.reset()
    warm_rain.run(1)
    assert profiling.totals() == {}


def test_a_sample_is_the_first_of_every_n_recorded_calls():
    profiling.reset()
    assert not any(profiling.sample("k", 3) for _ in range(4))
    with recorded():
        picked = [profiling.sample("k", 3) for _ in range(7)]
        assert profiling.sample("other", 3)
    assert picked == [True, False, False, True, False, False, True]
    profiling.reset()
    with recorded():
        assert profiling.sample("k", 3)


def test_the_set_up_timer_adds_its_seconds_unprofiled():
    profiling.reset()
    with profiling.timed("setup.x"):
        pass
    with profiling.timed("setup.x"):
        pass
    assert profiling.totals()["setup.x"] > 0

    from pysdm_tpu_torch.initialisation import equilibrate_wet_radii

    class Env:
        """one cell at 290 K and 90% RH"""

        particulator = types.SimpleNamespace(formulae=pysdm_tpu_torch.Formulae())

        def __getitem__(self, key):
            return {"T": np.array([290.0]), "RH": np.array([0.9])}[key]

    r_dry = np.full(4, 5e-8)
    equilibrate_wet_radii(
        r_dry=r_dry, environment=Env(),
        kappa_times_dry_volume=0.5 * 4 / 3 * np.pi * r_dry**3,
    )
    assert profiling.totals()["setup.equilibrate"] > 0
    profiling.reset()


class FakeTrace:
    """what a reader takes of the harness's ``Trace``: the steps, and the
    kernels named like a pattern"""

    def __init__(self, steps, ops=()):
        self.steps = steps
        self.ops = list(ops)

    def kernels(self, pattern, span=None):
        return [op for op in self.ops if pattern in op.name]


K4_OP = types.SimpleNamespace(
    name="void (anonymous namespace)::scan_kernel<float>(float const*)",
    category="kernel", dur_us=10.0,
)
FABRICATED = {
    "steps": 4,
    "Collision.substeps_run": 10,
    "Condensation.substep_solves": 30,
    "Displacement.substeps_run": 8,
    "masses_new.swept": 1000,
    "masses_new.active": 250,
    "masses_new.need_solve": 200,
    "masses_new.evaluations": 900,
    "cumsum.bytes": 16_750_000,
    "setup.equilibrate": 12.5,
}
# each reader's value on ``FABRICATED`` (K4: 16.75 MB over 3.35 TB/s in
# 10 us of its kernel)
READINGS = {
    "collision_substeps_per_step": 2.5,
    "condensation_solves_per_step": 7.5,
    "k3_active_drops_pct": 25.0,
    "k3_evaluations_per_drop": 4.5,
    "displacement_substeps_per_step": 2.0,
    "k4_roofline_pct": 50.0,
    "setup_equilibrate_s": 12.5,
}


def reader(name):
    from portbench.harness.catalog import load_module

    return load_module(
        ROOT / "portbench" / "metrics" / f"{name}.py", f"test_reader_{name}"
    ).read


@pytest.mark.parametrize("name", sorted(READINGS))
def test_each_reader_gives_its_ratio_on_fabricated_totals(monkeypatch, name):
    monkeypatch.setattr(profiling, "totals", lambda: dict(FABRICATED))
    value = reader(name)(FakeTrace(4, [K4_OP]))
    assert value == pytest.approx(READINGS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_each_reader_gives_nothing_where_the_steps_disagree(monkeypatch, name):
    monkeypatch.setattr(profiling, "totals", lambda: dict(FABRICATED))
    assert reader(name)(FakeTrace(5, [K4_OP])) is None


@pytest.mark.parametrize("name", sorted(READINGS))
def test_each_reader_gives_nothing_on_a_program_without_totals(
    monkeypatch, name
):
    """the parent of this change has no ``totals``: no value, no raise"""
    monkeypatch.delattr(profiling, "totals")
    assert reader(name)(FakeTrace(4, [K4_OP])) is None


@pytest.mark.parametrize("shape", ((7,), (3, 7), (1, 2560)))
@pytest.mark.parametrize("dtype", (torch.float32, torch.int32, torch.int64))
def test_k4_bytes_are_each_element_read_and_written_once(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    rows = shape[0] if len(shape) == 2 else 1
    assert scan.k4_bytes(x) == 2 * x.element_size() * rows * shape[-1]


# -- on the card ------------------------------------------------------------


@pytest.fixture(name="device")
def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k3_counts_change_no_bit_and_count_what_k3_did(device):
    import chip_smoke
    from pysdm_tpu_torch.ops.condensation import DropSolveSettings
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    formulae = pysdm_tpu_torch.Formulae(seed=44)
    settings = DropSolveSettings(*chip_smoke.K3_SETTINGS)
    rows = chip_smoke.settle_haze(formulae, chip_smoke.k3_rows(2**14 + 3), device)
    args = [torch.from_numpy(rows[k]).to(device) for k in chip_smoke.K3_ARGS]
    off = k3.masses_new(formulae, settings, *args)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = k3.masses_new(formulae, settings, *args)
        torch.cuda.synchronize()
    counts = profiling.totals()
    profiling.reset()
    for got, want in zip(on, off):
        assert torch.equal(got, want)
    active = (
        rows["active"][rows["cell_id"]] & (rows["multiplicity"] > 0)
        & (rows["water_mass"] > 0)
    )
    assert counts["masses_new.swept"] == len(active)
    assert counts["masses_new.active"] == int(active.sum())
    assert 0 < counts["masses_new.need_solve"] <= counts["masses_new.active"]
    assert counts["masses_new.evaluations"] >= 2 * counts["masses_new.need_solve"]
    twin = chip_smoke.k3_evaluations(k3, formulae, settings, args)
    assert counts["masses_new.evaluations"] == pytest.approx(twin, rel=0.1)


@pytest.mark.cuda
def test_k4_wrapper_counts_its_bytes(device):
    x = torch.ones((3, 1001), dtype=torch.float32, device=device)
    before = scan.cumsum.bytes
    scan.cumsum(x)
    assert scan.cumsum.bytes - before == 2 * 4 * 3 * 1001
