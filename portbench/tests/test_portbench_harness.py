"""The harness's parts: discovery by name, the metric arithmetic, the trace
reading, episodes, and the import guard."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import catalog, episodes, guard, rooflines, stats, trace

from conftest import BENCH, ROOT


def test_every_name_in_benchmark_json_has_its_files():
    cat = catalog.Catalog(ROOT)
    spec = cat.spec
    for entry in spec["workloads"]:
        cell = cat.cell(entry["name"])
        assert cell.traffic_data and cell.config_data
        assert hasattr(cat.config_module(cell.config), "build")
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for metric in spec["per_layer"]:
        assert callable(cat.metric_reader(metric["name"]))
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}


def test_a_cell_and_a_metric_added_as_files_alone_are_found(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "workloads").mkdir()
    (tmp_path / "portbench" / "metrics").mkdir()
    (tmp_path / "portbench" / "configs" / "dummy.json").write_text('{"size": 3}')
    (tmp_path / "portbench" / "configs" / "dummy.py").write_text(
        "def build(config, traffic, seed, backend_class=None):\n"
        "    return config['size'] * traffic['n']\n")
    (tmp_path / "portbench" / "workloads" / "dummy.small.json").write_text('{"n": 2}')
    (tmp_path / "portbench" / "metrics" / "dummy_ms.v2.py").write_text(
        "def read(trace):\n    return trace * 10\n")
    spec["configs"].append({"name": "dummy", "source": "x", "reduced": [],
                            "why": "x", "file": "portbench/configs/dummy.json"})
    spec["workloads"].append({"name": "dummy.small", "config": "dummy",
                              "traffic": "small", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy_ms.v2", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "dummy",
                              "moves": "sd_steps_per_s", "workloads": ["dummy.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cat = catalog.Catalog(tmp_path)
    cell = cat.cell("dummy.small")
    assert cat.config_module("dummy").build(cell.config_data, cell.traffic_data, 1) == 6
    assert [m.name for m in cell.per_layer if m.workloads] == ["dummy_ms.v2"]
    assert cat.metric_reader("dummy_ms.v2")(4) == 40
    with pytest.raises(KeyError):
        cat.cell("no.such")


def test_p95_is_over_all_steps():
    steps = [1.0] * 95 + [10.0] * 5
    assert stats.p95(steps) == pytest.approx(np.percentile(steps, 95))
    assert stats.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert stats.median([3.0, 1.0, 2.0]) == 2.0


def test_busy_union():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert trace.busy_us([]) == 0
    assert trace.merged([(0, 10), (5, 15), (20, 30)]) == [[0, 15], [20, 30]]


def test_roofline_bytes_from_shapes():
    # the byte models beside chip_smoke.py's bound_ms calls
    assert rooflines.k1_bytes(1, extensive_rows=2, attribute_rows=1) == 36
    assert rooflines.k2_bytes(1, extensive_rows=3) == 57
    assert rooflines.k3_bytes(1) == 29
    tr = trace.Trace(
        ops=[trace.DeviceOp("void masses_new_kernel<0>(x)", "kernel", 0.0, 100.0, "Condensation"),
             trace.DeviceOp("void masses_new_kernel<0>(x)", "kernel", 200.0, 100.0, "Condensation"),
             trace.DeviceOp("other", "kernel", 400.0, 50.0, None)],
        window_s=1e-3, busy_s=2.5e-4, steps=2, host_reads=3,
        shapes={"n_sd": 2**20},
    )
    want = 100.0 * 2 * (29 * 2**20 / 3.35e12) / 200e-6
    assert rooflines.roofline_pct(tr, "masses_new_kernel", 29 * 2**20) == pytest.approx(want)
    assert rooflines.roofline_pct(tr, "coalesce_adjacent_kernel", 1) is None
    cat = catalog.Catalog(ROOT)
    assert cat.metric_reader("k3_roofline_pct")(tr) == pytest.approx(want)
    assert cat.metric_reader("condensation_ms_per_step")(tr) == pytest.approx(0.1)
    assert cat.metric_reader("advection_ms_per_step")(tr) is None
    assert cat.metric_reader("kernels_per_step")(tr) == 1.5
    assert cat.metric_reader("host_reads_per_step")(tr) == 1.5
    assert cat.metric_reader("device_idle_pct")(tr) == pytest.approx(75.0)


def _chrome(events):
    return [dict(e, ph="X", pid=1) for e in events]


def test_device_operations_belong_to_the_span_they_were_launched_in():
    events = _chrome([
        {"cat": "user_annotation", "name": "portbench/Condensation", "ts": 0, "dur": 50, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 2, "tid": 1,
         "args": {"correlation": 7}},
        {"cat": "user_annotation", "name": "portbench/Collision", "ts": 60, "dur": 50, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 70, "dur": 2, "tid": 1,
         "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 120, "dur": 80, "tid": 1},
        {"cat": "kernel", "name": "masses_new_kernel", "ts": 65, "dur": 20, "tid": 7,
         "args": {"correlation": 7}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 5, "tid": 7,
         "args": {"correlation": 8}},
        {"cat": "kernel", "name": "orphan", "ts": 300, "dur": 5, "tid": 7,
         "args": {"correlation": 99}},
    ])
    ops = trace.device_ops(events)
    assert [(o.name, o.span) for o in ops] == [
        ("masses_new_kernel", "Condensation"), ("Memcpy DtoH", "Collision"), ("orphan", None)]
    gaps = dict(trace.idle_gaps(events, ops))
    # 0-65 inside the Condensation span, 85-90 inside the Collision span,
    # 95-300 in the synchronise
    assert gaps == {
        "Condensation/portbench/Condensation": pytest.approx(65e-6),
        "Collision/portbench/Collision": pytest.approx(5e-6),
        "-/cudaStreamSynchronize": pytest.approx(205e-6),
    }
    assert trace.top_device_ops(ops)[0] == ["masses_new_kernel", pytest.approx(20e-6)]


def test_snapshot_and_restore_give_equal_episodes(tiny_root):
    from conftest import CpuPlatform

    cat = catalog.Catalog(tiny_root)
    for name in ("shima2009.tiny", "arabas2015.tiny"):
        cell = cat.cell(name)
        case = cat.config_module(cell.config).build(
            cell.config_data, cell.traffic_data, 5, backend_class=CpuPlatform().backend_class)
        p = case.particulator
        snap = episodes.snapshot(p)
        ends = []
        for _ in range(2):
            episodes.restore(p, snap)
            episodes.run_episode(p, case, 0)
            ends.append(episodes.clone_tree(p.sim_state))
        a, b = ends
        assert p.n_steps == snap.n_steps + case.episode_steps
        assert torch.equal(a["particles"].multiplicity, b["particles"].multiplicity)
        assert torch.equal(a["particles"].extensive, b["particles"].extensive)
        assert torch.equal(a["particles"].cell_id, b["particles"].cell_id)
        for key, value in a["env"].items():
            assert torch.equal(value, b["env"][key]), key
        for key, value in a["counters"].items():
            assert torch.equal(value, b["counters"][key]), key
        # the episode moved the state away from the snapshot
        assert not torch.equal(
            a["particles"].multiplicity, snap.sim_state["particles"].multiplicity)


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "pysdm_tpu", "pysdm_tpu.ops",
         "pysdm_tpu_torch", "pysdm_tpu_torch.ops", "jaxtyping", "numpy"]
    ) == ["flax", "jax", "jax.numpy", "jaxlib.xla", "pysdm_tpu", "pysdm_tpu.ops"]


def test_nothing_the_benchmark_loads_imports_jax_or_the_jax_package():
    """every module of the harness, the configurations, the readers and the
    references, imported in a fresh process, with the program they drive"""
    code = (
        "import sys, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run, control\n"
        "from portbench.harness import catalog, guard\n"
        "from portbench.reference import warm_rain, shima_box\n"
        "cat = catalog.Catalog(run.ROOT)\n"
        "for w in cat.spec['workloads']:\n"
        "    cat.config_module(w['config'])\n"
        "for m in cat.spec['per_layer']:\n"
        "    cat.metric_reader(m['name'])\n"
        "from pysdm_tpu_torch.models import arabas_et_al_2015, shima_et_al_2009\n"
        "print(guard.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.reference import warm_rain, shima_box\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'pysdm_tpu_torch', 'pysdm_tpu', 'jax'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"
    assert not list((BENCH / "reference").rglob("*.cu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("shima2009.sd16m", "arabas2015.sd16k"))
def test_each_cell_runs_correct_on_the_card(card, cell):
    """the cell through the benchmark's command, with a short window"""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert proc.stderr.strip().splitlines()[-1].startswith("check failed_steps")


def test_without_the_program_there_is_no_result(tmp_path):
    """a checkout that holds only BENCHMARK.json and the benchmark's files"""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "shima2009.sd16m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
