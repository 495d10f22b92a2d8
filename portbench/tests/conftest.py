"""Tests of the benchmark (not of the program): run with
``python -m pytest portbench/tests`` from the root of the checkout.

Tests that need a CUDA card carry the ``cuda`` marker and skip inside the
``card`` fixture where torch sees none. The others run the harness on the
CPU at tiny sizes through ``run.main``, with a stand-in for the card
(``CpuPlatform``: the program's float32 attributes on CPU tensors, where
each kernel wrapper takes its plain twin, and a host clock)."""

import json
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "portbench"
# the tiny cells: (cell, configuration, changes to its sizes, traffic)
TINY = {
    "shima2009.tiny": ("shima2009", {}, {
        "n_sd": 1024, "episode_steps": 30, "read_steps": [10, 20, 30],
        "compare_steps": [10, 20],
    }),
    "arabas2015.tiny": ("arabas2015", {"grid": [8, 8], "spin_up_time": 300.0}, {
        "n_sd_per_gridbox": 16, "episode_steps": 6,
    }),
}
REAL = {"shima2009": "shima2009.sd16m", "arabas2015": "arabas2015.sd16k"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where torch sees none"
    )


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device")


class HostClock:
    """``StepClock`` on the host clock, for CPU runs"""

    def __init__(self, steps):
        self.t = None

    def start(self):
        self.t = [time.perf_counter()]

    def notify(self):
        if self.t is not None:
            self.t.append(time.perf_counter())

    def stop(self):
        t, self.t = self.t, None
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


def _cpu32():
    from pysdm_tpu_torch.backends import TorchBackend

    class CPU32(TorchBackend):
        def __init__(self, formulae=None):
            super().__init__(formulae, torch.float32, "cpu")

    return CPU32


class CpuPlatform:
    torch_device = "cpu"

    def __init__(self):
        self.backend_class = _cpu32()

    missing = staticmethod(lambda chips: None)
    describe = staticmethod(lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips, "power_limit_w": None})
    synchronize = staticmethod(lambda: None)
    clock = staticmethod(HostClock)
    memory_peak = staticmethod(lambda: 0)
    free = staticmethod(lambda: None)


def make_tiny_root(path):
    """a checkout holding the tiny cells: their own ``BENCHMARK.json`` and
    workload files, the real configuration modules and metric readers"""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    root = pathlib.Path(path)
    for sub in ("configs", "workloads"):
        (root / "portbench" / sub).mkdir(parents=True)
    (root / "portbench" / "metrics").symlink_to(BENCH / "metrics")
    configs, cells = [], []
    for cell, (config, sizes, traffic) in TINY.items():
        data = json.loads((BENCH / "configs" / f"{config}.json").read_text())
        data.update(sizes)
        (root / "portbench" / "configs" / f"{config}.json").write_text(json.dumps(data))
        (root / "portbench" / "configs" / f"{config}.py").symlink_to(
            BENCH / "configs" / f"{config}.py")
        real = json.loads((BENCH / "workloads" / f"{REAL[config]}.json").read_text())
        real.update(traffic)
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(real))
        configs.append({"name": config, "source": "x", "reduced": [], "why": "x",
                        "file": f"portbench/configs/{config}.json"})
        cells.append({"name": cell, "config": config, "traffic": "tiny",
                      "chips": 1, "why": "x"})
    rename = {REAL[c]: cell for cell, (c, _, _) in TINY.items()}
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [rename[w] for w in metric["workloads"]]
    spec["configs"], spec["workloads"] = configs, cells
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(root, cell, seed, capsys, *, trace=0, control=None, tamper=None):
    """one CPU run of a tiny cell; (exit code, the result line or None)"""
    from portbench import run

    rc = run.main(
        ["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
         "--trace", str(trace)],
        platform=CpuPlatform(), root=root, control=control, tamper=tamper,
    )
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
