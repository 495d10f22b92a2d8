"""What the benchmark runs, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in files
of its own, found from its name alone:

- a configuration ``<config>``: its file of sizes (the entry's ``file``) and
  the module ``portbench/configs/<config>.py``, which builds the program's
  simulation from those sizes and holds the comparison with the plain
  reference;
- a cell ``<config>.<traffic>``: its traffic, a data file of parameters,
  ``portbench/workloads/<cell>.json``;
- a per-layer metric ``<metric>``: its reader ``portbench/metrics/<metric>.py``,
  a function ``read(trace)`` that returns a number or None; a metric named
  for its cells, ``<metric>.<cells>``, may share the reader of ``<metric>``.

An end-to-end metric named ``<quantity>.<cells>`` reports ``<quantity>``.

Adding a configuration, a cell or a metric adds files and entries; no file
here changes.
"""

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = "portbench"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = None
    moves: str = None
    bound: float = None
    workloads: tuple = None

    def reported_in(self, cell_name):
        return self.workloads is None or cell_name in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    config_data: dict
    traffic_data: dict
    end_to_end: tuple
    per_layer: tuple


class Catalog:
    """``BENCHMARK.json`` of the checkout at ``root``, and the files its
    names lead to"""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        with open(self.root / "BENCHMARK.json", encoding="utf-8") as f:
            self.spec = json.load(f)

    def _metrics(self, key):
        fields = {f.name for f in dataclasses.fields(Metric)}
        return tuple(
            Metric(**{
                k: (tuple(v) if k == "workloads" else v)
                for k, v in entry.items() if k in fields
            })
            for entry in self.spec[key]
        )

    def cell(self, name):
        """the cell ``name`` with its configuration's sizes, its traffic and
        the metrics it reports; KeyError for a name the file lacks"""
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = by_name[name]
        config = {c["name"]: c for c in self.spec["configs"]}[entry["config"]]
        return Cell(
            name=name,
            config=entry["config"],
            traffic=entry["traffic"],
            chips=int(entry["chips"]),
            config_data=self._load_json(config["file"]),
            traffic_data=self._load_json(f"{BENCH_DIR}/workloads/{name}.json"),
            end_to_end=tuple(
                m for m in self._metrics("end_to_end") if m.reported_in(name)
            ),
            per_layer=tuple(
                m for m in self._metrics("per_layer") if m.reported_in(name)
            ),
        )

    def _load_json(self, relative):
        with open(self.root / relative, encoding="utf-8") as f:
            return json.load(f)

    def config_module(self, config_name):
        """``portbench/configs/<config>.py``"""
        return load_module(
            self.root / BENCH_DIR / "configs" / f"{config_name}.py",
            "portbench_config_" + config_name.replace(".", "_"),
        )

    def metric_reader(self, metric_name):
        """``read`` of ``portbench/metrics/<metric>.py``, or, for a metric
        named for its cells (``collision_ms_per_step.box``) that has no file
        of its own, of the file of the quantity before the first dot"""
        metrics = self.root / BENCH_DIR / "metrics"
        name = metric_name
        if not (metrics / f"{name}.py").exists():
            name = metric_name.split(".")[0]
        module = load_module(
            metrics / f"{name}.py", "portbench_metric_" + name.replace(".", "_"),
        )
        return module.read


def load_module(path, module_name):
    """a module from its file; the file name may hold dots"""
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
