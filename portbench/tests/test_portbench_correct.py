"""What decides ``correct``, at tiny sizes on the CPU: sound runs come out
correct, the control (the reference keeping its state in bfloat16) does
not, and neither does a run whose timed path is broken underneath, once
for each fault the cell can have (one card: no exchange between chips)."""

import json

import pytest
import torch

from conftest import run_tiny
from portbench.harness.catalog import Catalog

CELLS = ("shima2009.tiny", "arabas2015.tiny")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (3, 2**31 + 11))
def test_sound_runs_are_correct(tiny_root, capsys, cell, seed):
    rc, line = run_tiny(tiny_root, cell, seed, capsys)
    assert rc == 0
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    reported = {m.name for m in Catalog(tiny_root).cell(cell).end_to_end}
    assert set(line["metrics"]) == reported and "setup_s" in reported and len(reported) > 1
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_is_judged_alike(tiny_root, capsys, cell):
    rc, line = run_tiny(tiny_root, cell, 4, capsys, trace=1)
    assert rc == 0 and line["correct"], line["checks"]
    assert "breakdown" in line and "busy_s" in line["device"]
    reads = [m for name, m in line["metrics"].items() if name.startswith("host_reads_per_step")]
    assert len(reads) == 1 and reads[0]["value"] >= 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, capsys, cell):
    rc, line = run_tiny(tiny_root, cell, 6, capsys, control=torch.bfloat16)
    assert rc == 0 and line["correct"]
    failing = [n for n, c in line["control_checks"].items() if c["value"] > c["limit"]]
    assert failing, line["control_checks"]


def _wrap_dynamic(case, name, after):
    """the dynamic ``name``'s step followed by ``after(before, out)``"""
    p = case.particulator
    fns = dict(p._named_step_fns)
    inner = fns[name]
    p._named_step_fns = tuple(
        (n, (lambda sim, inner=inner: after(sim, inner(sim))) if n == name else f)
        for n, f in p._named_step_fns
    )
    p._compose()


def state_unchanged(case):
    case.particulator._named_step_fns = tuple(
        (n, lambda sim: sim) for n, _ in case.particulator._named_step_fns)
    case.particulator._compose()


def half_left_out(case):
    """the first half of the drops keep what the dynamic that works on
    them (collision in the box, condensation in the warm rain) gave them,
    the rest what they had"""
    names = dict(case.particulator._named_step_fns)
    name = "Condensation" if "Condensation" in names else "Collision"

    def after(before, out):
        half = case.n_sd // 2
        a, b = before["particles"], out["particles"]
        mult, ext = b.multiplicity.clone(), b.extensive.clone()
        mult[half:], ext[:, half:] = a.multiplicity[half:], a.extensive[:, half:]
        return {**out, "particles": b.replace(multiplicity=mult, extensive=ext)}

    _wrap_dynamic(case, name, after)


def answer_altered(case):
    """one answer changed where it is produced: a bin of the box's dv/dlnr
    read, one cell's th after the warm rain's condensation"""
    if not hasattr(case, "n_cell"):
        product = case.particulator.products["dv/dlnr"]
        get = product.get

        def altered():
            out = get().copy()
            out[0, out[0].argmax()] *= 1.01
            return out

        product.get = altered
        return

    def after(before, out):
        env = dict(out["env"])
        env["pred_thd"] = env["pred_thd"].clone()
        env["pred_thd"][0] += 1.0
        return {**out, "env": env}

    _wrap_dynamic(case, "Condensation", after)


def advection_left_out(case):
    """the warm rain's MPDATA step returns its input: the advected fields
    the next step starts from are the predicted ones"""

    def after(before, out):
        env = dict(out["env"])
        env["mpdata_thd"], env["mpdata_qv"] = env["pred_thd"], env["pred_qv"]
        return {**out, "env": env}

    _wrap_dynamic(case, "EulerianAdvection", after)


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for fault in (state_unchanged, half_left_out, answer_altered)
    for cell in CELLS
] + [("arabas2015.tiny", advection_left_out)])
def test_a_broken_timed_path_is_not_correct(tiny_root, capsys, cell, fault):
    rc, line = run_tiny(tiny_root, cell, 9, capsys, tamper=fault)
    assert rc == 0
    assert not line["correct"], line["checks"]


def test_the_scan_reads_every_step_of_the_episode(tiny_root, capsys):
    """``control.py --scan``: the program's and the control's readings at
    each step the reference can follow"""
    from conftest import CpuPlatform
    from portbench import control

    assert control.scan("arabas2015.tiny", 5, root=tiny_root,
                        backend_class=CpuPlatform().backend_class, device="cpu") == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [line["k"] for line in lines] == list(range(6))
    limits = json.loads((tiny_root / "portbench/workloads/arabas2015.tiny.json").read_text())["limits"]
    for line in lines:
        assert all(line["checks"][n] <= limits[n] for n in limits), line
        assert any(line["control_checks"][n] > limits[n] for n in limits), line
